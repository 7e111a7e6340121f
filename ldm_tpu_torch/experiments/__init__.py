"""The experiment protocols of the port."""
