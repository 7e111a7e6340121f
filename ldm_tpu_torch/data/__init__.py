"""Data of the port: the JAX package's numpy readers and loaders, with a
JAX-free resize."""
