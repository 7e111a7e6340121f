"""Training of the port: state, trainer, checkpoints, early stopping."""
