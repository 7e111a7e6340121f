"""Utilities: the weight bridge from the JAX package, metrics logging."""
