"""Utilities (weight bridge from the JAX package)."""
