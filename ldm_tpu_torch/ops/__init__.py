"""Ops: hand-written Hopper kernels beside their plain PyTorch versions."""
