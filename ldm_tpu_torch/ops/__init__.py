"""Ops: hand-written Hopper kernels beside their plain PyTorch versions, and
the classification (F1) and sample-quality (FID) metrics."""
