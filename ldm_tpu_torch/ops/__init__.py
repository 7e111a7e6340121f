"""Ops: hand-written Hopper kernels beside their plain PyTorch versions, and
the classification (F1) and sample-quality (FID) metrics."""

from ldm_tpu_torch.ops.build import launch_counts  # noqa: F401  (every kernel's launches)
