"""Utilities: the weight bridges, metrics logging, images, timing and
tracing."""

from ldm_tpu_torch.utils.timing import timeit  # noqa: F401
