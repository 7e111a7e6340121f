"""Tracing hook of the port (the twin of ``ldm_tpu/utils/profiling.py::trace``,
over ``torch.profiler`` where the JAX package uses ``jax.profiler``).

:func:`trace` records the host's operators always and the card's kernels,
copies and graph launches when a card is present, and writes one Chrome
trace (``chrome://tracing``, Perfetto, TensorBoard's profile plugin) under
the directory it is given.  ``Throughput``, the JAX module's other half,
is in ``utils/logging.py``.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the block and write its Chrome trace under ``logdir`` as
    ``trace_<pid>_<ns>.json`` (no-op if None or empty)."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
