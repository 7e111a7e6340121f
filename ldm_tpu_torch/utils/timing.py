"""Wall-clock timing decorator (the twin of ``ldm_tpu/utils/timing.py``)."""

from __future__ import annotations

import functools
import time


def timeit(fn):
    """``fn``, printing ``<name> took <seconds>s`` after each call."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        print(f"{fn.__name__} took {time.perf_counter() - t0:.2f}s", flush=True)
        return out

    return wrapper
