"""Seeding and the config's runtime flags (port of ldm_tpu/utils/seed.py).

Randomness in the port is explicit: every draw comes from a
``torch.Generator`` seeded from the config's seed (and a step or a salt), and
numpy's from ``np.random.default_rng(seed)`` where the JAX package uses it.
:func:`set_seed` seeds the process's global streams as well, for parity.

The JAX package's flags map so:

* ``debug_nans`` (``jax_debug_nans``, which stops at the first op that makes
  a NaN) becomes a check of every epoch's loss, which the trainers read once
  an epoch anyway: :func:`check_finite` raises on a NaN or an infinity.  A
  check per op would need a host sync per op, which a replayed step cannot
  make.
* the persistent compilation cache has no counterpart: the port's kernels
  are built once per checkout (``ops/build.py``), and PyTorch compiles
  nothing else.
* :func:`apply_runtime_flags` also makes cuDNN pick deterministic
  algorithms, so that one seed gives the same weights bit for bit on the
  card from one run to the next, as it does in the JAX package.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch


def set_seed(seed: int = 42) -> int:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def apply_runtime_flags(config) -> None:
    """Deterministic cuDNN algorithms (no autotuning, none that sums with
    atomics); the entry points call this once."""
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True


def check_finite(name: str, value: float, config) -> float:
    """``value`` (an epoch's loss) back, or FloatingPointError where it is
    not finite and the config asks for ``debug_nans``."""
    if getattr(config, "debug_nans", False) and not math.isfinite(value):
        raise FloatingPointError(f"{name} is {value} (debug_nans)")
    return value
