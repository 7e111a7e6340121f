"""Checkpoint / resume (port of ldm_tpu/training/checkpoint.py).

A checkpoint is the FULL training state, ``torch.save`` of a dict: the model,
the EMA model, the optimizer (Adam's moments and step counts), the step and
the best validation loss so far.  Files are written atomically (a temporary
file in the same directory, then ``os.replace``), so a crash mid-write
leaves the previous checkpoint whole.  Weights-only files (a UNet
state_dict) load with ``python -m ldm_tpu_torch.generate --weights``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Optional

import torch


def atomic_save(obj: Any, path: str) -> str:
    """``torch.save`` to a temporary file beside ``path``, then rename."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path), suffix=".tmp", dir=d)
    os.close(fd)
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def save_state(path: str, state_dict: dict, best_val_loss: float) -> str:
    """A TrainState's ``state_dict()`` plus the best validation loss."""
    return atomic_save(dict(state_dict, best_val_loss=float(best_val_loss)), path)


def load_state(path: str, map_location=None) -> dict:
    return torch.load(path, map_location=map_location, weights_only=True)


def latest_checkpoint(dirpath: str, name: str = "state") -> Optional[str]:
    p = os.path.join(dirpath, f"{name}.pt")
    return p if os.path.exists(p) else None
