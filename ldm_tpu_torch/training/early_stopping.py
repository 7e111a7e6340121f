"""Early stopping on validation loss: a twin of ldm_tpu/training/early_stopping.py.

The JAX module is numpy-only, but its package's ``__init__`` imports JAX, so
the port keeps this twin, which makes the same decisions:

* score = -val_loss; by default (``min_delta_rel`` 0, the reference's
  semantics) a loss counts as an improvement unless ``-val_loss < best +
  delta``, so exact ties improve;
* with ``min_delta_rel`` > 0 an improvement must beat the best loss by
  strictly more than ``delta + min_delta_rel * |best|``;
* a NaN or infinite loss never improves and spends patience;
* ``save_fn(state)`` runs on every improvement.
"""

from __future__ import annotations

import math
from typing import Callable, Optional


class EarlyStopping:
    def __init__(
        self,
        patience: int = 7,
        verbose: bool = False,
        delta: float = 0.0,
        save_fn: Optional[Callable[[object], None]] = None,
        min_delta_rel: float = 0.0,
    ):
        self.patience = patience
        self.verbose = verbose
        self.delta = delta
        self.min_delta_rel = min_delta_rel
        self.save_fn = save_fn
        self.counter = 0
        self.best_score: Optional[float] = None
        self.early_stop = False
        self.val_loss_min = math.inf

    def _improved(self, val_loss: float) -> bool:
        if self.min_delta_rel > 0.0:
            required = self.delta + self.min_delta_rel * abs(self.val_loss_min)
            return (self.val_loss_min - val_loss) > required  # strict
        return not (-val_loss < self.best_score + self.delta)  # ties improve

    def __call__(self, val_loss: float, state) -> None:
        val_loss = float(val_loss)
        if not math.isfinite(val_loss):
            self.counter += 1
            if self.counter >= self.patience:
                self.early_stop = True
            return
        if self.best_score is None:
            self.best_score = -val_loss
            self._save(val_loss, state)
        elif not self._improved(val_loss):
            self.counter += 1
            if self.verbose:
                print(f"EarlyStopping counter: {self.counter} out of {self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
        else:
            self.best_score = -val_loss
            self._save(val_loss, state)
            self.counter = 0

    def restore(self, best_val_loss: float) -> None:
        """Resume with the best loss of an earlier run (from a checkpoint)."""
        if math.isfinite(best_val_loss):
            self.val_loss_min = float(best_val_loss)
            self.best_score = -self.val_loss_min

    def _save(self, val_loss: float, state) -> None:
        if self.verbose:
            print(
                f"Validation loss decreased ({self.val_loss_min:.6f} --> "
                f"{val_loss:.6f}). Saving model ..."
            )
        self.val_loss_min = val_loss
        if self.save_fn is not None:
            self.save_fn(state)
