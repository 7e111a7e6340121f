"""Classification metrics on the device (port of ldm_tpu/ops/metrics.py).

A confusion matrix accumulates on the device, one per step; F1 is derived
once an epoch from the summed matrix, so a training step makes no host
sync.  Micro-F1 over an epoch equals the accuracy for single-label
multiclass data.  Both functions are capturable (no host sync, no shape that
depends on the data), so they run inside the classifier's replayed step.
"""

from __future__ import annotations

from typing import Dict

import torch


def confusion_matrix(preds: torch.Tensor, labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(N,) int preds / labels -> (C, C) int64 counts, rows = true class."""
    idx = labels.to(torch.int64) * num_classes + preds.to(torch.int64)
    flat = torch.zeros(num_classes * num_classes, dtype=torch.int64, device=preds.device)
    flat.index_add_(0, idx, torch.ones_like(idx))
    return flat.reshape(num_classes, num_classes)


def f1_from_confusion(cm: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Micro / macro F1 and accuracy (fp32 scalars) and the per-class F1,
    from a confusion matrix, in the JAX function's arithmetic."""
    cm = cm.to(torch.float32)
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)  # true counts
    predicted = cm.sum(dim=0)
    total = cm.sum()
    precision = tp / predicted.clamp_min(1.0)
    recall = tp / support.clamp_min(1.0)
    f1 = 2 * precision * recall / (precision + recall).clamp_min(1e-12)
    micro = tp.sum() / total.clamp_min(1.0)  # == accuracy for multiclass
    return {"f1_micro": micro, "f1_macro": f1.mean(), "accuracy": micro, "f1_per_class": f1}
