"""Metrics logging and throughput counters: twins of ldm_tpu/utils/logging.py
(``MetricsLogger``) and ldm_tpu/utils/profiling.py (``Throughput``), whose
modules import JAX.

Records and keys are the JAX package's: one JSON object a line in
``<dirpath>/metrics.jsonl`` (``{"step": .., "ts": .., "diffusion_model
train_loss": ..}``), stdout, and the running min/max of declared keys in
``summary.json``.  Sample grids are written as ``.npy`` (uint8 HWC), and as
``.png`` too when PIL is installed.  With ``use_wandb`` the records, grids,
histograms and summary rules are mirrored to wandb as the JAX logger
mirrors them: ``import wandb`` happens there and then (a no-op where the
module is absent), and a run it starts is offline unless ``WANDB_MODE``
says otherwise.  Under a process group the sinks live on the primary
process alone (as the JAX logger's live on process 0): the others write and
print nothing.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, Optional

import numpy as np
import torch


def _scalar(v: Any) -> Any:
    return float(v) if hasattr(v, "item") else v


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm), one
    reduction on the tensors' device."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class MetricsLogger:
    def __init__(self, dirpath: Optional[str] = None, project: str = "",
                 use_wandb: bool = False, quiet: bool = False):
        from ldm_tpu_torch.parallel.distributed import is_primary

        # the sinks' owner: the default process group's rank 0 (every
        # process without a group)
        self.primary = is_primary()
        self.quiet = quiet
        self._path = self._summary_path = None
        if dirpath and self.primary:
            os.makedirs(dirpath, exist_ok=True)
            self._path = os.path.join(dirpath, "metrics.jsonl")
            self._summary_path = os.path.join(dirpath, "summary.json")
        self._summary_rules: Dict[str, str] = {}
        self._summaries: Dict[str, float] = {}
        self._wandb = None
        if use_wandb and self.primary:
            try:
                import wandb
            except ImportError:
                return
            self._wandb = wandb
            if wandb.run is None:
                wandb.init(project=project or "ldm_tpu",
                           mode=os.environ.get("WANDB_MODE", "offline"))

    def define_summaries(self, rules: Dict[str, str]) -> None:
        """Track the running min or max of each key in ``summary.json`` (and
        ``wandb.define_metric(key, summary=mode)`` when live)."""
        for key, mode in rules.items():
            if mode not in ("min", "max"):
                raise ValueError(f"summary mode must be min|max, got {mode!r}")
            self._summary_rules[key] = mode
        if self._wandb is not None and hasattr(self._wandb, "define_metric"):
            for key, mode in rules.items():
                self._wandb.define_metric(key, summary=mode)

    def _update_summaries(self, metrics: Dict[str, Any]) -> None:
        changed = False
        for key, mode in self._summary_rules.items():
            v = metrics.get(key)
            if not isinstance(v, (int, float)):
                continue
            name = f"{key}.{mode}"
            cur = self._summaries.get(name)
            new = v if cur is None else (min(cur, v) if mode == "min" else max(cur, v))
            if new != cur:
                self._summaries[name] = new
                changed = True
        if changed and self._summary_path:
            with open(self._summary_path, "w") as f:
                json.dump(self._summaries, f, indent=2, sort_keys=True)

    def log(self, metrics: Dict[str, Any], step: int) -> None:
        if not self.primary:
            return
        metrics = {k: _scalar(v) for k, v in metrics.items()}
        rec = {"step": step, "ts": time.time(), **metrics}
        if not self.quiet:
            print(" ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                           for k, v in rec.items() if k != "ts"), flush=True)
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        self._update_summaries(metrics)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, images: np.ndarray, step: int, mode: str,
                   dirpath: Optional[str] = None) -> Optional[str]:
        """Save a uint8 NHWC batch as one grid image, ``<mode>_step<step>.npy``
        (and ``.png`` when PIL is present) under ``dirpath``, and log it to
        wandb when live; returns the ``.npy`` path (None without
        ``dirpath``)."""
        from ldm_tpu_torch.utils.images import image_grid

        if not self.primary or not (dirpath or self._wandb is not None):
            return None
        grid = image_grid(images)
        if self._wandb is not None:
            self._wandb.log({f"{mode}/images": [self._wandb.Image(grid)]}, step=step)
        if not dirpath:
            return None
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"{mode}_step{step}.npy")
        np.save(path, grid)
        try:
            from PIL import Image
        except ImportError:
            return path
        Image.fromarray(grid[..., 0] if grid.shape[-1] == 1 else grid).save(path[:-4] + ".png")
        return path

    def log_norms(self, tag: str, tensors: Iterable[torch.Tensor], step: int) -> None:
        """The global L2 norm of a set of tensors (the stand-in for the
        reference's ``wandb.watch``)."""
        norm = global_norm(t.detach().float() for t in tensors)
        self.log({f"{tag}_global_norm": float(norm)}, step=step)

    def log_histograms(self, tag: str, named: Iterable[tuple[str, torch.Tensor]],
                       step: int) -> None:
        """Per-tensor min, max, mean and std into the JSONL (and a
        ``wandb.Histogram`` a tensor when live)."""
        rec, wandb_rec = {}, {}
        live = self._wandb is not None and hasattr(self._wandb, "Histogram")
        for name, t in named:
            a = t.detach().float()
            rec[f"{tag}/{name}"] = [float(a.min()), float(a.max()), float(a.mean()),
                                    float(a.std(correction=0))]
            if live:
                wandb_rec[f"{tag}/{name}"] = self._wandb.Histogram(a.cpu().numpy())
        if self._path:
            with open(self._path, "a") as f:
                f.write(json.dumps({"step": step, "ts": time.time(),
                                    f"{tag}_histograms(min,max,mean,std)": rec}) + "\n")
        if wandb_rec:
            self._wandb.log(wandb_rec, step=step)

    def close(self) -> None:
        """Nothing to close: every write opens and closes its file (the JAX
        logger's ``close``, kept for its callers)."""


class Throughput:
    """Steps/s and samples/s over a window (e.g. one epoch) on one device.
    Call ``update`` with host-side batch sizes; read ``rates`` at the end of
    a window that ends in a device sync."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.perf_counter()
        self.steps = 0
        self.samples = 0

    def update(self, batch_size: int) -> None:
        self.steps += 1
        self.samples += batch_size

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def rates(self) -> dict:
        dt = max(self.elapsed, 1e-9)
        return {
            "steps_per_sec": self.steps / dt,
            "samples_per_sec_per_chip": self.samples / dt,
        }
