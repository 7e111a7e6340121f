"""Probe 43: the flagship train step at 128 px on one card, the batch swept
upward (the port of the JAX package's perf/probe43_128px_device.py).

    python -m ldm_tpu_torch.perf.probe43_128px_device [--out rows.json]
        [--device cuda|cpu] [--batches 8 16 32 64 128]

The flagship UNet at 128x128x3 (64 channels, multipliers 1/2/4/8, 10
classes, 20,350,915 parameters), T=1000, bf16 compute with fp32
parameters, lr 5e-4, the per-sample label drop at 0.1, zero images.  The
step is the one the port's trainers run on a card: ``DiffusionTrainer``'s
step captured into a CUDA graph and replayed (``utils/graphs.py``), Adam
and the EMA in one pass (``TrainState.update``), the attention blocks'
forward and backward kernels inside.

For each batch B an attempt builds the trainer from the seeded weights,
takes the 3 eager steps that warm the capture up (the first is the cold
step), captures the step and replays it.  Its row: the peak of
``torch.cuda.max_memory_allocated`` and ``max_memory_reserved`` over the
attempt (the counters reset before it; the reserved bytes hold the eager
steps' cache and the graph's own pool), the cold and warm step seconds (a
warm step: one replay and its wait, the median of ``--timed``), the
device's ms a replay, the loss, the attention and optimizer launches a
replayed step, and whether the step fits.  A ``torch.cuda.OutOfMemoryError``
ends the attempt with ``fits: false`` and the error; the cache is emptied
before the next one.  The sweep stops at the first B that does not fit
and retries it with ``torch.utils.checkpoint.checkpoint`` around the UNet's
forward (the JAX probe's ``jax.checkpoint(model.apply)``), then prints the
JAX probe's verdict line.  The recompute runs inside the captured step
as any other (``"graphed"`` says so in every row).

:func:`compare_remat` holds the step with the recompute against the step
without it: two trainers from the same weights and draws, cuDNN's
deterministic algorithms, the losses of each step and every gradient of the
last (a replayed step on a card).  Prints one line a row, each with the
card's name and power limit; writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import statistics
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu_torch.factory import build_diffusion, build_model
from ldm_tpu_torch.perf.common import counting, device_tag, sync
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.utils.graphs import WARMUP_STEPS

RES = 128
BATCHES = (8, 16, 32, 64, 128)
FLAGSHIP = dict(in_channels=3, out_channels=3, channels=64, channel_multipliers=[1, 2, 4, 8],
                with_time_emb=True, num_classes=10)
T_STEPS = 1000
LR = 5e-4
WEIGHT_SEED = 0  # the JAX probe's init key
STEP_SEED = 1    # the JAX probe's state key: the per-step draws' stream
TIMED = 5


def probe_config(res: int = RES, workdir: str = "runs", model: Optional[dict] = None,
                 use_amp: bool = True) -> Config:
    """The JAX probe's step as a config: the flagship (or ``model``'s
    parameters) at ``res``, T=1000, lr 5e-4, bf16 under ``use_amp``, each
    sample's label dropped with p = 0.1, draws from ``STEP_SEED``."""
    return Config(project_name=f"probe43_{res}px", workdir=workdir, batch_size=1,
                  lr=LR, use_amp=use_amp, seed=STEP_SEED,
                  model=ModelConfig(params=dict(model or FLAGSHIP)),
                  diffusion=DiffusionConfig(n_steps=T_STEPS, label_drop_mode="sample",
                                            label_drop_prob=0.1),
                  data=DataConfig(dataset="SYNTHETIC", image_channels=3, image_size=res))


class ProbeTrainer(DiffusionTrainer):
    """The diffusion trainer; with ``remat`` the UNet's forward runs under
    ``torch.utils.checkpoint.checkpoint`` (non-reentrant), so the backward
    recomputes it instead of keeping its activations.  The forward draws
    nothing, so no random state is stashed (``preserve_rng_state=False``:
    reading the generator is not allowed inside a capture)."""

    remat = False

    def _forward(self, model):
        forward = super()._forward(model)
        if not self.remat:
            return forward

        def recomputed(*args):
            return checkpoint(forward, *args, use_reentrant=False, preserve_rng_state=False)
        return recomputed


def make_trainer(cfg: Config, device, remat: bool = False) -> ProbeTrainer:
    """A fresh trainer on ``device`` from the seeded weights (every attempt
    starts from the same state, as the JAX probe rebuilds its state)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(WEIGHT_SEED)
        model = build_model(cfg, device)
    trainer = ProbeTrainer(cfg, model, build_diffusion(cfg, device), None, None,
                           list(range(10)), device=device)
    trainer.remat = remat
    return trainer


def zero_batch(cfg: Config, b: int) -> dict:
    """The JAX probe's batch: zero images, label 0."""
    s = cfg.data.image_size
    return {"image": np.zeros((b, s, s, 3), np.float32), "label": np.zeros((b,), np.int32)}


def _memory(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"max_memory_allocated": None, "max_memory_reserved": None}
    return {"max_memory_allocated": torch.cuda.max_memory_allocated(device),
            "max_memory_reserved": torch.cuda.max_memory_reserved(device)}


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _steps(trainer: ProbeTrainer, batch: dict, row: dict, timed: int, device) -> None:
    """The attempt's steps, writing into ``row`` as they go: the cold step,
    the rest of the capture's warm-up, the capture with its first replay,
    ``timed`` replays (a warm step each), the launches of one more step."""
    t0 = time.perf_counter()
    loss = trainer.train_step(batch)["loss"].item()
    row["step_s_cold"] = time.perf_counter() - t0
    row["loss"] = loss
    for _ in range(WARMUP_STEPS - 1):
        trainer.train_step(batch)
    sync(device)
    t0 = time.perf_counter()
    trainer.train_step(batch)  # on a card: the capture, then the first replay
    sync(device)
    row["capture_step_s"] = time.perf_counter() - t0
    warm = []
    for _ in range(timed):
        t0 = time.perf_counter()
        m = trainer.train_step(batch)
        loss = m["loss"].item()  # the wait
        warm.append(time.perf_counter() - t0)
    row["step_s_warm"] = statistics.median(warm) if warm else None
    row["loss_last"] = loss
    with counting(row, "launches_per_step"):
        trainer.train_step(batch)
    graph = trainer.train_graph
    row["graphed"] = graph is not None
    row["device_ms"] = graph.device_ms(replays=timed) if graph is not None and timed else None
    row["fits"] = bool(np.isfinite(row["loss"]) and np.isfinite(loss))


def attempt(cfg: Config, batch: int, remat: bool, device, timed: int = TIMED) -> dict:
    """One batch size: a fresh trainer, its steps, the peak memory; a
    ``torch.cuda.OutOfMemoryError`` gives ``fits: false`` and the error."""
    row = {"batch": batch, "remat": remat}
    _free(device)
    trainer = None
    try:
        with tempfile.TemporaryDirectory() as workdir:
            cfg = dataclasses.replace(cfg, workdir=workdir)
            trainer = make_trainer(cfg, device, remat)
            _steps(trainer, zero_batch(cfg, batch), row, timed, device)
            row.update(_memory(device))
    except torch.cuda.OutOfMemoryError as e:
        row["fits"] = False
        row["error"] = f"execute: {type(e).__name__}: {e}"[:300]
        row.update(_memory(device))
    finally:
        del trainer
        _free(device)
    return row


def verdict(out: dict, res: int = RES) -> str:
    """The JAX probe's verdict line."""
    if any(a.get("fits") for a in out["attempts"]):
        return (f"{res}px single-chip training FITS up to B="
                f"{out['max_fitting_batch_no_remat']} without remat")
    return f"{res}px single-chip training does NOT fit at any batch"


def sweep(cfg: Config, device, batches: Sequence[int] = BATCHES, timed: int = TIMED,
          log: Callable[[str], None] = print, tag: str = "") -> dict:
    """The JAX probe's loop: B upward until a step does not fit, then that B
    again with the recompute; the verdict."""
    res = cfg.data.image_size
    n_params = sum(p.numel() for p in build_model(cfg, "cpu").parameters())
    out = {"device": str(torch.device(device)), "card": tag, "resolution": res,
           "n_params": int(n_params), "attempts": []}
    oom = None
    for b in batches:
        row = attempt(cfg, b, False, device, timed)
        out["attempts"].append(row)
        log(row_line(row, res, tag))
        if not row.get("fits"):
            oom = b
            break
    if oom is not None:
        row = attempt(cfg, oom, True, device, timed)
        out["attempts"].append(row)
        log(row_line(row, res, tag))
    out["max_fitting_batch_no_remat"] = max(
        [a["batch"] for a in out["attempts"] if a.get("fits") and not a["remat"]], default=0)
    out["verdict"] = verdict(out, res)
    log(f"probe43 verdict: {out['verdict']} [{tag}]")
    return out


def _gib(v) -> str:
    return "n/a" if v is None else f"{v / 2**30:.3f} GiB"


def row_line(row: dict, res: int, tag: str) -> str:
    head = f"probe43 {res}px B={row['batch']} remat={row['remat']}"
    if not row.get("fits"):
        return (f"{head}: does NOT fit ({row.get('error', 'non-finite loss')}); peak allocated "
                f"{_gib(row.get('max_memory_allocated'))} [{tag}]")
    dev = "n/a" if row["device_ms"] is None else f"{row['device_ms']:.3f} ms"
    return (f"{head}: fits, graphed {row['graphed']}, loss {row['loss']:.6f}, cold step "
            f"{row['step_s_cold']:.3f} s, warm step {row['step_s_warm']:.4f} s, device "
            f"{dev} a replay, peak allocated {_gib(row['max_memory_allocated'])}, reserved "
            f"{_gib(row['max_memory_reserved'])}, launches a step {row['launches_per_step']} "
            f"[{tag}]")


@contextlib.contextmanager
def deterministic():
    """cuDNN's deterministic algorithms, no autotuning; the flags put back."""
    flags = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags


def compare_remat(cfg: Config, batch: int, device, steps: int = WARMUP_STEPS + 2) -> dict:
    """The step with the recompute against the step without it, from the
    same weights and draws (cuDNN deterministic), ``steps`` steps each (on a
    card: the capture's warm-up, then replays): each step's loss, every
    gradient of the last step as the largest |difference| over its leaf's
    largest entry, the attention launches a step of each, and whether the
    two were bit for bit."""
    out = {"batch": batch, "steps": steps}
    with deterministic(), tempfile.TemporaryDirectory() as workdir:
        cfg = dataclasses.replace(cfg, workdir=workdir)
        images = zero_batch(cfg, batch)
        runs = {}
        for remat in (False, True):
            trainer = make_trainer(cfg, device, remat)
            losses, counts = [], {}
            for _ in range(steps - 1):
                losses.append(trainer.train_step(images)["loss"].item())
            with counting(counts, "last"):
                losses.append(trainer.train_step(images)["loss"].item())
            grads = {n: p.grad.detach().clone() for n, p in trainer.model.named_parameters()}
            runs[remat] = (losses, grads, counts["last"], trainer.train_graph is not None)
            del trainer
            _free(device)
    (l0, g0, c0, graphed0), (l1, g1, c1, graphed1) = runs[False], runs[True]
    rel = {n: float((g1[n] - g).abs().max() / g.abs().max().clamp_min(1e-30))
           for n, g in g0.items()}
    out.update(losses=l0, losses_remat=l1, loss_abs=max(abs(a - b) for a, b in zip(l0, l1)),
               grad_rel=max(rel.values()), worst_leaf=max(rel, key=rel.get),
               launches=c0, launches_remat=c1, graphed=graphed0, graphed_remat=graphed1,
               bitwise=l0 == l1 and all(torch.equal(g1[n], g) for n, g in g0.items()))
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the result here as JSON")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batches", type=int, nargs="+", default=list(BATCHES))
    ap.add_argument("--timed", type=int, default=TIMED, help="timed replays a batch")
    a = ap.parse_args(argv)
    tag = device_tag(a.device)
    out = sweep(probe_config(), torch.device(a.device), a.batches, a.timed, tag=tag)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
