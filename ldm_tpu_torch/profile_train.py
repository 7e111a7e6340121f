"""Where the training step's time goes: host-clock ms/step and a
torch.profiler breakdown of ``DiffusionTrainer.train_step``, with the
flagship UNet by default.

    python -m ldm_tpu_torch.profile_train [config] [--batch 64] [--steps 10]
        [--runs 5] [--device cuda] [--trace-dir DIR]

Random weights from the config's seed and a random batch.  On a CUDA device
the step is profiled as it runs by default there (everything after the draws
captured into a CUDA graph and replayed) and then as the eager step that
launches every kernel from Python; on the CPU there is only the eager step.
For each it prints:

* ``ms/step``: ``--runs`` unprofiled runs of ``--steps`` train steps each,
  host clock from a device sync to a device sync;
* ``profiled``: one more run under ``torch.profiler`` -- its wall time, the
  device-busy time (the union of the device operations' intervals:
  ``utils/profiling.py::device_busy_s``), the busy share, and the device
  kernels per step;
* the device time per step of the linear-attention kernels (forward, and
  the backward's three launches), of the optimizer's one pass (Adam + EMA)
  and of everything else;
* the ten device kernels with the most time, per step.

On a CUDA device every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from ldm_tpu_torch.profile_sampler import FLAGSHIP, _sync, card_line
from ldm_tpu_torch.train import build_trainer
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.utils.profiling import device_busy_s


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=FLAGSHIP)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    tag = f" [{card_line()}]" if device.type == "cuda" else f" [{device}]"
    config = load_config(args.config)
    trainer = build_trainer(config, device)
    d = config.data
    g = torch.Generator().manual_seed(config.seed)
    batch = {
        "image": torch.rand(args.batch, d.image_size, d.image_size, d.image_channels,
                            generator=g) * 2 - 1,
        "label": torch.randint(0, d.num_classes, (args.batch,), generator=g),
    }

    results = {}
    loops = ["graphed", "eager"] if trainer.graphs else ["eager"]
    for how in loops:
        trainer.graphs = how == "graphed"
        res = _profile_step(args, trainer, batch, f"B={args.batch} {how} train step", tag, device)
        prof = res.pop("prof")
        if args.trace_dir:
            os.makedirs(args.trace_dir, exist_ok=True)
            name = f"train_B{args.batch}.json" if how == loops[0] else f"train_B{args.batch}_{how}.json"
            prof.export_chrome_trace(os.path.join(args.trace_dir, name))
        if how == loops[0]:
            results = res   # the default step's readings; the eager ones beside them
        else:
            results[how] = res
    return results


def _profile_step(args, trainer, batch, name: str, tag: str, device: torch.device) -> dict:
    """Host ms/step and the profiler's breakdown of the step, graphed or
    eager as ``trainer.graphs`` says."""

    def run():
        for _ in range(args.steps):
            trainer.train_step(batch)

    run()  # warm-up: cuDNN's choices, the kernels' build and load, the capture
    _sync(device)
    walls = []
    for _ in range(args.runs):
        t0 = time.perf_counter()
        run()
        _sync(device)
        walls.append((time.perf_counter() - t0) / args.steps * 1e3)
    print(f"{name} ms/step ({args.runs} runs of {args.steps} steps): "
          + " ".join(f"{w:.3f}" for w in walls) + tag, flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device kernels only: the optimizer's user-annotated span is listed on
    # the device too and would count its kernels twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_ms = device_busy_s(prof) * 1e3
    n_kernels = sum(e.count for e in kernels)
    print(f"{name} profiled: wall {wall_ms:.3f} ms for {args.steps} steps, device "
          f"busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% busy), device kernels "
          f"{n_kernels} ({n_kernels / args.steps:.1f}/step){tag}", flush=True)
    groups = {"linear-attention forward kernel": "lin_attn_fwd",
              "linear-attention backward kernels": "lin_attn_bwd",
              "Adam + EMA kernel": "fused_adam_ema"}
    split = {name: sum(e.device_time_total for e in kernels if key in e.key) / 1e3 / args.steps
             for name, key in groups.items()}
    split["everything else"] = busy_ms / args.steps - sum(split.values())
    for group, ms in split.items():
        print(f"  {ms:9.4f} ms/step  {group}")
    print("  top kernels:")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3 / args.steps:9.4f} ms/step "
              f"{e.count / args.steps:6.1f}/step  {e.key[:100]}")
    return {"ms_per_step": walls, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "kernels": n_kernels, "split_ms_per_step": split, "prof": prof}


if __name__ == "__main__":
    main()
