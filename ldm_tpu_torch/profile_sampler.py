"""Where the sampler's time goes: host-clock ms/step and a torch.profiler
breakdown of the ancestral CFG sampler, with the flagship UNet by default.

    python -m ldm_tpu_torch.profile_sampler [config] [--batches 64 10]
        [--steps 10] [--runs 5] [--device cuda] [--trace-dir DIR]

Random weights from the config's seed.  On a CUDA device the sampler is
profiled as it runs by default there, one step captured into a CUDA graph and
replayed, and then as the eager loop that launches every kernel from Python;
on the CPU there is only the eager loop.  For each batch B (2B rows per UNet
forward) and each of the two it prints:

* ``ms/step``: ``--runs`` unprofiled runs of ``--steps`` sampler steps each,
  host clock from a device sync to a device sync;
* ``profiled``: one more run under ``torch.profiler`` -- its wall time, the
  device-busy time (the union of the device operations' intervals:
  ``utils/profiling.py::device_busy_s``), the busy share of the wall time,
  and the device kernels per step;
* the ten device kernels with the most time, per step.

The profiler adds host cost of its own, so the busy share under it is a
lower bound.  ``--trace-dir`` writes one Chrome trace per batch and loop
there (``sampler_B<b>.json`` the default loop, ``sampler_B<b>_eager.json``).
On a CUDA device every line carries the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.utils.graphs import use_graphs
from ldm_tpu_torch.utils.profiling import device_busy_s

FLAGSHIP = "configs/pixel_diffusion_model_cifar10.yaml"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config", nargs="?", default=FLAGSHIP)
    ap.add_argument("--batches", type=int, nargs="+", default=[64, 10])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    tag = f" [{card_line()}]" if device.type == "cuda" else f" [{device}]"
    config = load_config(args.config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_model(config, device).eval()
    diffusion = GaussianDiffusion(args.steps, device=device)
    d = config.data
    shape = (d.image_size, d.image_size, d.image_channels)

    results = {}
    loops = [("graphed", True), ("eager", False)] if use_graphs(device, None) else [("eager", False)]
    for b in args.batches:
        classes = (torch.arange(b) % d.num_classes).to(device)
        gen = torch.Generator(device=device).manual_seed(config.seed)
        for how, graph in loops:
            res = _profile_loop(args, config, model, diffusion, classes, shape, gen, graph,
                                f"B={b} {how}", tag, device)
            if args.trace_dir:
                os.makedirs(args.trace_dir, exist_ok=True)
                name = f"sampler_B{b}.json" if how == loops[0][0] else f"sampler_B{b}_{how}.json"
                res.pop("prof").export_chrome_trace(os.path.join(args.trace_dir, name))
            res.pop("prof", None)
            if how == loops[0][0]:
                results[b] = res   # the default loop's readings; the eager ones beside them
            else:
                results[b][how] = res
    return results


def _profile_loop(args, config, model, diffusion, classes, shape, gen, graph: bool, name: str,
                  tag: str, device: torch.device) -> dict:
    """Host ms/step and the profiler's breakdown of one loop (graphed or
    eager) at one batch."""

    def run():
        diffusion.sample(model, classes, shape, cfg_scale=config.diffusion.cfg_scale,
                         null_label=model.null_label, generator=gen, graph=graph)

    run()  # warm-up: cuDNN's choices, the kernel's build and load, the capture
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
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = device_busy_s(prof) * 1e3
    n_kernels = sum(e.count for e in kernels)
    print(f"{name} profiled: wall {wall_ms:.3f} ms for {args.steps} steps, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% busy), device kernels "
          f"{n_kernels} ({n_kernels / args.steps:.1f}/step){tag}", flush=True)
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:10]:
        print(f"  {e.device_time_total / 1e3 / args.steps:9.4f} ms/step "
              f"{e.count / args.steps:6.1f}/step  {e.key[:100]}")
    return {"ms_per_step": walls, "busy_ms": busy_ms, "wall_ms": wall_ms,
            "kernels": n_kernels, "prof": prof}


if __name__ == "__main__":
    main()
