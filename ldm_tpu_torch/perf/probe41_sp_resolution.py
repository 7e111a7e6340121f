"""Probe 41: explicit spatial parallelism against data parallelism by
resolution (the port of the JAX package's perf/probe41_sp_resolution.py).

    python -m ldm_tpu_torch.perf.probe41_sp_resolution [sizes ...]
        [--device cuda|cpu] [--check 64] [--out probe41.json]

Spatial parallelism (``activation_sharding: spatial``,
``parallel/sp_explicit.py``) exists because activations grow with the
square of the resolution while the parameters do not.  This measures the
flagship UNet's whole gradient program (configs/protocol_hard.yaml with its
image_size replaced; the mean squared error against a target, backward,
the gradients reduced over the mesh) at 32, 64 and 128 px, over two
processes of one ``torch.distributed`` gloo group, at the JAX probe's
per-device ratios (it ran 8 virtual devices):

  dp2_B2   create_mesh()         global B=2: 1 image a process, full rows
  sp2_B2   create_mesh(model=2)  global B=2: 2 images a process, half rows
  sp2_B1   create_mesh(model=2)  global B=1: 1 image a process, half rows

Each row: the seconds a step over ``TIMING_STEPS`` steps after one warm-up
step, each process's peak bytes (``torch.cuda.max_memory_allocated`` after
the counters were reset; null on the CPU) and the attention kernels'
launches a step (the DP rows' blocks take the kernels on a card; SP's take
the plain attention over rows, no kernel).  Per size:
``overhead_matched_batch`` (sp2_B2 over dp2_B2, less 1: the halos, the
summed GroupNorm statistics and the gathered bottleneck at the same global
batch) and ``peak_bytes_ratio_per_image`` (sp2_B1 over dp2_B2, rank 0:
what splitting the rows saves an image).  ``--check`` sizes hold, in fp32
with the plain attention on both sides, the dp2_B2 gradients against the
sp2_B2 ones at the JAX SP tests' bars (rtol 2e-4, atol 1e-6).

On a card both processes are on cuda:0 (gloo stages CUDA tensors through
the host), so a step's seconds are directional only, as the JAX probe says
of its own.  Prints one line a row, with the card's name and power limit;
writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.perf.common import counting, device_tag, sync

CONFIG = "configs/protocol_hard.yaml"
SIZES = (32, 64, 128)
TIMING_STEPS = 3
ROWS = (("dp2_B2", 1, 2), ("sp2_B2", 2, 2), ("sp2_B1", 2, 1))  # (name, model axis, global B)
RTOL, ATOL = 2e-4, 1e-6  # tests/test_sp_explicit.py's gradient bars
WEIGHT_SEED = 0
TIMEOUT_S = 900
MODULE = "ldm_tpu_torch.perf.probe41_sp_resolution"


def size_config(base: Config, size: int, use_amp: Optional[bool] = None,
                model: Optional[dict] = None) -> Config:
    """``base`` at ``size`` px (its use_amp and model parameters replaced
    where given)."""
    cfg = dataclasses.replace(base, data=dataclasses.replace(base.data, image_size=size))
    if use_amp is not None:
        cfg = dataclasses.replace(cfg, use_amp=use_amp)
    if model is not None:
        cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, params=dict(model)))
    return cfg


def global_inputs(size: int, b: int, device):
    """The global batch, the same on every process (numpy from seeds, as
    the JAX probe draws its from keys 1-3): x, t in [0, 400), y (the null
    label included), the target."""
    x = np.random.default_rng(1).standard_normal((b, size, size, 3)).astype(np.float32)
    t = np.random.default_rng(2).integers(0, 400, b)
    y = (np.arange(b) * 3) % 11
    tgt = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)
    return (torch.from_numpy(x).to(device), torch.from_numpy(t).to(device),
            torch.from_numpy(y).to(device), torch.from_numpy(tgt).to(device))


def grad_step(model, mesh, spatial: bool, inputs) -> Callable[[], torch.Tensor]:
    """One gradient program on this process's part of ``inputs`` (its data
    row's images; under ``spatial`` its rows of them): the flat gradient of
    the global batch's mean squared error, reduced over the mesh."""
    from ldm_tpu_torch.parallel.sp_explicit import SpatialUNet

    x, t, y, tgt = (mesh.local_rows(v) for v in inputs)
    if spatial:
        x, tgt = mesh.model_rows(x), mesh.model_rows(tgt)
    forward = SpatialUNet(mesh, model) if spatial else model
    params = list(model.parameters())

    def step() -> torch.Tensor:
        for p in params:
            p.grad = None
        sq = (forward(x, t, y) - tgt) ** 2
        # spatial: this process's rows' terms of its data row's mean
        loss = sq.sum() / (sq.numel() * mesh.model_size) if spatial else sq.mean()
        loss.backward()
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        return mesh.split_mean_(flat) if spatial else mesh.all_reduce_mean_(flat)
    return step


def seeded_model(cfg: Config, device, weights: Optional[str] = None):
    """The UNet of ``cfg`` from ``WEIGHT_SEED``, or with the state dict saved
    at ``weights``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(WEIGHT_SEED)
        model = build_model(cfg, device).train()
    if weights is not None:
        model.load_state_dict(torch.load(weights, map_location=device), strict=True)
    return model


def measure(step, device, steps: int) -> dict:
    """One warm-up step, then ``steps`` timed; the peak bytes and the
    attention launches a step."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    step()
    sync(device)
    counts = {}
    t0 = time.perf_counter()
    with counting(counts, "timed"):
        for _ in range(steps):
            step()
        sync(device)
    return {"step_s": (time.perf_counter() - t0) / steps,
            "peak_bytes": torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None,
            "launches_per_step": {k: n // steps for k, n in counts["timed"].items()}}


def worker(rank: int, port: int, outdir: str, spec: dict) -> None:
    """One of the two processes: every size's rows, then the checks; its
    results to ``<outdir>/rank<rank>.pt``."""
    import torch.distributed as dist

    from ldm_tpu_torch.parallel import distributed
    from ldm_tpu_torch.parallel.mesh import create_mesh
    from ldm_tpu_torch.parallel.sp_explicit import supports_spatial_training

    device = torch.device(spec["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=2)
    try:
        distributed.build_kernels_once(device)
        meshes = {1: create_mesh(device=device), 2: create_mesh(model=2, device=device)}
        base = load_config(spec["config"])
        res = {"rows": {}, "checks": {}}
        for size in spec["sizes"]:
            cfg = size_config(base, size, model=spec.get("model"))
            model = seeded_model(cfg, device, spec.get("weights"))
            levels = len(model.encoder.downs)
            if not supports_spatial_training(meshes[2], size, levels):
                raise ValueError(f"{size} px does not split into even rows at {levels} levels")
            rows = {}
            for name, m, b in ROWS:
                step = grad_step(model, meshes[m], m > 1, global_inputs(size, b, device))
                rows[name] = measure(step, device, spec["timing_steps"])
            res["rows"][size] = rows
            del model
        for size in spec["check"]:
            cfg = size_config(base, size, use_amp=False, model=spec.get("model"))
            model = seeded_model(cfg, device, spec.get("weights")).set_attention_impl("torch")
            inputs = global_inputs(size, 2, device)
            dp = grad_step(model, meshes[1], False, inputs)().double().cpu()
            sp = grad_step(model, meshes[2], True, inputs)().double().cpu()
            diff = (sp - dp).abs()
            res["checks"][size] = {
                "max_abs": float(diff.max()),
                "max_excess": float((diff - ATOL - RTOL * dp.abs()).max()),
                "max_abs_grad": float(dp.abs().max()), "n": int(dp.numel())}
            if spec.get("keep_grads"):
                res["checks"][size]["dp_grad"] = dp
            del model
        torch.save(res, os.path.join(outdir, f"rank{rank}.pt"))
        meshes[1].barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(spec: dict, timeout: float = TIMEOUT_S) -> list:
    """The two worker processes of ``spec``; each one's results."""
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if spec["device"] == "cpu":
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as outdir:
        procs = [subprocess.Popen(
            [sys.executable, "-m", MODULE, "--worker", str(r), str(port), outdir,
             json.dumps(spec)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(2)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError(f"probe41 worker {r} failed:\n{logs[r][-4000:]}")
        return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
                for r in range(2)]


def run(sizes: Sequence[int] = SIZES, device="cuda", check: Sequence[int] = (),
        timing_steps: int = TIMING_STEPS, config: str = CONFIG, model: Optional[dict] = None,
        weights: Optional[str] = None, keep_grads: bool = False,
        log: Callable[[str], None] = print, tag: str = "") -> dict:
    """Both processes over ``sizes`` (and the ``check`` sizes' gradients);
    the JAX probe's JSON, each row with both processes' peak bytes.
    ``weights``: a saved state dict in place of the seeded weights;
    ``keep_grads``: each check's dp2_B2 flat gradient (fp64, the parameters
    in ``model.parameters()`` order) under its ``dp_grad``."""
    spec = {"sizes": list(sizes), "device": str(torch.device(device)), "check": list(check),
            "timing_steps": timing_steps, "config": os.path.abspath(config), "model": model,
            "weights": weights and os.path.abspath(weights), "keep_grads": keep_grads}
    if spec["device"] == "cuda":
        spec["device"] = "cuda:0"
    outs = spawn(spec)
    out = {"note": ("2 processes of one gloo group on one device (on a card both on "
                    "cuda:0, CUDA tensors staged through the host): step_s is directional; "
                    "peak_bytes is each process's max_memory_allocated"),
           "device": tag or spec["device"], "timing_steps": timing_steps}
    for size in sizes:
        row = {}
        for name, _, b in ROWS:
            r0, r1 = (o["rows"][size][name] for o in outs)
            row[name] = {"step_s": max(r0["step_s"], r1["step_s"]),
                         "step_s_by_rank": [r0["step_s"], r1["step_s"]],
                         "peak_bytes": [r0["peak_bytes"], r1["peak_bytes"]],
                         "launches_per_step": r0["launches_per_step"]}
            log(f"probe41 {size}px {name}: {row[name]} [{tag}]")
        row["overhead_matched_batch"] = row["sp2_B2"]["step_s"] / row["dp2_B2"]["step_s"] - 1
        dp_bytes = row["dp2_B2"]["peak_bytes"][0]
        row["peak_bytes_ratio_per_image"] = (None if dp_bytes is None else
                                             row["sp2_B1"]["peak_bytes"][0] / dp_bytes)
        log(f"probe41 {size}px: SP's overhead at a matched global batch "
            f"{row['overhead_matched_batch']:+.3f}, peak bytes an image SP / DP "
            f"{row['peak_bytes_ratio_per_image']} [{tag}]")
        out[f"{size}px"] = row
    for size in check:
        c = [o["checks"][size] for o in outs]
        ok = all(v["max_excess"] <= 0 for v in c)
        out.setdefault("grad_check", {})[f"{size}px"] = {"ranks": c, "rtol": RTOL, "atol": ATOL,
                                                         "ok": ok}
        if keep_grads:  # the same on both processes after the mean over the mesh
            grads = [v.pop("dp_grad") for v in c]
            if not torch.equal(*grads):
                raise AssertionError(f"probe41 {size}px: the processes' dp gradients differ")
            out["grad_check"][f"{size}px"]["dp_grad"] = grads[0]
        log(f"probe41 {size}px fp32 gradients, dp2_B2 vs sp2_B2 (plain attention on both): "
            f"max |diff| {max(v['max_abs'] for v in c):.3e} of max |grad| "
            f"{c[0]['max_abs_grad']:.3e}, worst excess over {ATOL:g} + {RTOL:g}|dp| "
            f"{max(v['max_excess'] for v in c):.3e}: {'within' if ok else 'OUTSIDE'} the bars "
            f"[{tag}]")
    return out


def main(argv: Optional[Sequence[str]] = None) -> Optional[dict]:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] == "--worker":
        rank, port, outdir, spec = argv[1:5]
        return worker(int(rank), int(port), outdir, json.loads(spec))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sizes", type=int, nargs="*", default=list(SIZES))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check", type=int, nargs="*", default=[],
                    help="sizes whose dp and sp gradients are compared in fp32")
    ap.add_argument("--out", help="write the result here as JSON")
    a = ap.parse_args(argv)
    tag = device_tag(a.device)
    out = run(a.sizes, a.device, a.check, tag=tag)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    if not all(v["ok"] for v in out.get("grad_check", {}).values()):
        raise SystemExit("probe41: the dp and sp gradients disagree")
    return out


if __name__ == "__main__":
    main()
