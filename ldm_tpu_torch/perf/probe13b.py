"""Probe 13b: stage ablation of the fused ResNet-block kernel at the encL0
shape (2B=256, 32x32, 64 -> 64, bf16), the counterpart of the JAX package's
perf/probe13b.py: where does the block's time go?

    python -m ldm_tpu_torch.perf.probe13b [--out rows.json] [--iters 20]

Modes (``csrc/resnet_block_probe.cu``, the block's kernels built with a
compile-time mode; each output depends on every stage the mode keeps):

  noop    y = x: the launch and memory floor;
  gnonly  the block's three launches without products: the statistics'
          partial sums, the weights rounded once, every chunk's halo tile
          loaded and normalised, the epilogues (each conv is its normalised
          input's own pixel);
  center  each conv is its centre tap only (one K = C product);
  full    the block (the production kernel, bit for bit).

Every mode and its plain version are timed by CUDA-graph replay (device time).

The TPU probe's ``accum`` mode has no counterpart: the CUDA kernel builds no
lane-concatenated patch matrix, it accumulates tap by tap already, so
``accum`` is ``full``.  Each mode has a plain version,
:func:`probe_block_torch`, with the kernel's cast points; the run holds each
mode against it and reports its time and the delta over the mode before.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ldm_tpu_torch.ops import build
from ldm_tpu_torch.ops import resnet_block as rb
from ldm_tpu_torch.perf.common import card, cuda_graph_ms, require_cuda
from ldm_tpu_torch.perf.probe13 import GROUPS, site_args

# the probe's entry point: the mode, then the block's arguments
LIB = build.Library("resnet_block_probe", {
    "ldm_resnet_block_probe": ([ctypes.c_int] + rb.BLOCK_ARGTYPES, ctypes.c_int)})
MODES = ("noop", "gnonly", "center", "full")
_MODE_CODE = {m: i for i, m in enumerate(MODES)}  # resnet_block.cuh's MODE_*
B, SIDE, C = 256, 32, 64
DT = torch.bfloat16
TOL = 2e-2  # x max|plain|, the block's bf16 tolerance


def probe_block_torch(mode, x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2,
                      *, groups: int = GROUPS, eps: float = 1e-5) -> torch.Tensor:
    """Plain version of one mode, identity shortcut, computing in x's type
    with the TPU kernel's cast points (_resnet_kernel): GN statistics,
    affine and SiLU in fp32, rounded; conv1's fp32 sum rounded before its
    bias and the time row (added in x's type); conv2's sum + b2 + x in fp32.
    Products are fp32 sums of values of x's type (TF32 must be off)."""
    if mode not in _MODE_CODE:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    cd, f32 = x.dtype, torch.float32
    if mode == "noop":
        return x.clone()
    bsz, hh, ww, c = x.shape

    def gn_silu(t, scale, bias):
        tf = t.to(f32).reshape(bsz, hh * ww, groups, c // groups)
        mu = tf.mean(dim=(1, 3), keepdim=True)
        var = ((tf * tf).mean(dim=(1, 3), keepdim=True) - mu * mu).clamp_min(0.0)
        y = ((tf - mu) * torch.rsqrt(var + eps)).reshape(bsz, hh, ww, c) * scale + bias
        return (y * torch.sigmoid(y)).to(cd)

    def conv_sum(t, w):
        tf = t.to(f32)
        if mode == "gnonly":
            return tf
        wf = w.to(cd).to(f32)
        if mode == "center":
            return torch.einsum("bhwc,cd->bhwd", tf, wf[1, 1])
        return F.conv2d(tf.permute(0, 3, 1, 2), wf.permute(3, 2, 0, 1),
                        padding=1).permute(0, 2, 3, 1)

    h1 = conv_sum(gn_silu(x, n1s, n1b), w1).to(cd) + b1.to(cd)
    h1 = h1 + temb.to(cd)[:, None, None, :]
    y = conv_sum(gn_silu(h1, n2s, n2b), w2) + b2 + x.to(f32)
    return y.to(x.dtype)


def probe_block(mode, x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2,
                *, groups: int = GROUPS, eps: float = 1e-5) -> torch.Tensor:
    """One mode of the ablated kernel for a CUDA tensor (counted under its
    library's name), the plain version for a CPU tensor."""
    if mode not in _MODE_CODE:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    params = (n1s, n1b, w1, b1, n2s, n2b, w2, b2)
    if x.device.type == "cpu":
        return probe_block_torch(mode, x, temb, *params, groups=groups, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no probe implementation for device {x.device}")
    with torch.cuda.device(x.device):
        y, args, _scratch = rb.launch_args(x, temb, params, None, None, groups=groups,
                                           eps=eps, compute_dtype=x.dtype,
                                           use_shortcut=False)
        err = LIB.ldm_resnet_block_probe(_MODE_CODE[mode], rb._DTYPE_CODE[x.dtype], *args)
    if err != 0:
        raise RuntimeError(f"resnet-block probe ({mode}) launch failed: CUDA error {err}")
    LIB.count()
    return y


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows here as JSON")
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    a = ap.parse_args(argv)
    dev = require_cuda("probe13b")
    tag = card()
    args, _ = site_args(B, SIDE, C, C, DT, dev)
    args = args[:10]  # identity shortcut: no ws / bs
    rows, prev = [], 0.0
    with torch.inference_mode():
        for mode in MODES:
            got = probe_block(mode, *args).float()
            want = probe_block_torch(mode, *args).float()
            err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()
            ms = cuda_graph_ms(lambda: probe_block(mode, *args), iters=a.iters)
            plain_ms = cuda_graph_ms(lambda: probe_block_torch(mode, *args), iters=a.iters)
            rows.append({"mode": mode, "b": B, "dtype": "bfloat16", "ms": ms,
                         "delta_ms": ms - prev, "plain_ms": plain_ms, "rel_err": err,
                         "ok": err <= TOL, "card": tag})
            print(f"probe13b {mode} 2B={B} (1024, 64->64) bf16: {ms:.4f} ms "
                  f"(+{ms - prev:.4f}), plain {plain_ms:.4f} ms, vs plain rel_err "
                  f"{err:.2e} (tol {TOL:g}) [{tag}]", flush=True)
            prev = ms
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
