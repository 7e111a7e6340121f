"""Probe 7: stage ablation of the fused linear-attention forward kernel at
(2B=128, N=1024, C=64), bf16, the counterpart of the JAX package's
perf/probe7.py: which stage of the kernel costs what?

    python -m ldm_tpu_torch.perf.probe7 [--out rows.json] [--iters 20]

``csrc/linear_attention_fwd_probe.cu``: the forward's kernels built with a
compile-time STAGE in a library of their own, built when the probe runs, cut after
stage 1 GN1 | 2 + qkv | 3 + q softmax | 4 + k path (max, exp, sum) |
5 + ctx / ctx@Wout / out | 6 the whole block (+ GN2 and the residual).
Stages 1-5 write y = x + (what the stage made, lane c % 128), so each
depends on every stage it keeps; stage 6 is the production kernel.  Each
stage has a plain version, :func:`stage_torch`, with the kernel's cast
points; the run holds stages 1-5 against it and stage 6 against the
production kernel (bit for bit), and reports each stage's time and its plain
version's (device time: the calls replayed from a CUDA graph, so that the
host's launch cost is in neither) and its delta over the stage before.

Both designs of the kernel carry the cuts: the persistent schedule the plan
picks at this shape (``lin_attn_fwd_persistent_kernel``) and the cluster
path it replaced (one short CTA an item slice; ``plan_persistent`` turned
off for the run).  ``--design`` picks one; by default both, in that order.
"""

from __future__ import annotations

import argparse
import ctypes
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.ops import build
from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.perf.common import card, cuda_graph_ms, require_cuda

HEADS, DIM_HEAD = 4, 32
HIDDEN = HEADS * DIM_HEAD
STAGES = (1, 2, 3, 4, 5, 6)
B, N, C = 128, 1024, 64
DT = torch.bfloat16
# |kernel - plain| <= 3e-2 + 2^-7 |plain|: the forward kernel's bf16 check
TOL = (3e-2, 2.0**-7)
# the stage builds' entry points: the stage, then the production ones' arguments
LIB = build.Library("linear_attention_fwd_probe", {
    f"{name}_stage": ([ctypes.c_int] + argtypes, restype)
    for name, (argtypes, restype) in la.FWD_LIB.entry_points.items()})


def stage_torch(stage, x, wqkv, wout, bout, g1s, g1b, g2s, g2b, *, eps: float = 1e-5):
    """Plain version of one stage, computing in x's type with the cast
    points of ``linear_attention_block_torch`` (stage 6 is that function)."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    params = (wqkv, wout, bout, g1s, g1b, g2s, g2b)
    if stage == 6:
        return la.linear_attention_block_torch(
            x, *params, heads=HEADS, dim_head=DIM_HEAD, eps=eps, compute_dtype=x.dtype)
    cd, f32 = x.dtype, torch.float32
    lanes = torch.arange(x.shape[-1], device=x.device) % HIDDEN
    xf = x.to(f32)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.var(dim=(1, 2), keepdim=True, correction=0)
    h = ((xf - mean) * torch.rsqrt(var + eps) * g1s + g1b).to(cd)
    if stage == 1:
        return (xf + h.to(f32)).to(x.dtype)

    w = wqkv.to(cd)
    q, k, v = (h @ w[:, i * HIDDEN:(i + 1) * HIDDEN] for i in range(3))

    def out(*parts):  # y = x + the parts' lanes c % 128, summed left to right
        y = xf
        for p in parts:
            y = y + p.to(f32)[..., lanes]
        return y.to(x.dtype)

    if stage == 2:
        return out(q, k, v)
    seg = la.block_diag_mask(HEADS, DIM_HEAD, f32, x.device)
    q_shift = q.to(f32).amax(dim=-1, keepdim=True).to(cd)
    q_e = torch.exp(q - q_shift)
    qn = (q_e.to(f32) / (q_e.to(f32) @ seg) * DIM_HEAD**-0.5).to(cd)
    if stage == 3:
        return out(qn, k, v)
    k_shift = k.to(f32).amax(dim=1, keepdim=True).to(cd)
    k_e = torch.exp(k - k_shift)
    k_sum = k_e.to(f32).sum(dim=1, keepdim=True)
    if stage == 4:
        return out(qn, (k_e.to(f32) / k_sum).to(cd), v)
    ctx = torch.einsum("bnd,bne->bde", k_e, v).to(f32)
    ctx = ctx * (seg / k_sum.transpose(1, 2))
    ctx_w = torch.einsum("bde,ec->bdc", ctx.to(cd), wout.to(cd))
    o = torch.einsum("bdc,bnd->bnc", ctx_w, qn) + bout.to(cd)
    return (xf + o.to(f32)).to(x.dtype)


def stage_block(stage, x, wqkv, wout, bout, g1s, g1b, g2s, g2b, *, eps: float = 1e-5):
    """One stage of the ablated kernel for a CUDA tensor (counted under its
    library's name), the plain version for a CPU tensor."""
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    params = (wqkv, wout, bout, g1s, g1b, g2s, g2b)
    if x.device.type == "cpu":
        return stage_torch(stage, x, *params, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"no probe implementation for device {x.device}")

    def call(plan, args):
        LIB.count()
        if plan.path == "persistent":
            return LIB.ldm_lin_attn_fwd_persistent_stage(stage, *args)
        return LIB.ldm_lin_attn_fwd_stage(stage, *args)

    return la._launch_kernel(x, params, heads=HEADS, dim_head=DIM_HEAD, eps=eps,
                             compute_dtype=x.dtype, call=call)


def probe_inputs(device, dtype=DT, b: int = B, n: int = N, c: int = C, seed: int = 0):
    """x and the block's fp32 parameters, made with numpy from a seed (the
    JAX probe's recipe: projections x 0.2, zero bias, identity norms)."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    x = t(rng.standard_normal((b, n, c))).to(dtype)
    params = [t(rng.standard_normal((c, 3 * HIDDEN)) * 0.2),
              t(rng.standard_normal((HIDDEN, c)) * 0.2), t(np.zeros(c)),
              t(np.ones(c)), t(np.zeros(c)), t(np.ones(c)), t(np.zeros(c))]
    return x, params


DESIGNS = ("persistent", "cluster")


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows here as JSON")
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    ap.add_argument("--design", choices=DESIGNS, help="one design only (default: both)")
    a = ap.parse_args(argv)
    dev = require_cuda("probe7")
    tag = card()
    x, params = probe_inputs(dev)
    rows = []
    rule = la.plan_persistent
    for design in [a.design] if a.design else DESIGNS:
        if design == "cluster":
            la.plan_persistent = lambda *_, **__: None
        try:
            rows += run_stages(design, x, params, a.iters, tag)
        finally:
            la.plan_persistent = rule
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


def run_stages(design: str, x, params, iters: int, tag: str) -> list:
    """Stages 1-6 of one design: checked, timed, one row each."""
    atol, rtol = TOL
    path = la.plan_fwd(N, C, DT, B).path
    rows, prev = [], 0.0
    with torch.inference_mode():
        for stage in STAGES:
            got = stage_block(stage, x, *params)
            if stage == 6:
                want = la.linear_attention_block(x, *params, heads=HEADS, dim_head=DIM_HEAD,
                                                 compute_dtype=x.dtype)
                ok, check = torch.equal(got, want), "bit-identical to the production kernel"
            else:
                want = stage_torch(stage, x, *params)
                diff = (got.float() - want.float()).abs()
                ok = bool((diff <= atol + rtol * want.float().abs()).all())
                check = f"vs plain (tol {atol:g} + {rtol:g}|y|)"
            err = (got.float() - want.float()).abs().max().item()
            ms = cuda_graph_ms(lambda: stage_block(stage, x, *params), iters=iters)
            plain_ms = cuda_graph_ms(lambda: stage_torch(stage, x, *params), iters=iters)
            rows.append({"design": design, "path": path, "stage": stage, "b": B, "n": N,
                         "c": C, "dtype": "bfloat16", "ms": ms, "delta_ms": ms - prev,
                         "plain_ms": plain_ms, "max_abs_err": err, "ok": ok, "card": tag})
            print(f"probe7 {design} ({path} path) stage {stage} ({B}, {N}, {C}) bf16: "
                  f"{ms:.4f} ms (+{ms - prev:.4f}), plain {plain_ms:.4f} ms, max_abs_err "
                  f"{err:.3e} {check}: {'ok' if ok else 'FAIL'} [{tag}]", flush=True)
            prev = ms
    return rows


if __name__ == "__main__":
    main()
