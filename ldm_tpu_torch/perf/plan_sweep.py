"""Plan sweep: the linear-attention kernels timed under the plans they could
have had, beside the one ``ops.linear_attention`` picks.

    python -m ldm_tpu_torch.perf.plan_sweep [--out rows.json] [--iters 20]

The launch plan is data the host side hands the kernels, so another plan
needs no rebuild.  Two sweeps, in bf16:

* cluster size: ``cluster_size`` is replaced for a call and ``plan_fwd`` /
  ``plan_bwd`` lay out the rest (a size whose rows no longer fit in shared
  memory takes the tiled path).  At each attention site of the 32px flagship
  UNet with N >= 128: the forward kernel at 2B=128 and 2B=20 and the backward
  kernels at B=64, for 1, 2, 4 and 8 CTAs an item with at least 64 rows each.
* the forward's optional copy of Wqkv^T in shared memory (``stage_w``):
  ``plan_fwd`` is given one (keep, stage_w) to try at a time, at the cluster
  size the rule picks, at sites where both fit.

Every forced plan is first held against the plain version (the forward's
tolerance; the backward's on dx), then timed by CUDA-graph replay (device
time, no host in it).  One line a plan; the one the rule picks is marked.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch

from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.perf.common import card, cuda_graph_ms, require_cuda

SITES = [("enc0", 1024, 64), ("enc1", 256, 128), ("dec2", 256, 64)]
# (site, 2B, N, C) of the copy's sweep: the C=64 flagship sites, a small-N
# site and the 64px UNet's largest (tiled path, checked at 2B=4)
COPY_SITES = [("enc0", 128, 1024, 64), ("enc0", 20, 1024, 64), ("dec2", 128, 256, 64),
              ("dec1", 128, 64, 128), ("64px-l0", 4, 4096, 64)]
KW = dict(heads=4, dim_head=32, compute_dtype=torch.bfloat16)
TOL = (3e-2, 2.0**-7)  # forward: |kernel - plain| <= 3e-2 + 2^-7 |plain|
BWD_TOL = 2e-2         # backward: |dx - plain| <= 2e-2 max|plain|


def inputs(b: int, n: int, c: int, dev, seed: int):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    x, dy = r(b, n, c).to(dev, torch.bfloat16), r(b, n, c).to(dev, torch.bfloat16)
    p = [r(c, 384) / c**0.5, r(128, c) / 128**0.5, 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c),
         1 + 0.1 * r(c), 0.1 * r(c)]
    return x, dy, [t.to(dev) for t in p]


def sizes(n: int) -> list:
    return [cs for cs in (1, 2, 4, 8) if n % cs == 0 and n // cs >= la.TILE_R]


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows here as JSON")
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    a = ap.parse_args(argv)
    dev = require_cuda("plan_sweep")
    tag = card()
    rule = la.cluster_size
    rows = []
    try:
        for i, (site, n, c) in enumerate(SITES):
            for what, b in (("fwd", 128), ("fwd", 20), ("bwd", 64)):
                x, dy, p = inputs(b, n, c, dev, seed=i)
                if what == "fwd":
                    def run():
                        return la.linear_attention_block(x, *p, **KW)
                    with torch.inference_mode():
                        want = la.linear_attention_block_torch(x, *p, **KW).float()
                    limit = TOL[0] + TOL[1] * want.abs()
                else:
                    def run():
                        return la.linear_attention_block_bwd(x, dy, *p, **KW)[0]
                    want = la.linear_attention_block_bwd_torch(x, dy, *p, **KW)[0].float()
                    limit = BWD_TOL * want.abs().max()
                for cs in sizes(n):
                    la.cluster_size = lambda n_, cs=cs: cs
                    plan = (la.plan_fwd if what == "fwd" else la.plan_bwd)(n, c, x.dtype)
                    with torch.inference_mode():
                        diff = (run().float() - want).abs()
                        ok = bool((diff <= limit).all())
                        ms = cuda_graph_ms(run, iters=a.iters)
                    picked = cs == rule(n)
                    rows.append({"site": site, "n": n, "c": c, "what": what, "b": b, "cs": cs,
                                 "path": plan.path, "smem_bytes": plan.smem_bytes, "ms": ms,
                                 "max_abs_err": diff.max().item(), "ok": ok, "picked": picked,
                                 "card": tag})
                    print(f"plan_sweep {what} {site} ({b}, {n}, {c}) bf16, {cs} CTAs an item "
                          f"({plan.path} path, {plan.smem_bytes} B shared): {ms:.4f} ms, "
                          f"max_abs_err {diff.max().item():.3e} {'ok' if ok else 'FAIL'}"
                          f"{' <- cluster_size' if picked else ''} [{tag}]", flush=True)
    finally:
        la.cluster_size = rule

    plan_rule = la.plan_fwd
    try:
        for i, (site, b, n, c) in enumerate(COPY_SITES):
            x, _, p = inputs(b, n, c, dev, seed=i)
            with torch.inference_mode():
                want = la.linear_attention_block_torch(x, *p, **KW).float()
            limit = TOL[0] + TOL[1] * want.abs()
            picked = plan_rule(n, c, x.dtype)
            for option in la.FWD_OPTIONS:
                if option[0] != picked.keep:
                    continue
                try:
                    plan = plan_rule(n, c, x.dtype, options=(option,))
                except ValueError:  # does not fit
                    continue
                la.plan_fwd = lambda *_, plan=plan: plan
                with torch.inference_mode():
                    diff = (la.linear_attention_block(x, *p, **KW).float() - want).abs()
                    ok = bool((diff <= limit).all())
                    ms = cuda_graph_ms(lambda: la.linear_attention_block(x, *p, **KW),
                                       iters=a.iters)
                rows.append({"site": site, "n": n, "c": c, "what": "fwd stage_w", "b": b,
                             "cs": plan.cs, "path": plan.path, "stage_w": plan.stage_w,
                             "smem_bytes": plan.smem_bytes, "ms": ms,
                             "max_abs_err": diff.max().item(), "ok": ok,
                             "picked": plan == picked, "card": tag})
                print(f"plan_sweep fwd {site} ({b}, {n}, {c}) bf16, {plan.path} path, "
                      f"{plan.cs} CTAs an item, stage_w {plan.stage_w} "
                      f"({plan.smem_bytes} B shared): {ms:.4f} ms, max_abs_err "
                      f"{diff.max().item():.3e} {'ok' if ok else 'FAIL'}"
                      f"{' <- plan_fwd' if plan == picked else ''} [{tag}]", flush=True)
    finally:
        la.plan_fwd = plan_rule
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)
    if not all(r["ok"] for r in rows):
        raise SystemExit("plan_sweep: a forced plan is off its plain version")
    return rows


if __name__ == "__main__":
    main()
