"""Plan sweep: the linear-attention kernels timed under the plans they could
have had, beside the one ``ops.linear_attention`` picks.

    python -m ldm_tpu_torch.perf.plan_sweep [--out rows.json] [--iters 20]

The launch plan is data the host side hands the kernels, so another plan
needs no rebuild.  Three sweeps, in bf16:

* the forward's persistent path (``plan_persistent``): at the 32px
  flagship UNet's sites and the latent UNet's, at 2B=256 and 2B=128, every
  CTAs an item (rows a unit: N / cs, at least 16; 8 and 16 at N=1024) and
  units in flight on an SM (1 or 2 teams of 8 warps) that fit, each with
  the first layout that fits (``_persistent_layout``, in the plan's order),
  beside the cluster path (one short CTA an item slice, ``plan_cluster``).
* the backward's cluster size: ``cluster_size`` is replaced for a call and
  ``plan_bwd`` lays out the rest (a size whose rows no longer fit in shared
  memory takes the tiled path), at each site with N >= 128, B=64, for 1, 2,
  4 and 8 CTAs an item with at least 64 rows each.
* the forward cluster path's optional copy of Wqkv^T in shared memory
  (``stage_w``): ``plan_cluster`` is given one (keep, stage_w) to try at a
  time, at sites where both fit (the 64px UNet's largest is on the tiled
  path, checked at 2B=4).

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
# (site, N, C) of the persistent sweep: the 32px flagship's sites and the
# latent UNet's
FWD_SITES = [("enc0", 1024, 64), ("enc1", 256, 128), ("enc2", 64, 256), ("enc3", 16, 512),
             ("dec0", 16, 256), ("dec1", 64, 128), ("dec2", 256, 64), ("latent", 16, 64)]
FWD_BATCHES = (256, 128)
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


def persistent_options(n: int, c: int) -> list:
    """Every persistent plan the kernel takes at (N, C), one a (cs, teams),
    and the cluster plan (None stands for it)."""
    plans = [None]
    for cs in (1, 2, 4, 8, 16):
        if n % cs or (cs > 1 and n // cs < 16):
            continue
        for teams in (1, 2):
            layouts = (la._persistent_layout(n, c, cs, teams, keep_q, *o) for keep_q in (0, 1)
                       for o in la.PERSISTENT_OPTIONS)
            plan = next((p for p in layouts if p is not None), None)
            if plan is not None:
                plans.append(plan)
    return plans


def forced(plan_fn, run, want, limit, iters: int):
    """run() under the plan plan_fn gives: its error against want and its ms."""
    rule = la.plan_fwd
    la.plan_fwd = plan_fn
    try:
        with torch.inference_mode():
            diff = (run().float() - want).abs()
            ms = cuda_graph_ms(run, iters=iters)
    finally:
        la.plan_fwd = rule
    return diff.max().item(), bool((diff <= limit).all()), ms


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows here as JSON")
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    a = ap.parse_args(argv)
    dev = require_cuda("plan_sweep")
    tag = card()
    rows = []

    for i, (site, n, c) in enumerate(FWD_SITES):
        for b in FWD_BATCHES:
            x, _, p = inputs(b, n, c, dev, seed=i)

            def run():
                return la.linear_attention_block(x, *p, **KW)

            with torch.inference_mode():
                want = la.linear_attention_block_torch(x, *p, **KW).float()
            limit = TOL[0] + TOL[1] * want.abs()
            picked = la.plan_fwd(n, c, torch.bfloat16, b)
            for plan in persistent_options(n, c):
                fallback = la.plan_cluster(n, c, torch.bfloat16)
                use = plan if plan is not None else fallback
                err, ok, ms = forced(lambda *_, use=use: use, run, want, limit, a.iters)
                what = (f"cs {use.cs} ({use.rows} rows), {use.teams} unit"
                        f"{'s' if use.teams > 1 else ''} in flight" if plan is not None
                        else f"cluster path, {use.cs} CTAs an item")
                rows.append({"site": site, "n": n, "c": c, "what": "fwd persistent", "b": b,
                             "cs": use.cs, "path": use.path, "teams": getattr(use, "teams", 1),
                             "smem_bytes": use.smem_bytes,
                             "ms": ms, "max_abs_err": err, "ok": ok, "picked": use == picked,
                             "card": tag})
                print(f"plan_sweep fwd {site} ({b}, {n}, {c}) bf16, {what} ({use.smem_bytes} B "
                      f"shared): {ms:.4f} ms, max_abs_err {err:.3e} {'ok' if ok else 'FAIL'}"
                      f"{' <- plan_fwd' if use == picked else ''} [{tag}]", flush=True)

    rule = la.cluster_size
    try:
        for i, (site, n, c) in enumerate(SITES):
            x, dy, p = inputs(64, n, c, dev, seed=i)
            want = la.linear_attention_block_bwd_torch(x, dy, *p, **KW)[0].float()
            limit = BWD_TOL * want.abs().max()
            for cs in sizes(n):
                la.cluster_size = lambda n_, cs=cs: cs
                plan = la.plan_bwd(n, c, x.dtype)
                diff = (la.linear_attention_block_bwd(x, dy, *p, **KW)[0].float() - want).abs()
                ok = bool((diff <= limit).all())
                ms = cuda_graph_ms(lambda: la.linear_attention_block_bwd(x, dy, *p, **KW)[0],
                                   iters=a.iters)
                picked = cs == rule(n)
                rows.append({"site": site, "n": n, "c": c, "what": "bwd", "b": 64, "cs": cs,
                             "path": plan.path, "smem_bytes": plan.smem_bytes, "ms": ms,
                             "max_abs_err": diff.max().item(), "ok": ok, "picked": picked,
                             "card": tag})
                print(f"plan_sweep bwd {site} (64, {n}, {c}) bf16, {cs} CTAs an item "
                      f"({plan.path} path, {plan.smem_bytes} B shared): {ms:.4f} ms, "
                      f"max_abs_err {diff.max().item():.3e} {'ok' if ok else 'FAIL'}"
                      f"{' <- cluster_size' if picked else ''} [{tag}]", flush=True)
    finally:
        la.cluster_size = rule

    for i, (site, b, n, c) in enumerate(COPY_SITES):
        x, _, p = inputs(b, n, c, dev, seed=i)

        def run():
            return la.linear_attention_block(x, *p, **KW)

        with torch.inference_mode():
            want = la.linear_attention_block_torch(x, *p, **KW).float()
        limit = TOL[0] + TOL[1] * want.abs()
        picked = la.plan_cluster(n, c, x.dtype)
        for option in la.FWD_OPTIONS:
            if option[0] != picked.keep:
                continue
            try:
                plan = la.plan_cluster(n, c, x.dtype, options=(option,))
            except ValueError:  # does not fit
                continue
            err, ok, ms = forced(lambda *_, plan=plan: plan, run, want, limit, a.iters)
            rows.append({"site": site, "n": n, "c": c, "what": "fwd stage_w", "b": b,
                         "cs": plan.cs, "path": plan.path, "stage_w": plan.stage_w,
                         "smem_bytes": plan.smem_bytes, "ms": ms, "max_abs_err": err, "ok": ok,
                         "picked": plan == picked, "card": tag})
            print(f"plan_sweep fwd {site} ({b}, {n}, {c}) bf16, {plan.path} path, "
                  f"{plan.cs} CTAs an item, stage_w {plan.stage_w} "
                  f"({plan.smem_bytes} B shared): {ms:.4f} ms, max_abs_err "
                  f"{err:.3e} {'ok' if ok else 'FAIL'}"
                  f"{' <- plan_cluster' if plan == picked else ''} [{tag}]", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)
    if not all(r["ok"] for r in rows):
        raise SystemExit("plan_sweep: a forced plan is off its plain version")
    return rows


if __name__ == "__main__":
    main()
