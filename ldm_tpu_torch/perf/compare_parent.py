"""Two trees' kernels timed in turns on one card: this checkout against
another (an earlier commit unpacked beside it).

    git archive <commit> | tar -x -C build/parent      # build/ is git-ignored
    python -m ldm_tpu_torch.perf.compare_parent --parent build/parent [--out rows.json]

Runs parent, this, this, parent, each in a process of its own that builds
that tree's kernels and times, in bf16: at the 8 attention sites of the 32px
flagship UNet the linear-attention forward kernel at 2B=256, 2B=128 and
2B=20 and the backward kernels at B=64; the forward at the latent UNet's
site (16, 64) at 2B=256 and at (1024, 64) and (16384, 64) at B=64; at the
flagship's 11 ResNet sites the fused ResNet block at 2B=128 and 2B=20.
Both trees are called through the functions they share
(``linear_attention_block``, ``linear_attention_block_bwd`` and
``resnet_block`` on CUDA tensors, weights as the ops take them, so a tree's
own weight copies are inside its time), and timed by the same code: 20 calls
captured into a CUDA graph, replayed, CUDA events around the replays, so
that the host's launch cost is out of the numbers.  Prints one line a site
and the sums; exits nonzero when a group's sum of this tree is above
``LIMITS`` times the parent's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional, Sequence

from ldm_tpu_torch.perf.common import card, require_cuda

# this / parent a group's sum must stay below.  1.02 is the spread between
# two runs of one tree: the limit for kernels whose design is the parent's
# (a change that must cost nothing, such as the attention kernels' true-width
# argument).  A group whose kernel is redesigned after the parent gets 1.0.
# fwdx: the latent site beside (1024, 64) and (16384, 64) at B=64, whose sum
# the tiled path at (16384, 64), the parent's design, takes most of.
LIMITS = {"fwd256": 1.0, "fwd128": 1.0, "fwd20": 1.0, "fwdx": 1.02, "bwd64": 1.02,
          "rb128": 1.02, "rb20": 1.02}

# what each tree runs: only names both trees have
CHILD = r'''
import json, sys, numpy as np, torch
from ldm_tpu_torch.ops import build, linear_attention as la
from ldm_tpu_torch.ops.resnet_block import resnet_block
torch.backends.cuda.matmul.allow_tf32 = False
SITES = [("enc0", 1024, 64), ("enc1", 256, 128), ("enc2", 64, 256), ("enc3", 16, 512),
         ("dec0", 16, 256), ("dec1", 64, 128), ("dec2", 256, 64), ("dec3", 1024, 64)]
DEV, DT, KW = torch.device("cuda"), torch.bfloat16, dict(heads=4, dim_head=32, compute_dtype=torch.bfloat16)

def inputs(b, n, c, seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    x, dy = r(b, n, c).to(DEV, DT), r(b, n, c).to(DEV, DT)
    p = [r(c, 384) / c**0.5, r(128, c) / 128**0.5, 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c),
         1 + 0.1 * r(c), 0.1 * r(c)]
    return x, dy, [t.to(DEV) for t in p]

def graph_ms(fn, iters=20, replays=3):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(replays):
        g.replay()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / (iters * replays)

RB_SITES = [("enc0", 32, 64, 64), ("enc1", 16, 64, 128), ("enc2", 8, 128, 256),
            ("enc3", 4, 256, 512), ("mid0", 2, 512, 512), ("mid1", 2, 512, 512),
            ("dec0", 4, 768, 256), ("dec1", 8, 384, 128), ("dec2", 16, 192, 64),
            ("dec3", 32, 128, 64), ("head", 32, 64, 64)]

def rb_inputs(b, side, cin, cout, seed):
    rng = np.random.RandomState(seed)
    t = lambda a, dt=torch.float32: torch.from_numpy(np.asarray(a, np.float32)).to(DEV, dt)
    sc = cin != cout
    return (t(rng.randn(b, side, side, cin) * 0.5, DT), t(rng.randn(b, cout) * 0.1),
            t(1 + 0.1 * rng.randn(cin)), t(0.1 * rng.randn(cin)),
            t(rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)), t(0.1 * rng.randn(cout)),
            t(1 + 0.1 * rng.randn(cout)), t(0.1 * rng.randn(cout)),
            t(rng.randn(3, 3, cout, cout) / np.sqrt(9 * cout)), t(0.1 * rng.randn(cout)),
            t(rng.randn(cin, cout) / np.sqrt(cin)) if sc else t(np.zeros((1, 1))),
            t(0.1 * rng.randn(cout)) if sc else t(np.zeros((1, 1)))), sc

build.build()
rows = {}
for i, (site, n, c) in enumerate(SITES):
    for b in (256, 128, 20):
        x, dy, p = inputs(b, n, c, i)
        with torch.inference_mode():
            rows[f"fwd{b} {site}"] = graph_ms(lambda: la.linear_attention_block(x, *p, **KW))
    x, dy, p = inputs(64, n, c, i)
    rows[f"bwd64 {site}"] = graph_ms(lambda: la.linear_attention_block_bwd(x, dy, *p, **KW))
for i, (site, b, n, c) in enumerate([("latent256", 256, 16, 64), ("b64-1024", 64, 1024, 64),
                                     ("b64-16384", 64, 16384, 64)]):
    x, dy, p = inputs(b, n, c, i)
    with torch.inference_mode():
        rows[f"fwdx {site}"] = graph_ms(lambda: la.linear_attention_block(x, *p, **KW),
                                        iters=5 if n > 1024 else 20)
for i, (site, side, cin, cout) in enumerate(RB_SITES):
    for b in (128, 20):
        args, sc = rb_inputs(b, side, cin, cout, i)
        with torch.inference_mode():
            rows[f"rb{b} {site}"] = graph_ms(
                lambda: resnet_block(*args, groups=8, compute_dtype=DT, use_shortcut=sc))
print("ROWS " + json.dumps(rows))
'''


def run_tree(tree: Path) -> dict:
    """Build and time one tree's kernels in a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(tree),
               LDM_TPU_TORCH_BUILD_DIR=str(tree / "build" / "ldm_tpu_torch"))
    r = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, env=env, capture_output=True,
                       text=True, timeout=1200)
    if r.returncode != 0:
        raise RuntimeError(f"timing {tree} failed:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("ROWS ")][-1]
    return json.loads(line[5:])


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="the other tree's root")
    ap.add_argument("--out", help="write every run's rows here as JSON")
    a = ap.parse_args(argv)
    require_cuda("compare_parent")
    tag = card()
    here = Path(__file__).resolve().parents[2]
    parent = Path(a.parent).resolve()
    runs = [("parent", run_tree(parent)), ("this", run_tree(here)),
            ("this", run_tree(here)), ("parent", run_tree(parent))]
    mean = {who: {k: sum(r[k] for w, r in runs if w == who) / 2 for k in runs[0][1]}
            for who in ("parent", "this")}
    for k in runs[0][1]:
        vals = " ".join(f"{w} {r[k]:.4f}" for w, r in runs)
        print(f"{k} bf16: {vals} ms; this/parent {mean['this'][k] / mean['parent'][k]:.3f} "
              f"[{tag}]")
    ok = True
    for group, limit in LIMITS.items():
        keys = [k for k in mean["this"] if k.startswith(group + " ")]
        sums = {w: sum(mean[w][k] for k in keys) for w in mean}
        every = " ".join(f"{w} {sum(r[k] for k in keys):.4f}" for w, r in runs)
        print(f"{group} all {len(keys)} sites bf16: parent {sums['parent']:.4f} ms, this "
              f"{sums['this']:.4f} ms, this/parent {sums['this'] / sums['parent']:.3f} "
              f"(limit {limit:g}; runs: {every}) [{tag}]")
        ok &= sums["this"] < limit * sums["parent"]
    if a.out:
        with open(a.out, "w") as f:
            json.dump({"card": tag, "runs": runs}, f, indent=2)
    if not ok:
        raise SystemExit("compare_parent: a group of this tree is above its limit")
    return mean


if __name__ == "__main__":
    main()
