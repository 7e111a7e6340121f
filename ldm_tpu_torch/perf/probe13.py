"""Probe 13: the fused ResNet-block kernel against its plain version at the
four UNet site shapes of the JAX package's perf/probe13.py (2B=256, bf16).

    python -m ldm_tpu_torch.perf.probe13 [--out rows.json] [--iters 20]

For each site: the kernel's output against the plain version's (``rel_err``
= max |kernel - plain| / max |plain|; the two round bf16 at different
points, see ops/resnet_block.py) and both timed by CUDA-graph replay (device
time: the kernel's three launches are shorter than their launch from
Python).  The TPU
probe's sweep of items per grid program is TPU tiling and has no
counterpart.  Prints one line a site and returns the rows; writes them as
JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.ops.resnet_block import LIB, resnet_block, resnet_block_torch
from ldm_tpu_torch.perf.common import card, cuda_graph_ms, require_cuda
from ldm_tpu_torch.utils import launches

B = 256
DT = torch.bfloat16
GROUPS = 8

# (name, side, C_in, C_out)
SITES = [
    ("encL0_32x32_64to64", 32, 64, 64),
    ("decL0_32x32_128to64", 32, 128, 64),
    ("encL1_16x16_64to128", 16, 64, 128),
    ("decL1_16x16_192to64", 16, 192, 64),
]


# (site, side, C_in, C_out) of the 11 ResNet blocks of the 32px flagship UNet
# (64 channels, multipliers 1/2/4/8); the head block has no time MLP
UNET_SITES = [
    ("enc0", 32, 64, 64), ("enc1", 16, 64, 128), ("enc2", 8, 128, 256),
    ("enc3", 4, 256, 512), ("mid0", 2, 512, 512), ("mid1", 2, 512, 512),
    ("dec0", 4, 768, 256), ("dec1", 8, 384, 128), ("dec2", 16, 192, 64),
    ("dec3", 32, 128, 64), ("head", 32, 64, 64),
]


def site_args(b: int, side: int, cin: int, cout: int, dtype: torch.dtype,
              device, seed: int = 1):
    """The block's arguments at one site, made with numpy from a seed (the
    JAX probe's recipe): x in ``dtype``, everything else fp32; the (1, 1)
    dummies for ws / bs when C_in == C_out.  Returns (args, use_shortcut)."""
    rng = np.random.RandomState(seed)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device, dt)

    use_sc = cin != cout
    args = (
        t(rng.randn(b, side, side, cin) * 0.5, dtype),
        t(rng.randn(b, cout) * 0.1),
        t(1 + 0.1 * rng.randn(cin)), t(0.1 * rng.randn(cin)),
        t(rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)), t(0.1 * rng.randn(cout)),
        t(1 + 0.1 * rng.randn(cout)), t(0.1 * rng.randn(cout)),
        t(rng.randn(3, 3, cout, cout) / np.sqrt(9 * cout)), t(0.1 * rng.randn(cout)),
        t(rng.randn(cin, cout) / np.sqrt(cin)) if use_sc else t(np.zeros((1, 1))),
        t(0.1 * rng.randn(cout)) if use_sc else t(np.zeros((1, 1))),
    )
    return args, use_sc


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows here as JSON")
    ap.add_argument("--iters", type=int, default=20, help="launches per timing")
    a = ap.parse_args(argv)
    dev = require_cuda("probe13")
    tag = card()
    rows = []
    for name, side, cin, cout in SITES:
        args, use_sc = site_args(B, side, cin, cout, DT, dev)
        kw = dict(groups=GROUPS, compute_dtype=DT, use_shortcut=use_sc)
        before = launches.read(LIB.name)
        with torch.inference_mode():
            got = resnet_block(*args, **kw).float()
            want = resnet_block_torch(*args, **kw).float()
            err = ((got - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()
            k_ms = cuda_graph_ms(lambda: resnet_block(*args, **kw), iters=a.iters)
            p_ms = cuda_graph_ms(lambda: resnet_block_torch(*args, **kw), iters=a.iters)
        row = {"site": name, "b": B, "dtype": "bfloat16", "kernel_ms": k_ms,
               "plain_ms": p_ms, "rel_err": err,
               "launches": launches.read(LIB.name) - before, "card": tag}
        rows.append(row)
        print(f"probe13 {name} 2B={B} bf16: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
              f"kernel/plain {k_ms / p_ms:.2f}, rel_err {err:.2e} [{tag}]", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
