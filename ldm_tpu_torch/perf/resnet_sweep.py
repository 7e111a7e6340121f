"""The ResNet-block kernel under the plans a site allows, and by launch.

    python -m ldm_tpu_torch.perf.resnet_sweep [--sites enc3 mid0 ...] [--out rows.json]

At the 11 ResNet sites of the 32px flagship UNet, 2B=128 and 2B=20, bf16:

* the block's time with 1, 2, 4 and 8 CTAs sharing an output tile (both convs
  alike), the split ``plan_resnet`` picks marked, by CUDA-graph replay;
* the device time of each of the block's three launches (prep, conv1, conv2)
  under the picked plan, from ``torch.profiler``.

Run it before changing ``ops/resnet_block.py::_split``.  Needs the card.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

import torch
from torch.profiler import ProfilerActivity, profile

from ldm_tpu_torch.ops import resnet_block as rb
from ldm_tpu_torch.perf.common import card, cuda_graph_ms, require_cuda
from ldm_tpu_torch.perf.probe13 import GROUPS, UNET_SITES, site_args

DT = torch.bfloat16
SPLITS = (1, 2, 4, 8)


def launch_us(fn, iters: int = 10) -> dict:
    """Mean device time in microseconds of each of the block's kernels over
    `iters` calls of fn, by the launch's name."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "resnet" not in e.key:
            continue
        name = "prep" if "prep" in e.key else ("conv2" if "true" in e.key else "conv1")
        out[name] = e.device_time_total / e.count
    return out


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", nargs="*", help="site names (default: all 11)")
    ap.add_argument("--out", help="write the rows here as JSON")
    a = ap.parse_args(argv)
    dev = require_cuda("resnet_sweep")
    tag = card()
    rows = []
    for b in (128, 20):
        for site, side, cin, cout in UNET_SITES:
            if a.sites and site not in a.sites:
                continue
            args, use_sc = site_args(b, side, cin, cout, DT, dev)
            kw = dict(groups=GROUPS, compute_dtype=DT, use_shortcut=use_sc)
            picked = rb.plan_resnet(b, side, side, cin, cout, DT, groups=GROUPS)
            ms = {}
            with torch.inference_mode():
                for split in SPLITS:
                    plan = rb.plan_resnet(b, side, side, cin, cout, DT, groups=GROUPS,
                                          split=split)
                    ms[split] = cuda_graph_ms(lambda: rb.resnet_block_cuda(*args, plan=plan, **kw))
                ms["picked"] = cuda_graph_ms(lambda: rb.resnet_block_cuda(*args, **kw))
                us = launch_us(lambda: rb.resnet_block_cuda(*args, **kw))
            rows.append({"site": site, "b": b, "split1": picked.split1, "split2": picked.split2,
                         "ms_by_split": ms, "launch_us": us, "card": tag})
            by_split = ", ".join(f"{k}: {v:.4f}" for k, v in ms.items())
            by_launch = ", ".join(f"{k} {v:.1f}" for k, v in sorted(us.items()))
            print(f"resnet_sweep {site} ({side}x{side}, {cin}->{cout}) 2B={b} bf16: picked "
                  f"split {picked.split1} / {picked.split2}; ms by split {by_split}; us by "
                  f"launch {by_launch} [{tag}]", flush=True)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(rows, f, indent=2)
    return rows


if __name__ == "__main__":
    main()
