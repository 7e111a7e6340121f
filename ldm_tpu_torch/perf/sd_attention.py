"""Stable Diffusion's attention sites on the card: which fused kernel
``ops/attention.py::softmax_attention`` runs at each, its time against the
site's bound, and its gap from the plain version.

    python -m ldm_tpu_torch.perf.sd_attention [--config configs/sd21_v_768.yaml]
        [--batch 16] [--out rows.json]

The sites come from one forward of the configuration's U-Net on the meta
device (every distinct (kind, N, M, heads, d) and how often a forward calls
it).  Each is run at ``--batch`` (the sampler's 2B) in bf16: the kernels'
names from the profiler, the time by CUDA-graph replay, the bound (the
larger of 4 N M d a head over 989 TFLOP/s and q, k, v and the output in
bf16 over 3.35 TB/s), and at batch 2 the largest gap from the plain
version over the output's largest magnitude.  One JSON line a site.
"""

from __future__ import annotations

import argparse
import collections
import json

import torch

from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.models import sd_unet
from ldm_tpu_torch.ops import attention
from ldm_tpu_torch.perf.common import card, cuda_graph_ms, require_cuda

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def sites(config, side: int, context_len: int) -> collections.Counter:
    """(kind, N, M, heads, d) of every attention call of one forward, with
    how often, from a forward on the meta device."""
    seen = collections.Counter()
    inner = sd_unet.softmax_attention

    def record(q, k, v, kind):
        seen[(kind, q.shape[2], k.shape[2], q.shape[1], q.shape[3])] += 1
        return inner(q, k, v, kind)

    with torch.device("meta"):
        model = build_model(config)
    p = config.model.params
    sd_unet.softmax_attention = record
    try:
        with torch.no_grad():
            model(torch.zeros(1, side, side, p["in_channels"], device="meta"),
                  torch.zeros(1, dtype=torch.int64, device="meta"),
                  torch.zeros(1, context_len, p["context_dim"], device="meta"))
    finally:
        sd_unet.softmax_attention = inner
    return seen


def kernel_names(fn) -> list:
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type.name == "CUDA"})


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m ldm_tpu_torch.perf.sd_attention")
    ap.add_argument("--config", default="configs/sd21_v_768.yaml")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--context-len", type=int, default=77)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    dev = require_cuda("sd_attention")
    tag = card()
    config = load_config(args.config)
    ae = config.autoencoder.params
    side = config.data.image_size // 2 ** (len(ae["channel_multipliers"]) - 1)
    rows = []
    g = torch.Generator(device=dev).manual_seed(0)
    for (kind, n, m, h, d), calls in sorted(sites(config, side, args.context_len).items()):
        def make(b):
            return [torch.randn(b, h, s, d, generator=g, device=dev, dtype=torch.bfloat16)
                    for s in (n, m, m)]
        q, k, v = make(args.batch)
        names = kernel_names(lambda: attention.softmax_attention(q, k, v, kind))
        ms = cuda_graph_ms(lambda: attention.softmax_attention(q, k, v, kind))
        flops = 4.0 * n * m * d * h * args.batch
        nbytes = 2.0 * args.batch * h * d * (2 * n + 2 * m)
        bound = max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3
        q2, k2, v2 = make(2)
        fused = attention.softmax_attention(q2, k2, v2, kind).float()
        plain = attention.softmax_attention_torch(q2, k2, v2).float()
        row = {"kind": kind, "n": n, "m": m, "heads": h, "d": d, "calls": calls,
               "batch": args.batch, "kernels": names, "ms": ms, "bound_ms": bound,
               "bound_by": "flops" if flops / PEAK_FLOPS > nbytes / PEAK_BYTES else "bytes",
               "roofline_pct": 100.0 * bound / ms,
               "max_gap": ((fused - plain).abs().max() / plain.abs().max()).item(),
               "card": tag}
        rows.append(row)
        print(json.dumps(row), flush=True)
    total = sum(r["ms"] * r["calls"] for r in rows)
    bound = sum(r["bound_ms"] * r["calls"] for r in rows)
    print(json.dumps({"forward_attention_ms": total, "bound_ms": bound,
                      "roofline_pct": 100.0 * bound / total, "card": tag}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
