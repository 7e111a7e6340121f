"""Where one CTA of the ResNet-block kernel spends its cycles.

    python -m ldm_tpu_torch.perf.resnet_clocks [--sites enc0 mid0 ...]

Builds a copy of ``csrc/resnet_block_fwd.cu`` with ``-DRB_CLOCKS`` into a
temporary directory: thread 0 of the middle CTA of conv1 and of conv2 stamps
``clock64()`` at the ends of its phases (``RB_CLK`` in resnet_block.cuh).
Launches the block at 2B=128 and 2B=20, bf16, holds the output against the
production kernel's bit for bit, and prints the cycles of each phase:
prologue (statistics finished, tables), the first halo tile's fill, the units
(products, with the next tiles' fills between them), the partial tile to
shared memory and the ranks' barrier, this rank's rows added and written,
conv1's statistics.  At 2B=20 most CTAs have their SM alone, at 2B=128 two
share it.  Needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import tempfile
from typing import Optional, Sequence

import torch

from ldm_tpu_torch.ops import build
from ldm_tpu_torch.ops import resnet_block as rb
from ldm_tpu_torch.perf.common import card, require_cuda
from ldm_tpu_torch.perf.probe13 import GROUPS, UNET_SITES, site_args

DT = torch.bfloat16
# the -DRB_CLOCKS build's entry points: the block's, and its stamps (out)
CLOCKED = build.Library("resnet_block_fwd", {
    **rb.LIB.entry_points,
    "ldm_resnet_block_clocks": ([ctypes.POINTER(ctypes.c_longlong)], ctypes.c_int)})
PHASES = ("prologue", "first fill", "units", "tile to shared memory", "rows written",
          "statistics")


def build_clocked(tmp: str) -> ctypes.CDLL:
    lib = f"{tmp}/libresnet_block_clocks.so"
    flags = [f for f in build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    cmd = [build.nvcc(), *flags, "-DRB_CLOCKS", "-o", lib,
           str(build.CSRC / "resnet_block_fwd.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{' '.join(cmd)}\n{r.stdout}\n{r.stderr}")
    return CLOCKED.declare(ctypes.CDLL(lib))


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sites", nargs="*", default=["enc0", "dec3", "enc2", "mid0", "dec0"])
    a = ap.parse_args(argv)
    dev = require_cuda("resnet_clocks")
    tag = card()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        dll = build_clocked(tmp)
        for b in (128, 20):
            for site, side, cin, cout in UNET_SITES:
                if site not in a.sites:
                    continue
                args, use_sc = site_args(b, side, cin, cout, DT, dev)
                kw = dict(groups=GROUPS, compute_dtype=DT, use_shortcut=use_sc)
                with torch.inference_mode():
                    for _ in range(3):
                        y, cargs, _keep = rb.launch_args(args[0], args[1], args[2:10], args[10],
                                                         args[11], eps=1e-5, **kw)
                        err = dll.ldm_resnet_block_fwd(1, *cargs)
                        if err != 0:
                            raise RuntimeError(f"clocked launch failed: CUDA error {err}")
                    torch.cuda.synchronize()
                    if not torch.equal(y, rb.resnet_block(*args, **kw)):
                        raise AssertionError(f"{site}: the clocked kernel's output differs")
                out = (ctypes.c_longlong * 16)()
                if dll.ldm_resnet_block_clocks(out) != 0:
                    raise RuntimeError("reading the stamps failed")
                for conv in (0, 1):
                    t = [out[conv * 8 + k] for k in range(7)]
                    d = dict(zip(PHASES, (t[k + 1] - t[k] for k in range(6))))
                    rows.append({"site": site, "b": b, "conv": conv + 1, "cycles": t[6] - t[0],
                                 "by_phase": d, "card": tag})
                    print(f"resnet_clocks {site} ({side}x{side}, {cin}->{cout}) 2B={b} bf16 "
                          f"conv{conv + 1}: {t[6] - t[0]} cycles; "
                          + ", ".join(f"{k} {v}" for k, v in d.items()) + f" [{tag}]",
                          flush=True)
    return rows


if __name__ == "__main__":
    main()
