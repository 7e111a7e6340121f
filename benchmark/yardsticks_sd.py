"""The frozen yardsticks of the text-to-image cell, beside ``yardsticks.py``'s
peaks and counts:

* ``sd_forward_flops``: PyTorch's ``FlopCounterMode`` over the plain
  reference U-Net (``reference/sd_unet.py``) on the meta device: the products
  of convolutions, linear layers and both attention products, 2 operations a
  multiply-add.  Norms, softmax and elementwise work are not counted.
* ``attention_bound_s``: the least time of one softmax attention call at
  (batch, kind, N, M, heads, d): the larger of its products, 4 N M d a head
  (q k^T and the weights times v) over the bf16 peak, and its bytes, q, k, v
  and the output each moved once in bf16, over the memory rate.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch

from benchmark.reference.sd_unet import RefSDUNet, param_shapes
from benchmark.yardsticks import META, bound_s, count_flops

BF16_BYTES = 2


def sd_forward_flops(p: dict, batch: int, latent_shape, context_len: int) -> float:
    model = RefSDUNet({k: torch.empty(s, device=META) for k, s in param_shapes(p).items()}, p)
    x = torch.zeros((batch, *latent_shape), device=META)
    t = torch.zeros((batch,), dtype=torch.int64, device=META)
    ctx = torch.zeros((batch, context_len, p["context_dim"]), device=META)
    return count_flops(lambda: model(x, t, ctx))


def attention_bound_s(batch: int, n: int, m: int, heads: int, d: int) -> float:
    flops = 4.0 * n * m * d * heads * batch
    nbytes = BF16_BYTES * batch * heads * d * (2 * n + 2 * m)
    return bound_s(nbytes, flops)


def sites_bound_s(batch: int, sites: Iterable[Tuple[str, int, int, int, int]]) -> float:
    """Every site of ``reference/sd_unet.py::attention_sites`` at ``batch``."""
    return sum(attention_bound_s(batch, n, m, h, d) for _, n, m, h, d in sites)
