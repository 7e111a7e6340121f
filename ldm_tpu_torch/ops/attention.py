"""Softmax attention over heads: the fused kernels PyTorch ships on a card,
or the plain matmul-softmax.

:func:`softmax_attention` takes q (B, H, N, d) and k, v (B, H, M, d) and
returns softmax(q k^T / sqrt(d)) v, (B, H, N, d), in q's type.  One function
serves self-attention (M = N) and cross-attention (k and v from a context):
``kind`` says which, for the call counter alone.

* A bf16 or fp16 CUDA tensor runs ``F.scaled_dot_product_attention`` with
  only the flash and cuDNN back-ends allowed (:data:`FUSED`): a fused kernel
  or an error, never the math path, which would hold the whole score matrix
  (27 GB in fp32 at 9,216 tokens, 5 heads and 2B = 16).  Both keep the
  logits and the softmax in fp32 over bf16 products with fp32 accumulation,
  and round the weights to the input's type before the product with v.
* Everything else (the CPU, fp32, the meta device) runs
  :func:`softmax_attention_torch`: the same numerics in plain PyTorch, in
  blocks of queries so that the scores of one block stay under
  :data:`BLOCK_ELEMENTS` elements.

The calls are counted by kind as ``softmax_attention.self`` and
``softmax_attention.cross`` (``utils/launches.py``; a replayed CUDA graph
adds its capture's).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ldm_tpu_torch.utils import launches

KINDS = ("self", "cross")
# score elements of one block of queries in the plain version (1 GiB in fp32)
BLOCK_ELEMENTS = 1 << 28


def _fused_backends():
    from torch.nn.attention import SDPBackend

    return [SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION]


def takes_fused(q: torch.Tensor) -> bool:
    """Whether :func:`softmax_attention` runs the fused kernels on ``q``: a
    half-precision CUDA tensor."""
    return q.is_cuda and q.dtype in (torch.bfloat16, torch.float16)


def softmax_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                            ) -> torch.Tensor:
    """The plain version: fp32 logits of q's and k's values, an fp32
    softmax, the weights rounded to q's type, then the product with v; in
    blocks of queries."""
    b, h, n, d = q.shape
    m = k.shape[2]
    scale = d ** -0.5
    kt = k.to(torch.float32).transpose(-1, -2)
    step = max(1, min(n, BLOCK_ELEMENTS // max(1, b * h * m)))
    out = []
    for i in range(0, n, step):
        sim = (q[:, :, i:i + step].to(torch.float32) @ kt) * scale
        out.append(torch.softmax(sim, dim=-1).to(q.dtype) @ v)
    return out[0] if len(out) == 1 else torch.cat(out, dim=2)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      kind: str) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over (B, H, N, d) q and (B, H, M, d) k, v;
    ``kind`` "self" or "cross"."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    launches.count(f"softmax_attention.{kind}")
    if not takes_fused(q):
        return softmax_attention_torch(q, k, v)
    from torch.nn.attention import sdpa_kernel

    with sdpa_kernel(_fused_backends()):
        return F.scaled_dot_product_attention(q, k, v)

