"""Explicit spatial parallelism: the UNet with its image rows split over the
mesh's model axis (port of ldm_tpu/parallel/sp_explicit.py).

Every NHWC activation's rows (H) are split over a data row's model
processes, and the forward is written with the collectives placed by hand,
each an autograd function with its exact transpose
(``ops/collectives.py``), so the gradients are the one-process
gradients by construction:

* a 3x3 convolution takes one halo row from each neighbour (zeros at the
  mesh's edges: the convolution's padding) and runs without padding on H,
  with padding 1 on W;
* a GroupNorm's statistics are the fp32 sums and sums of squares of every
  process's rows (one all-reduce), with flax's fast-variance algebra;
* the linear attention stays distributed: its pre- and post-norm take global
  statistics, the k-softmax's shift is a global maximum (no gradient: it
  cancels), and its denominators and the (B, hidden, hidden) context are
  sums over every process's rows, the context masked to the per-head
  blocks.  What a process moves is O(hidden^2), not its rows;
* the bottleneck's softmax attention runs on the rows gathered whole (a few
  positions at 2^-levels of the height) and keeps this process's;
* max-pool, the transposed convolutions, the 1x1 convolutions and the time
  embedding are local.

:class:`SpatialUNet` computes over the UNet's own modules' weights (no
second set), so the trainer's model and EMA each have one.  The attention
launches no kernel here: the fused kernels end with GroupNorm over the
whole item, which a row slice cannot compute without a collective inside.

H must split into even rows on every process at every pooled level,
``H % (model * 2**levels) == 0`` (32 % (2 * 16) == 0 at the flagship):
:func:`supports_spatial_training` says whether it does.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F

from ldm_tpu_torch.ops.collectives import (
    gather_rows_model,
    halo_rows,
    max_model,
    psum_model,
)
from ldm_tpu_torch.ops.linear_attention import block_diag_mask
from ldm_tpu_torch.parallel.mesh import Mesh


def supports_spatial_training(mesh: Optional[Mesh], image_size: int, n_levels: int) -> bool:
    """True when H splits into even rows on every process at every pooled
    level of a UNet with ``n_levels`` levels."""
    if mesh is None:
        return False
    k = mesh.model_size
    return k > 1 and image_size % (k * 2 ** n_levels) == 0


class SpatialUNet:
    """``model``'s forward on this process's rows of the images: ``(x, t, y)``
    with x (B, H/M, W, C) NHWC, the prediction of those rows (fp32)."""

    def __init__(self, mesh: Mesh, model):
        if mesh.model_size < 2:
            raise ValueError("spatial parallelism needs a model axis > 1")
        if model.time_emb is None or model.label_emb is None:
            raise ValueError("spatial parallelism runs the conditional UNet (time and class)")
        self.mesh, self.model = mesh, model
        self.group, self.size = mesh.model_group, mesh.model_size
        self.levels = len(model.encoder.downs)

    @property
    def null_label(self) -> int:
        return self.model.null_label

    # ---------------------------------------------------------------- layers
    def conv3x3(self, conv, x: torch.Tensor) -> torch.Tensor:
        """A 3x3 padding-1 convolution on NCHW row blocks: the halo, then no
        padding on H."""
        b = None if conv.bias is None else conv.bias.to(x.dtype)
        return F.conv2d(halo_rows(x, self.group, 2), conv.weight.to(x.dtype), b,
                        padding=(0, 1))

    def group_norm(self, norm, x: torch.Tensor) -> torch.Tensor:
        """``norm`` (a GroupNorm module) with the statistics of every
        process's rows: fp32 sums and sums of squares, one all-reduce."""
        b, c, hl, w = x.shape
        g = norm.num_groups
        xf = x.float().reshape(b, g, c // g, hl, w)
        sums = psum_model(torch.stack([xf.sum(dim=(2, 3, 4)), (xf * xf).sum(dim=(2, 3, 4))]),
                          self.group)
        n = float(hl * self.size * w * (c // g))
        mean = sums[0] / n
        var = sums[1] / n - mean * mean
        inv = torch.rsqrt(var + norm.eps)
        y = (xf - mean[:, :, None, None, None]) * inv[:, :, None, None, None]
        y = y.reshape(b, c, hl, w) * norm.weight.view(1, c, 1, 1) + norm.bias.view(1, c, 1, 1)
        return y.to(x.dtype)

    def resnet_block(self, block, x: torch.Tensor, temb: Optional[torch.Tensor]) -> torch.Tensor:
        h = self.conv3x3(block.block1.conv2d, F.silu(self.group_norm(block.block1.norm, x)))
        if temb is not None:
            h = h + block.mlp_t(temb)[:, :, None, None]
        h = self.conv3x3(block.block2.conv2d, F.silu(self.group_norm(block.block2.norm, h)))
        return h + block.shortcut(x)

    def linear_attention(self, block, x: torch.Tensor) -> torch.Tensor:
        """A ``LinAttnBlock`` (Residual(PreNorm(LinearAttention)) and its
        post-norm) on row blocks, distributed by the block's associativity
        over positions."""
        b, c, hl, w = x.shape
        n = hl * w
        cd = x.dtype
        pre, attn = block.fn.norm, block.fn.fn
        out_conv, out_norm = attn.to_out
        heads, dh = block.heads, block.dim_head
        hidden = heads * dh
        h = self.group_norm(pre, x).permute(0, 2, 3, 1).reshape(b, n, c)
        q, k, v = (h @ attn.to_qkv.weight.view(-1, c).t().to(cd)).split(hidden, dim=-1)
        # q: a softmax over each head's dim_head, per position
        q = (torch.softmax(q.reshape(b, n, heads, dh).float(), dim=-1) * dh ** -0.5
             ).reshape(b, n, hidden).to(cd)
        # k: a softmax over every process's positions; the shift cancels
        kf = k.float()
        shift = max_model(kf.amax(dim=1), self.group)
        e = torch.exp(kf - shift[:, None, :])
        k = (e / psum_model(e.sum(dim=1), self.group)[:, None, :]).to(cd)
        ctx = psum_model(torch.einsum("bnd,bne->bde", k, v), self.group)
        ctx = ctx * block_diag_mask(heads, dh, cd, x.device)
        ctx_w = torch.einsum("bde,ec->bdc", ctx, out_conv.weight.view(c, -1).t().to(cd))
        out = torch.einsum("bdc,bnd->bnc", ctx_w, q) + out_conv.bias.to(cd)
        out = self.group_norm(out_norm, out.reshape(b, hl, w, c).permute(0, 3, 1, 2))
        return x + out

    def gathered(self, module, x: torch.Tensor) -> torch.Tensor:
        """``module`` on the rows of every process, this process's rows of
        its output."""
        hl = x.shape[2]
        whole = module(gather_rows_model(x, self.group, 2))
        return whole.narrow(2, self.mesh.model_rank * hl, hl)

    # --------------------------------------------------------------- forward
    def __call__(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x: this process's (B, H/M, W, C) rows, NHWC; t: (B,) steps; y: (B,)
        labels.  Returns the prediction of those rows, fp32 NHWC."""
        m = self.model
        if x.shape[1] % 2 ** self.levels:
            raise ValueError(f"spatial parallelism needs even rows at every pooled level: "
                             f"{x.shape[1]} rows a process, {self.levels} levels")
        cd = m.dtype
        t_emb = m.conditioning(t, y)
        h = self.conv3x3(m.initial_conv, x.to(cd).permute(0, 3, 1, 2))

        skips: List[torch.Tensor] = []
        for res, attn, pool in m.encoder.downs:
            h = self.linear_attention(attn, self.resnet_block(res, h, t_emb))
            skips.append(h)
            h = pool(h)

        bt = t_emb if m.bottleneck_time_emb else None
        h = self.resnet_block(m.bottleneck.res1, h, bt)
        h = self.gathered(m.bottleneck.attn, h)
        h = self.resnet_block(m.bottleneck.res2, h, bt)

        for res, attn, up in m.decoder.ups:
            h = torch.cat([up(h), skips.pop()], dim=1)
            h = self.linear_attention(attn, self.resnet_block(res, h, t_emb))

        res, conv = m.final_conv
        h = conv(self.resnet_block(res, h, None))
        return h.permute(0, 2, 3, 1).to(torch.float32)
