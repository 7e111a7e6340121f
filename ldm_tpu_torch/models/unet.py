"""Class- and time-conditional U-Net noise predictor (PyTorch port of
ldm_tpu/models/unet.py).

Same architecture: 3x3 stem conv -> 4-level encoder (ResNet block -> linear
attention -> 2x2 max-pool, skips collected pre-pool) -> bottleneck (ResNet ->
full attention -> ResNet) -> decoder (2x2 transposed conv -> concat skip ->
ResNet block -> linear attention) -> final ResNet block + 1x1 conv.

Submodules carry the reference layout's names (``encoder.downs.{i}.1.fn.fn
.to_qkv.weight``, ``decoder.ups.{i}.2.weight``, ``label_emb.weight``...), the
layout that ``ldm_tpu.utils.torch_export.unet_state_dict_from_params`` emits,
so flax weights and ``scripts/export_torch_checkpoint.py`` files load with
``load_state_dict(strict=True)``.

Layout: the public ``forward`` takes and returns NHWC, like the JAX package.
Inside, an NHWC tensor's ``.permute(0, 3, 1, 2)`` is a channels_last NCHW
tensor with no copy; convs, pools and transposed convs run on it, and each
attention site takes its (B, N, C) view with ``.permute(0, 2, 3, 1)``.

Types: parameters stay fp32 and are cast to the compute ``dtype`` at each
use, as flax's ``dtype=`` does; GroupNorm statistics are fp32 with the output
in the compute type; the input is cast to the compute type after the
conditioning and the output back to fp32, at the JAX package's points.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tpu_torch.ops.linear_attention import (
    linear_attention_block,
    linear_attention_block_torch,
)

_CL = torch.channels_last


class Linear(nn.Linear):
    """nn.Linear computing in its input's dtype (fp32 parameters cast per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), b)


class Conv2d(nn.Conv2d):
    """nn.Conv2d computing in its input's dtype (fp32 parameters cast per call)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d computing in its input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv_transpose2d(
            x, self.weight.to(x.dtype), self.bias.to(x.dtype), self.stride
        )


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics and affine, output in the input's dtype
    and in channels_last (flax nn.GroupNorm with ``dtype=``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float(), self.num_groups, self.weight, self.bias, self.eps)
        return y.to(x.dtype, memory_format=_CL)


class SinusoidalPosEmb(nn.Module):
    """Sinusoidal timestep embedding; the frequency denominator is half - 1."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freq = torch.exp(
            torch.arange(half, dtype=torch.float32, device=t.device)
            * -(math.log(10000.0) / (half - 1))
        )
        ang = t.to(torch.float32)[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class TimeEmbedding(nn.Module):
    """SinPos -> Linear -> exact (erf) GELU -> Linear."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(n_channels // 4),
            Linear(n_channels // 4, n_channels),
            nn.GELU(approximate="none"),
            Linear(n_channels, n_channels),
        )

    def forward(self, t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        pos, lin1, gelu, lin2 = self.time_mlp
        return lin2(gelu(lin1(pos(t).to(dtype))))


class Block(nn.Module):
    """GroupNorm(8) -> SiLU -> 3x3 conv."""

    def __init__(self, dim: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.norm = GroupNorm(groups, dim, eps=1e-5)
        self.conv2d = Conv2d(dim, dim_out, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2d(F.silu(self.norm(x)))


class ResNetBlock(nn.Module):
    """Two Blocks with the time embedding added in between + 1x1 shortcut.

    ``time_emb_dim=None`` builds no time MLP (the final head block).
    """

    def __init__(self, dim: int, dim_out: int, time_emb_dim: Optional[int] = None,
                 groups: int = 8):
        super().__init__()
        self.block1 = Block(dim, dim_out, groups)
        self.mlp_t = (
            nn.Sequential(nn.SiLU(), Linear(time_emb_dim, dim_out))
            if time_emb_dim is not None else None
        )
        self.block2 = Block(dim_out, dim_out, groups)
        self.shortcut = Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x: torch.Tensor, time_emb: Optional[torch.Tensor] = None):
        h = self.block1(x)
        if time_emb is not None:
            h = h + self.mlp_t(time_emb)[:, :, None, None]
        h = self.block2(h)
        return h + self.shortcut(x)


class PreNorm(nn.Module):
    """``fn(GroupNorm_1(x))``."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = GroupNorm(1, dim, eps=1e-5)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


class Residual(nn.Module):
    """``x + fn(x)``."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x)


class Attention(nn.Module):
    """Full softmax self-attention over the spatial grid, 4 heads x 32; used
    only in the bottleneck.  The 1x1 convs are applied as matmuls on the NHWC
    view."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n = hh * ww
        cd = x.dtype
        xs = x.permute(0, 2, 3, 1).reshape(b, n, c)
        qkv = xs @ self.to_qkv.weight.view(-1, c).t().to(cd)
        q, k, v = (
            t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
            for t in qkv.chunk(3, dim=-1)
        )
        q = q * (self.dim_head**-0.5)
        sim = (q @ k.transpose(-1, -2)).to(torch.float32)
        sim = sim - sim.amax(dim=-1, keepdim=True)
        attn = torch.softmax(sim, dim=-1).to(cd)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        w_out = self.to_out.weight.view(c, -1).t().to(cd)
        out = out @ w_out + self.to_out.bias.to(cd)
        return out.view(b, hh, ww, c).permute(0, 3, 1, 2)


class LinearAttention(nn.Module):
    """Parameters of the per-level linear attention in the reference layout:
    ``to_qkv`` (1x1 conv, no bias) and ``to_out`` (1x1 conv, GroupNorm(1)).
    :class:`LinAttnBlock` runs them, with its pre-norm, as one fused op."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), nn.GroupNorm(1, dim))


class LinAttnBlock(Residual):
    """The whole per-level block, Residual(PreNorm(LinearAttention)), as ONE op.

    ``impl=None`` runs :func:`linear_attention_block` (the Hopper kernel on a
    CUDA tensor, the plain version on a CPU tensor); ``impl="torch"`` runs the
    plain version on any device.
    """

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 impl: Optional[str] = None):
        super().__init__(PreNorm(dim, LinearAttention(dim, heads, dim_head)))
        if impl not in (None, "torch"):
            raise ValueError(f"attention impl must be None or 'torch', got {impl!r}")
        self.heads, self.dim_head, self.impl = heads, dim_head, impl
        self._kernel_w_key, self._kernel_w = None, None

    def kernel_weights(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The (3H, C, 1, 1) / (C, H, 1, 1) conv weights as the kernel reads
        them, row-major (C, 3H) / (H, C).  The copies are made once and again
        only when a weight changes (load_state_dict and in-place updates bump
        its version) or moves, not on every call of the sampler's loop."""
        wq, wo = self.fn.fn.to_qkv.weight, self.fn.fn.to_out[0].weight
        key = (wq.data_ptr(), wq._version, wo.data_ptr(), wo._version)
        if key != self._kernel_w_key:
            c = wo.shape[0]
            with torch.no_grad():
                self._kernel_w = (wq.view(-1, c).t().contiguous(),
                                  wo.view(c, -1).t().contiguous())
            self._kernel_w_key = key
        return self._kernel_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        pre, attn = self.fn.norm, self.fn.fn
        out_conv, out_norm = attn.to_out
        if self.impl is None and x.is_cuda:
            op = linear_attention_block
            wqkv, wout = self.kernel_weights()
        else:
            # the plain version takes the weights as views, so autograd sees them
            op = linear_attention_block_torch
            wqkv, wout = attn.to_qkv.weight.view(-1, c).t(), out_conv.weight.view(c, -1).t()
        y = op(
            x.permute(0, 2, 3, 1).reshape(b, hh * ww, c).contiguous(),
            wqkv, wout, out_conv.bias, pre.weight, pre.bias,
            out_norm.weight, out_norm.bias,
            heads=self.heads, dim_head=self.dim_head, eps=1e-5,
            compute_dtype=x.dtype,
        )
        return y.view(b, hh, ww, c).permute(0, 3, 1, 2)


class UNet(nn.Module):
    """The noise-prediction U-Net.

    Constructor surface matches the config schema (in_channels, out_channels,
    channels, channel_multipliers, with_time_emb, num_classes) plus the
    compute ``dtype``, the attention ``attention_impl`` (None or "torch"), the
    ``bottleneck_time_emb`` flag and the ``device`` to build on.
    """

    def __init__(
        self,
        in_channels: int = 1,
        out_channels: int = 1,
        channels: int = 64,
        channel_multipliers: Sequence[int] = (1, 2, 4, 8),
        with_time_emb: bool = True,
        num_classes: Optional[int] = None,
        dtype: torch.dtype = torch.float32,
        attention_impl: Optional[str] = None,
        bottleneck_time_emb: bool = True,
        device=None,
    ):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.bottleneck_time_emb = bottleneck_time_emb
        chs: List[int] = [channels] + [channels * m for m in channel_multipliers]
        d_time = channels * 4 if with_time_emb else None

        self.time_emb = TimeEmbedding(d_time) if with_time_emb else None
        self.label_emb = (
            nn.Embedding(num_classes, d_time)
            if with_time_emb and num_classes is not None else None
        )
        self.initial_conv = Conv2d(in_channels, channels, 3, padding=1)

        self.encoder = nn.Module()
        self.encoder.downs = nn.ModuleList()
        dim = channels
        for dim_out in chs[1:]:
            self.encoder.downs.append(nn.ModuleList([
                ResNetBlock(dim, dim_out, d_time),
                LinAttnBlock(dim_out, impl=attention_impl),
                nn.MaxPool2d(2),
            ]))
            dim = dim_out

        # the reference's bottleneck blocks always own a time MLP; it is used
        # only with bottleneck_time_emb (the bridge emits zeros otherwise)
        self.bottleneck = nn.Module()
        self.bottleneck.res1 = ResNetBlock(dim, dim, d_time)
        self.bottleneck.attn = Residual(PreNorm(dim, Attention(dim)))
        self.bottleneck.res2 = ResNetBlock(dim, dim, d_time)

        # decoder output ladder [4c, 2c, c, c]: transposed conv to dim_out,
        # concat the skip of the mirrored encoder level, ResNet -> dim_out
        self.decoder = nn.Module()
        self.decoder.ups = nn.ModuleList()
        skips = chs[1:]
        for i, dim_out in enumerate(list(reversed(chs[1:-1])) + [chs[0]]):
            skip = skips[-1 - i]
            self.decoder.ups.append(nn.ModuleList([
                ResNetBlock(dim_out + skip, dim_out, d_time),
                LinAttnBlock(dim_out, impl=attention_impl),
                ConvTranspose2d(dim, dim_out, 2, stride=2),
            ]))
            dim = dim_out

        # head: the final block has no time MLP
        self.final_conv = nn.Sequential(
            ResNetBlock(dim, channels), Conv2d(channels, out_channels, 1)
        )
        if device is not None:
            self.to(device)

    @property
    def null_label(self) -> int:
        """Label id reserved for the unconditional pass (embeds to exactly zero)."""
        if self.num_classes is None:
            raise ValueError("an unconditional UNet has no null label")
        return self.num_classes

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C) NHWC; t: (B,) int steps; y: (B,) int labels or None.
        Returns the eps prediction, (B, H, W, out_channels) float32."""
        cd = self.dtype
        t_emb = None
        if self.time_emb is not None:
            t_emb = self.time_emb(t, cd)
            if self.label_emb is not None and y is not None:
                is_null = y >= self.num_classes
                safe_y = torch.where(is_null, torch.zeros_like(y), y)
                lab = self.label_emb.weight.to(cd)[safe_y]
                t_emb = t_emb + lab * (1.0 - is_null.to(cd))[:, None]

        h = self.initial_conv(x.to(cd).permute(0, 3, 1, 2))

        skips: List[torch.Tensor] = []
        for res, attn, pool in self.encoder.downs:
            h = attn(res(h, t_emb))
            skips.append(h)
            h = pool(h)

        bt = t_emb if self.bottleneck_time_emb else None
        h = self.bottleneck.res1(h, bt)
        h = self.bottleneck.attn(h)
        h = self.bottleneck.res2(h, bt)

        for res, attn, up in self.decoder.ups:
            h = torch.cat([up(h), skips.pop()], dim=1)
            h = attn(res(h, t_emb))

        res, conv = self.final_conv
        h = conv(res(h))
        return h.permute(0, 2, 3, 1).to(torch.float32)
