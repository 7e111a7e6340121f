"""Stable Diffusion 2.x's text-conditional U-Net: openaimodel's ``UNetModel``
with spatial transformers (Stability-AI/stablediffusion,
``ldm/modules/diffusionmodules/openaimodel.py`` and ``ldm/modules/attention.py``),
as ``configs/stable-diffusion/v2-inference-v.yaml`` sets it: 320 channels x
1/2/4/4, two ResBlocks a level, a SpatialTransformer after each ResBlock of
the levels whose downsampling factor is in ``attention_resolutions`` and in
the middle block, heads of 64 channels, cross-attention to a (B, 77, 1024)
context, linear ``proj_in`` / ``proj_out``.

* ResBlock: GroupNorm(32) -> SiLU -> 3x3 conv, the projected time embedding
  added, GroupNorm(32) -> SiLU -> (dropout) -> 3x3 conv, plus the input (a
  1x1 ``skip_connection`` where the width changes).
* SpatialTransformer: GroupNorm(32, eps 1e-6) -> linear ``proj_in`` -> per
  block x + attn1(LN x) (self), x + attn2(LN x, context) (cross),
  x + ff(LN x) (GEGLU at 4x, exact GELU) -> linear ``proj_out`` -> + input.
* Downsampling a stride-2 3x3 conv (``op``); upsampling nearest 2x then a
  3x3 conv; the decoder concatenates the mirrored encoder output.
* Timestep embedding: [cos | sin] of t * 10000^(-i / half) (cos first,
  denominator ``half``), Linear -> SiLU -> Linear to 4 x 320.

Submodules carry the released checkpoint's names under
``model.diffusion_model.`` (``input_blocks.1.1.transformer_blocks.0.attn2.
to_k.weight``, ``middle_block.0.in_layers.0.weight``, ``out.2.bias``...), so
its weights load with ``load_state_dict(strict=True)`` once that prefix is
taken off.

Layout and types as in ``models/unet.py``: ``forward`` takes and returns
NHWC; inside, an NHWC tensor's ``.permute(0, 3, 1, 2)`` is a channels_last
NCHW tensor, and a transformer takes its (B, N, C) view with no copy.  The
parameters stay fp32 and are cast to the compute ``dtype`` at each use;
GroupNorms are ``models/unet.py::GroupNorm`` (one hand-written pass for bf16
on a card outside autograd, the SiLU after it in the same pass); LayerNorms
keep their statistics in fp32 (PyTorch's kernels accumulate bf16 in fp32);
attention is ``ops/attention.py::softmax_attention``.  The output is fp32.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tpu_torch.models.unet import Conv2d, GroupNorm, Linear
from ldm_tpu_torch.ops.attention import softmax_attention


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0
                       ) -> torch.Tensor:
    """openaimodel's sinusoidal embedding, fp32: [cos | sin] of
    t * max_period^(-i / half), i < half."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm in its input's type, the affine cast per call; the
    statistics accumulate in fp32 inside PyTorch's kernel."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class ResBlock(nn.Module):
    """openaimodel's ResBlock without scale-shift norm."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(32, channels, eps=1e-5), nn.SiLU(),
                                       Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(emb_channels, out_channels))
        self.out_layers = nn.Sequential(GroupNorm(32, out_channels, eps=1e-5), nn.SiLU(),
                                        nn.Dropout(0.0),
                                        Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Identity() if out_channels == channels
                                else Conv2d(channels, out_channels, 1))

    def forward(self, x: torch.Tensor, emb_silu: torch.Tensor) -> torch.Tensor:
        """``emb_silu``: the time embedding after the SiLU that every block's
        ``emb_layers`` begins with, computed once a forward."""
        norm, _, conv = self.in_layers
        h = conv(norm.forward_silu(x))
        h = h + self.emb_layers[1](emb_silu)[:, :, None, None]
        norm, _, _, conv = self.out_layers
        h = conv(norm.forward_silu(h))
        return self.skip_connection(x) + h


class CrossAttention(nn.Module):
    """Multi-head softmax attention of (B, N, query_dim) tokens over
    themselves (``context_dim`` None) or over a (B, M, context_dim) context."""

    def __init__(self, query_dim: int, context_dim: Optional[int], heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.kind = "self" if context_dim is None else "cross"
        kv_dim = query_dim if context_dim is None else context_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(kv_dim, inner, bias=False)
        self.to_v = Linear(kv_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, query_dim), nn.Dropout(0.0))

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        b, n, _ = x.shape
        ctx = x if context is None else context

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.view(b, t.shape[1], self.heads, self.dim_head).transpose(1, 2)

        out = softmax_attention(heads(self.to_q(x)), heads(self.to_k(ctx)),
                                heads(self.to_v(ctx)), self.kind)
        return self.to_out(out.transpose(1, 2).reshape(b, n, -1))


class GEGLU(nn.Module):
    """x W -> (a, gate) halves -> a * GELU(gate), the exact GELU."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = Linear(dim_in, dim_out * 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, gate = self.proj(x).chunk(2, dim=-1)
        return a * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.Sequential(GEGLU(dim, inner), nn.Dropout(0.0), Linear(inner, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, context_dim: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, None, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1, self.norm2, self.norm3 = (LayerNorm(dim) for _ in range(3))

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), context) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    """The (B, C, H, W) grid as H*W tokens through ``depth`` transformer
    blocks, linear projections in and out, plus the input."""

    def __init__(self, channels: int, heads: int, dim_head: int, context_dim: int,
                 depth: int = 1):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(32, channels, eps=1e-6)
        self.proj_in = Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.proj_out = Linear(channels, inner)  # the source's (in, inner): equal widths

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.proj_in(self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c))
        for block in self.transformer_blocks:
            h = block(h, context)
        h = self.proj_out(h)
        return x + h.view(b, hh, ww, c).permute(0, 3, 1, 2)


class Downsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class TimestepEmbedSequential(nn.Sequential):
    """A block of layers, each handed what it takes: a ResBlock the time
    embedding, a SpatialTransformer the context."""

    def forward(self, x: torch.Tensor, emb_silu: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb_silu)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, context)
            else:
                x = layer(x)
        return x


class SDUNet(nn.Module):
    """openaimodel's ``UNetModel`` with spatial transformers (the source
    config's ``unet_config.params``), plus ``parameterization`` (what the
    output predicts: "eps" or "v", the source's ``model.params`` key), the
    compute ``dtype`` and the ``device`` to build on.

    ``forward(x, t, context)``: x (B, H, W, in_channels) NHWC, t (B,) int
    steps, context (B, M, context_dim); returns (B, H, W, out_channels) fp32.
    """

    def __init__(self, in_channels: int = 4, out_channels: int = 4, model_channels: int = 320,
                 channel_mult: Sequence[int] = (1, 2, 4, 4), num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (4, 2, 1), num_head_channels: int = 64,
                 transformer_depth: int = 1, context_dim: int = 1024,
                 use_linear_in_transformer: bool = True, parameterization: str = "eps",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        if not use_linear_in_transformer:
            raise ValueError("only the linear proj_in / proj_out of SD 2.x is implemented")
        self.dtype = dtype
        self.parameterization = parameterization
        self.model_channels = model_channels
        emb = 4 * model_channels

        def transformer(ch: int) -> SpatialTransformer:
            return SpatialTransformer(ch, ch // num_head_channels, num_head_channels,
                                      context_dim, transformer_depth)

        self.time_embed = nn.Sequential(Linear(model_channels, emb), nn.SiLU(),
                                        Linear(emb, emb))
        self.input_blocks = nn.ModuleList([TimestepEmbedSequential(
            Conv2d(in_channels, model_channels, 3, padding=1))])
        skips: List[int] = [model_channels]
        ch, ds = model_channels, 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [ResBlock(ch, emb, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_resolutions:
                    layers.append(transformer(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(Downsample(ch)))
                skips.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(ResBlock(ch, emb, ch), transformer(ch),
                                                    ResBlock(ch, emb, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [ResBlock(ch + skips.pop(), emb, model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_resolutions:
                    layers.append(transformer(ch))
                if level and i == num_res_blocks:
                    layers.append(Upsample(ch))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(GroupNorm(32, ch, eps=1e-5), nn.SiLU(),
                                 Conv2d(model_channels, out_channels, 3, padding=1))
        if device is not None:
            self.to(device)

    def forward(self, x: torch.Tensor, t: torch.Tensor, context: torch.Tensor
                ) -> torch.Tensor:
        cd = self.dtype
        t_emb = timestep_embedding(t, self.model_channels).to(cd)
        emb_silu = F.silu(self.time_embed(t_emb))
        context = context.to(cd)
        h = x.to(cd).permute(0, 3, 1, 2)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb_silu, context)
            hs.append(h)
        h = self.middle_block(h, emb_silu, context)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb_silu, context)
        norm, _, conv = self.out
        return conv(norm.forward_silu(h)).permute(0, 2, 3, 1).to(torch.float32)
