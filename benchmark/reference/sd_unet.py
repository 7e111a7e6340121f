"""The plain reference of Stable Diffusion 2.x's text-conditional U-Net
(Stability-AI/stablediffusion ``ldm/modules/diffusionmodules/openaimodel.py``
``UNetModel`` and ``ldm/modules/attention.py`` ``SpatialTransformer``, as
``configs/stable-diffusion/v2-inference-v.yaml`` sets them), in float32 over a
dict of weights.

Written from the published architecture, not from the program: a 3x3 stem;
levels of ResBlocks (GroupNorm(32, eps 1e-5), SiLU, 3x3 convolution, the
projected time embedding added, again with its own norm, a 1x1 skip where
the width changes), a SpatialTransformer after each ResBlock of a level
whose downsampling factor is in ``attention_resolutions``, a stride-2 3x3
convolution after each level but the last; a middle of ResBlock,
SpatialTransformer, ResBlock; the mirrored levels with the encoder's outputs
concatenated, ``num_res_blocks + 1`` ResBlocks each, a nearest 2x upsample
and a 3x3 convolution after each level but the top one; GroupNorm, SiLU and
a 3x3 convolution out.  The time embedding is [cos | sin] of
t * 10000^(-i / half) over ``model_channels``, Linear, SiLU, Linear.

SpatialTransformer: GroupNorm(32, eps 1e-6), a linear ``proj_in``, per block
x + self-attention(LayerNorm x), x + cross-attention(LayerNorm x, context),
x + GEGLU feed-forward at 4x with the exact GELU (each LayerNorm eps 1e-5),
a linear ``proj_out``, plus the input.  Attention: heads of
``num_head_channels``, softmax(q k^T / sqrt(d)) v.

Departures from the source, none of which changes the mathematics:

* the attention is computed in blocks of queries (at most 2^28 scores a
  block), so that 9,216 tokens fit; the source's ``ATTN_PRECISION`` fp32
  logits are what float32 gives here anyway;
* dropout (0 in the source's inference config) and the checkpointing flags
  are left out;
* the weights are the released checkpoint's names under
  ``model.diffusion_model.``, without that prefix.

Images are NHWC at the boundary, NCHW inside.  Every product goes through
an :class:`~benchmark.reference.arith.Arith`.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.arith import Arith

BLOCK_SCORES = 1 << 28


def _levels(p: dict):
    """(level, width, whether it has transformers) of each level."""
    mc = p["model_channels"]
    return [(i, mc * m, 2 ** i in p["attention_resolutions"])
            for i, m in enumerate(p["channel_mult"])]


def param_shapes(p: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the U-Net with parameters ``p`` (the config's
    ``model.params``), by name, in the checkpoint's order."""
    s: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    mc, ctx = p["model_channels"], p["context_dim"]
    emb = 4 * mc
    dh = p["num_head_channels"]

    def conv(name, cin, cout, k):
        s[f"{name}.weight"] = (cout, cin, k, k)
        s[f"{name}.bias"] = (cout,)

    def linear(name, cin, cout, bias=True):
        s[f"{name}.weight"] = (cout, cin)
        if bias:
            s[f"{name}.bias"] = (cout,)

    def norm(name, c):
        s[f"{name}.weight"] = (c,)
        s[f"{name}.bias"] = (c,)

    def resblock(name, cin, cout):
        norm(f"{name}.in_layers.0", cin)
        conv(f"{name}.in_layers.2", cin, cout, 3)
        linear(f"{name}.emb_layers.1", emb, cout)
        norm(f"{name}.out_layers.0", cout)
        conv(f"{name}.out_layers.3", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.skip_connection", cin, cout, 1)

    def transformer(name, c):
        inner = (c // dh) * dh
        norm(f"{name}.norm", c)
        linear(f"{name}.proj_in", c, inner)
        for d in range(p.get("transformer_depth", 1)):
            b = f"{name}.transformer_blocks.{d}"
            for a, kv in (("attn1", inner), ("attn2", ctx)):
                linear(f"{b}.{a}.to_q", inner, inner, bias=False)
                linear(f"{b}.{a}.to_k", kv, inner, bias=False)
                linear(f"{b}.{a}.to_v", kv, inner, bias=False)
                linear(f"{b}.{a}.to_out.0", inner, inner)
                if a == "attn1":
                    linear(f"{b}.ff.net.0.proj", inner, 8 * inner)
                    linear(f"{b}.ff.net.2", 4 * inner, inner)
            for n in ("norm1", "norm2", "norm3"):
                norm(f"{b}.{n}", inner)
        linear(f"{name}.proj_out", c, inner)

    linear("time_embed.0", mc, emb)
    linear("time_embed.2", emb, emb)
    conv("input_blocks.0.0", p["in_channels"], mc, 3)
    skips, ch, k = [mc], mc, 1
    levels = _levels(p)
    for i, width, attn in levels:
        for _ in range(p["num_res_blocks"]):
            resblock(f"input_blocks.{k}.0", ch, width)
            ch = width
            if attn:
                transformer(f"input_blocks.{k}.1", ch)
            skips.append(ch)
            k += 1
        if i != len(levels) - 1:
            conv(f"input_blocks.{k}.0.op", ch, ch, 3)
            skips.append(ch)
            k += 1
    resblock("middle_block.0", ch, ch)
    transformer("middle_block.1", ch)
    resblock("middle_block.2", ch, ch)
    k = 0
    for i, width, attn in reversed(levels):
        for j in range(p["num_res_blocks"] + 1):
            resblock(f"output_blocks.{k}.0", ch + skips.pop(), width)
            ch = width
            if attn:
                transformer(f"output_blocks.{k}.1", ch)
            if i and j == p["num_res_blocks"]:
                conv(f"output_blocks.{k}.{2 if attn else 1}.conv", ch, ch, 3)
            k += 1
    norm("out.0", ch)
    conv("out.2", mc, p["out_channels"], 3)
    return s


def group_norm_scales(p: dict) -> List[str]:
    """The ResBlocks' and the output's GroupNorm scales: the norms whose
    names hold no ``norm``."""
    return [k for k, v in param_shapes(p).items() if len(v) == 1 and
            (k.endswith("in_layers.0.weight") or k.endswith("out_layers.0.weight")
             or k == "out.0.weight")]


def attention_sites(p: dict, side: int, context_len: int) -> List[Tuple[str, int, int, int, int]]:
    """(kind, N, M, heads, d) of every attention call of one forward over a
    ``side`` x ``side`` latent: self-attention over the grid's tokens,
    cross-attention over ``context_len`` context tokens."""
    dh = p["num_head_channels"]
    out = []

    def transformer(ch, res):
        n = res * res
        for _ in range(p.get("transformer_depth", 1)):
            out.append(("self", n, n, ch // dh, dh))
            out.append(("cross", n, context_len, ch // dh, dh))

    res = side
    levels = _levels(p)
    for i, width, attn in levels:
        if attn:
            for _ in range(p["num_res_blocks"]):
                transformer(width, res)
        if i != len(levels) - 1:
            res //= 2
    transformer(levels[-1][1], res)
    for i, width, attn in reversed(levels):
        if attn:
            for _ in range(p["num_res_blocks"] + 1):
                transformer(width, res)
        if i:
            res *= 2
    return out


class RefSDUNet:
    """``(x, t, context) -> prediction`` over ``weights`` (float32 tensors by
    name): x (B, H, W, C) NHWC, t (B,) int, context (B, M, context_dim)."""

    def __init__(self, weights: Dict[str, torch.Tensor], p: dict,
                 arith: Optional[Arith] = None):
        self.w, self.p = weights, p
        self.a = arith or Arith()

    def _conv(self, name, x, padding=0, stride=1):
        return self.a.conv(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                           stride=stride, padding=padding)

    def _linear(self, name, x):
        return self.a.linear(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"))

    def _gn(self, name, x, eps):
        return F.group_norm(x, 32, self.w[f"{name}.weight"], self.w[f"{name}.bias"], eps)

    def _ln(self, name, x):
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{name}.weight"],
                            self.w[f"{name}.bias"], 1e-5)

    def _resblock(self, name, x, emb):
        h = self._conv(f"{name}.in_layers.2", F.silu(self._gn(f"{name}.in_layers.0", x, 1e-5)),
                       padding=1)
        h = h + self._linear(f"{name}.emb_layers.1", F.silu(emb))[:, :, None, None]
        h = self._conv(f"{name}.out_layers.3", F.silu(self._gn(f"{name}.out_layers.0", h, 1e-5)),
                       padding=1)
        if f"{name}.skip_connection.weight" in self.w:
            x = self._conv(f"{name}.skip_connection", x)
        return x + h

    def _attention(self, name, x, ctx):
        b, n, _ = x.shape
        dh = self.p["num_head_channels"]

        def heads(t):
            return t.reshape(b, t.shape[1], -1, dh).transpose(1, 2)

        q = heads(self._linear(f"{name}.to_q", x))
        k = heads(self._linear(f"{name}.to_k", ctx))
        v = heads(self._linear(f"{name}.to_v", ctx))
        h, m = q.shape[1], k.shape[2]
        step = max(1, min(n, BLOCK_SCORES // (b * h * m)))
        kt = k.transpose(-1, -2)
        out = []
        for i in range(0, n, step):
            sim = self.a.mm(q[:, :, i:i + step], kt) * dh ** -0.5
            out.append(self.a.mm(sim.softmax(dim=-1), v))
        out = torch.cat(out, dim=2).transpose(1, 2).reshape(b, n, -1)
        return self._linear(f"{name}.to_out.0", out)

    def _transformer(self, name, x, ctx):
        b, c, hh, ww = x.shape
        h = self._gn(f"{name}.norm", x, 1e-6).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        h = self._linear(f"{name}.proj_in", h)
        for d in range(self.p.get("transformer_depth", 1)):
            blk = f"{name}.transformer_blocks.{d}"
            n1 = self._ln(f"{blk}.norm1", h)
            h = h + self._attention(f"{blk}.attn1", n1, n1)
            h = h + self._attention(f"{blk}.attn2", self._ln(f"{blk}.norm2", h), ctx)
            a, gate = self._linear(f"{blk}.ff.net.0.proj", self._ln(f"{blk}.norm3", h)).chunk(
                2, dim=-1)
            h = h + self._linear(f"{blk}.ff.net.2", a * F.gelu(gate))
        h = self._linear(f"{name}.proj_out", h)
        return x + h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)

    def _block(self, name, x, emb, ctx):
        """One of ``input_blocks`` / ``output_blocks``: its layers by the
        weights they have."""
        j = 0
        while f"{name}.{j}.in_layers.0.weight" in self.w or f"{name}.{j}.norm.weight" in self.w \
                or f"{name}.{j}.op.weight" in self.w or f"{name}.{j}.conv.weight" in self.w:
            layer = f"{name}.{j}"
            if f"{layer}.in_layers.0.weight" in self.w:
                x = self._resblock(layer, x, emb)
            elif f"{layer}.norm.weight" in self.w:
                x = self._transformer(layer, x, ctx)
            elif f"{layer}.op.weight" in self.w:
                x = self._conv(f"{layer}.op", x, padding=1, stride=2)
            else:
                x = self._conv(f"{layer}.conv", F.interpolate(x, scale_factor=2.0,
                                                              mode="nearest"), padding=1)
            j += 1
        return x

    def __call__(self, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        mc = self.p["model_channels"]
        half = mc // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32,
                                                            device=x.device) / half)
        args = t.to(torch.float32)[:, None] * freqs[None]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        emb = self._linear("time_embed.2", F.silu(self._linear("time_embed.0", emb)))
        ctx = ctx.to(torch.float32)
        h = self._conv("input_blocks.0.0", x.permute(0, 3, 1, 2).to(torch.float32), padding=1)
        hs = [h]
        k = 1
        while f"input_blocks.{k}.0.in_layers.0.weight" in self.w or \
                f"input_blocks.{k}.0.op.weight" in self.w:
            h = self._block(f"input_blocks.{k}", h, emb, ctx)
            hs.append(h)
            k += 1
        h = self._resblock("middle_block.0", h, emb)
        h = self._transformer("middle_block.1", h, ctx)
        h = self._resblock("middle_block.2", h, emb)
        k = 0
        while f"output_blocks.{k}.0.in_layers.0.weight" in self.w:
            h = self._block(f"output_blocks.{k}", torch.cat([h, hs.pop()], dim=1), emb, ctx)
            k += 1
        h = self._conv("out.2", F.silu(self._gn("out.0", h, 1e-5)), padding=1)
        return h.permute(0, 2, 3, 1)
