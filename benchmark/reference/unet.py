"""The plain reference of the class- and time-conditional U-Net noise
predictor (JohanLundberg12/latent-diffusion-models, ``src/UNet.py``), in
float32 over a dict of weights.

Written from the published architecture, not from the program: a 3x3 stem;
an encoder of levels (ResNet block with the time embedding, linear attention
as Residual(PreNorm(.)), 2x2 max pool, the skip taken before the pool); a
bottleneck (ResNet, full softmax attention of 4 heads of 32, ResNet); a
decoder of levels (2x2 transposed convolution, the mirrored skip
concatenated, ResNet, linear attention); a head (a ResNet block without the
time embedding, a 1x1 convolution).  The time embedding is sinusoidal
(frequencies over half - 1), Linear, exact GELU, Linear; the class embedding
is added to it, and the null label (``num_classes``) adds nothing.

Linear attention (lucidrains' ``LinearAttention``): q softmax over each
head's 32 features and scaled by 32^-0.5, k softmax over the positions, the
context k^T v per head, out = q ctx, a 1x1 output convolution, then
GroupNorm(1).  The weights use the reference's own names
(``encoder.downs.0.1.fn.fn.to_qkv.weight``...), which the program's
``state_dict`` also uses, so the benchmark hands one dict to both.

Images are NHWC at the boundary, NCHW inside.  Every product goes through
an :class:`~benchmark.reference.arith.Arith`.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.arith import Arith

HEADS, DIM_HEAD = 4, 32


def _chs(p: dict) -> List[int]:
    return [p["channels"]] + [p["channels"] * m for m in p["channel_multipliers"]]


def _decoder_widths(chs: Sequence[int]) -> List[int]:
    return list(reversed(chs[1:-1])) + [chs[0]]


def param_shapes(p: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the U-Net with model parameters ``p`` (the config's
    ``model.params``), by name, in the reference's order."""
    s: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    c0, chs = p["channels"], _chs(p)
    d = 4 * c0

    def conv(name, cin, cout, k, bias=True):
        s[f"{name}.weight"] = (cout, cin, k, k)
        if bias:
            s[f"{name}.bias"] = (cout,)

    def norm(name, c):
        s[f"{name}.weight"] = (c,)
        s[f"{name}.bias"] = (c,)

    def linear(name, cin, cout):
        s[f"{name}.weight"] = (cout, cin)
        s[f"{name}.bias"] = (cout,)

    def resnet(name, cin, cout, time=True):
        norm(f"{name}.block1.norm", cin)
        conv(f"{name}.block1.conv2d", cin, cout, 3)
        if time:
            linear(f"{name}.mlp_t.1", d, cout)
        norm(f"{name}.block2.norm", cout)
        conv(f"{name}.block2.conv2d", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.shortcut", cin, cout, 1)

    def lin_attn(name, c):
        norm(f"{name}.fn.norm", c)
        conv(f"{name}.fn.fn.to_qkv", c, 3 * HEADS * DIM_HEAD, 1, bias=False)
        conv(f"{name}.fn.fn.to_out.0", HEADS * DIM_HEAD, c, 1)
        norm(f"{name}.fn.fn.to_out.1", c)

    linear("time_emb.time_mlp.1", d // 4, d)
    linear("time_emb.time_mlp.3", d, d)
    s["label_emb.weight"] = (p["num_classes"], d)
    conv("initial_conv", p["in_channels"], c0, 3)
    dim = c0
    for i, dim_out in enumerate(chs[1:]):
        resnet(f"encoder.downs.{i}.0", dim, dim_out)
        lin_attn(f"encoder.downs.{i}.1", dim_out)
        dim = dim_out
    resnet("bottleneck.res1", dim, dim)
    norm("bottleneck.attn.fn.norm", dim)
    conv("bottleneck.attn.fn.fn.to_qkv", dim, 3 * HEADS * DIM_HEAD, 1, bias=False)
    conv("bottleneck.attn.fn.fn.to_out", HEADS * DIM_HEAD, dim, 1)
    resnet("bottleneck.res2", dim, dim)
    skips = chs[1:]
    for i, dim_out in enumerate(_decoder_widths(chs)):
        resnet(f"decoder.ups.{i}.0", dim_out + skips[-1 - i], dim_out)
        lin_attn(f"decoder.ups.{i}.1", dim_out)
        s[f"decoder.ups.{i}.2.weight"] = (dim, dim_out, 2, 2)
        s[f"decoder.ups.{i}.2.bias"] = (dim_out,)
        dim = dim_out
    resnet("final_conv.0", dim, c0, time=False)
    conv("final_conv.1", c0, p["out_channels"], 1)
    return s


def attention_sites(p: dict, side: int) -> List[Tuple[int, int]]:
    """(N, C) of every linear-attention block of one forward at a square
    input of ``side``, in the order the forward meets them."""
    chs = _chs(p)
    levels = len(p["channel_multipliers"])
    enc = [((side >> i) ** 2, c) for i, c in enumerate(chs[1:])]
    dec = [((side >> (levels - 1 - i)) ** 2, c) for i, c in enumerate(_decoder_widths(chs))]
    return enc + dec


def _gn(x, w, b, groups, eps):
    return F.group_norm(x, groups, w, b, eps)


class RefUNet:
    """The U-Net's forward over ``weights`` (float32 tensors by name)."""

    def __init__(self, weights: Dict[str, torch.Tensor], p: dict, arith: Optional[Arith] = None):
        self.w, self.p = weights, p
        self.a = arith or Arith()
        self.d = 4 * p["channels"]

    def _conv(self, name, x, padding=0, stride=1):
        return self.a.conv(x, self.w[f"{name}.weight"], self.w.get(f"{name}.bias"),
                           stride=stride, padding=padding)

    def _linear(self, name, x):
        return self.a.linear(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"])

    def _block(self, name, x):
        h = _gn(x, self.w[f"{name}.norm.weight"], self.w[f"{name}.norm.bias"], 8, 1e-5)
        return self._conv(f"{name}.conv2d", F.silu(h), padding=1)

    def _resnet(self, name, x, temb):
        h = self._block(f"{name}.block1", x)
        if temb is not None:
            h = h + self._linear(f"{name}.mlp_t.1", F.silu(temb))[:, :, None, None]
        h = self._block(f"{name}.block2", h)
        sc = self._conv(f"{name}.shortcut", x) if f"{name}.shortcut.weight" in self.w else x
        return h + sc

    def _qkv(self, name, x):
        """GroupNorm(1) of x, then the 1x1 qkv projection: three (B, H, D, N)."""
        b, c, hh, ww = x.shape
        h = _gn(x, self.w[f"{name}.fn.norm.weight"], self.w[f"{name}.fn.norm.bias"], 1, 1e-5)
        qkv = self._conv(f"{name}.fn.fn.to_qkv", h)
        return [t.reshape(b, HEADS, DIM_HEAD, hh * ww) for t in qkv.chunk(3, dim=1)]

    def _lin_attn(self, name, x):
        b, c, hh, ww = x.shape
        q, k, v = self._qkv(name, x)
        q = q.softmax(dim=-2) * DIM_HEAD ** -0.5
        k = k.softmax(dim=-1)
        ctx = self.a.mm(k, v.transpose(-1, -2))                    # (B, H, D, E)
        out = self.a.mm(ctx.transpose(-1, -2), q)                  # (B, H, E, N)
        out = self._conv(f"{name}.fn.fn.to_out.0", out.reshape(b, HEADS * DIM_HEAD, hh, ww))
        out = _gn(out, self.w[f"{name}.fn.fn.to_out.1.weight"],
                  self.w[f"{name}.fn.fn.to_out.1.bias"], 1, 1e-5)
        return x + out

    def _full_attn(self, name, x):
        b, c, hh, ww = x.shape
        q, k, v = self._qkv(name, x)
        sim = self.a.mm((q * DIM_HEAD ** -0.5).transpose(-1, -2), k)  # (B, H, N, N)
        attn = sim.softmax(dim=-1)
        out = self.a.mm(attn, v.transpose(-1, -2))                   # (B, H, N, D)
        out = out.permute(0, 1, 3, 2).reshape(b, HEADS * DIM_HEAD, hh, ww)
        return x + self._conv(f"{name}.fn.fn.to_out", out)

    def embed(self, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        half = self.d // 8
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * -(math.log(10000.0) / (half - 1)))
        ang = t.to(torch.float32)[:, None] * freq[None, :]
        pos = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        temb = self._linear("time_emb.time_mlp.3",
                            F.gelu(self._linear("time_emb.time_mlp.1", pos)))
        real = y < self.p["num_classes"]
        lab = self.w["label_emb.weight"][torch.where(real, y, torch.zeros_like(y))]
        return temb + lab * real.to(torch.float32)[:, None]

    def __call__(self, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C), t (B,) int, y (B,) int -> eps (B, H, W, C_out)."""
        chs = _chs(self.p)
        temb = self.embed(t, y)
        h = self._conv("initial_conv", x.permute(0, 3, 1, 2).to(torch.float32), padding=1)
        skips = []
        for i in range(len(chs) - 1):
            h = self._lin_attn(f"encoder.downs.{i}.1",
                               self._resnet(f"encoder.downs.{i}.0", h, temb))
            skips.append(h)
            h = F.max_pool2d(h, 2)
        h = self._resnet("bottleneck.res1", h, temb)
        h = self._full_attn("bottleneck.attn", h)
        h = self._resnet("bottleneck.res2", h, temb)
        for i in range(len(chs) - 1):
            up = self.a.conv_t(h, self.w[f"decoder.ups.{i}.2.weight"],
                               self.w[f"decoder.ups.{i}.2.bias"], 2)
            h = torch.cat([up, skips.pop()], dim=1)
            h = self._lin_attn(f"decoder.ups.{i}.1",
                               self._resnet(f"decoder.ups.{i}.0", h, temb))
        h = self._conv("final_conv.1", self._resnet("final_conv.0", h, None))
        return h.permute(0, 2, 3, 1)
