"""The plain reference of the first stage (JohanLundberg12/latent-diffusion-
models, ``src/Autoencoder.py``, the Stable Diffusion VAE's layout), in
float32 over a dict of weights.

Encoder: a 3x3 stem, levels of ResNet blocks (GroupNorm(32, eps 1e-6),
SiLU, 3x3 convolution, twice; a 1x1 shortcut where the width changes) with a
stride-2 3x3 convolution after a right and bottom zero pad after each level
but the last; a middle of block, single-head attention (scale C^-0.5),
block; GroupNorm, SiLU and a 3x3 convolution to 2z moments; a 1x1
``quant_conv``.  The latent is mu + exp(log_var / 2) eps.  Decoder: a 1x1
``post_quant_conv``, a 3x3 stem, the middle, levels from the deepest up of
``n_resnet_blocks + 1`` blocks with a nearest 2x upsample and a 3x3
convolution after each but the top one, GroupNorm, SiLU, a 3x3 convolution.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.arith import Arith


def param_shapes(p: dict) -> "OrderedDict[str, Tuple[int, ...]]":
    """Every weight of the VAE with parameters ``p`` (the config's
    ``autoencoder.params``), by name."""
    s: "OrderedDict[str, Tuple[int, ...]]" = OrderedDict()
    mults, c0, z, nb = p["channel_multipliers"], p["channels"], p["z_channels"], \
        p["n_resnet_blocks"]
    chs = [c0 * m for m in [1] + list(mults)]

    def conv(name, cin, cout, k):
        s[f"{name}.weight"] = (cout, cin, k, k)
        s[f"{name}.bias"] = (cout,)

    def norm(name, c):
        s[f"{name}.weight"] = (c,)
        s[f"{name}.bias"] = (c,)

    def block(name, cin, cout):
        norm(f"{name}.norm1", cin)
        conv(f"{name}.conv1", cin, cout, 3)
        norm(f"{name}.norm2", cout)
        conv(f"{name}.conv2", cout, cout, 3)
        if cin != cout:
            conv(f"{name}.nin_shortcut", cin, cout, 1)

    def mid(name, c):
        block(f"{name}.block_1", c, c)
        norm(f"{name}.attn_1.norm", c)
        for m in ("q", "k", "v", "proj_out"):
            conv(f"{name}.attn_1.{m}", c, c, 1)
        block(f"{name}.block_2", c, c)

    n = len(mults)
    conv("encoder.conv_in", p["in_channels"], c0, 3)
    for i in range(n):
        for j in range(nb):
            block(f"encoder.down.{i}.block.{j}", chs[i] if j == 0 else chs[i + 1], chs[i + 1])
        if i != n - 1:
            conv(f"encoder.down.{i}.downsample.conv", chs[i + 1], chs[i + 1], 3)
    mid("encoder.mid", chs[-1])
    norm("encoder.norm_out", chs[-1])
    conv("encoder.conv_out", chs[-1], 2 * z, 3)
    conv("quant_conv", 2 * z, 2 * z, 1)
    conv("post_quant_conv", z, z, 1)
    dchs = [c0 * m for m in mults]
    conv("decoder.conv_in", z, dchs[-1], 3)
    mid("decoder.mid", dchs[-1])
    prev = dchs[-1]
    for i in reversed(range(n)):
        for j in range(nb + 1):
            block(f"decoder.up.{i}.block.{j}", prev if j == 0 else dchs[i], dchs[i])
        if i != 0:
            conv(f"decoder.up.{i}.upsample.conv", dchs[i], dchs[i], 3)
        prev = dchs[i]
    norm("decoder.norm_out", dchs[0])
    conv("decoder.conv_out", dchs[0], p["out_channels"], 3)
    return s


class RefVAE:
    """Encode and decode over ``weights`` (float32 tensors by name)."""

    def __init__(self, weights: Dict[str, torch.Tensor], p: dict, arith: Optional[Arith] = None):
        self.w, self.p = weights, p
        self.a = arith or Arith()

    def _conv(self, name, x, padding=0, stride=1):
        return self.a.conv(x, self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                           stride=stride, padding=padding)

    def _norm(self, name, x):
        c = x.shape[1]
        return F.group_norm(x, min(32, c), self.w[f"{name}.weight"], self.w[f"{name}.bias"],
                            1e-6)

    def _block(self, name, x):
        h = self._conv(f"{name}.conv1", F.silu(self._norm(f"{name}.norm1", x)), padding=1)
        h = self._conv(f"{name}.conv2", F.silu(self._norm(f"{name}.norm2", h)), padding=1)
        if f"{name}.nin_shortcut.weight" in self.w:
            x = self._conv(f"{name}.nin_shortcut", x)
        return x + h

    def _attn(self, name, x):
        b, c, hh, ww = x.shape
        h = self._norm(f"{name}.norm", x)
        q, k, v = (self._conv(f"{name}.{m}", h).reshape(b, c, hh * ww) for m in "qkv")
        attn = (self.a.mm(q.transpose(1, 2), k) * c ** -0.5).softmax(dim=-1)  # (B, N, N)
        out = self.a.mm(v, attn.transpose(1, 2)).reshape(b, c, hh, ww)
        return x + self._conv(f"{name}.proj_out", out)

    def _mid(self, name, x):
        x = self._block(f"{name}.block_1", x)
        return self._block(f"{name}.block_2", self._attn(f"{name}.attn_1", x))

    def moments(self, img: torch.Tensor) -> torch.Tensor:
        """Image (B, H, W, C) in [-1, 1] -> (mu ‖ log_var), (B, h, w, 2z)."""
        n = len(self.p["channel_multipliers"])
        x = self._conv("encoder.conv_in", img.permute(0, 3, 1, 2).to(torch.float32), padding=1)
        for i in range(n):
            for j in range(self.p["n_resnet_blocks"]):
                x = self._block(f"encoder.down.{i}.block.{j}", x)
            if i != n - 1:
                x = self._conv(f"encoder.down.{i}.downsample.conv", F.pad(x, (0, 1, 0, 1)),
                               stride=2)
        x = self._mid("encoder.mid", x)
        x = self._conv("encoder.conv_out", F.silu(self._norm("encoder.norm_out", x)), padding=1)
        return self._conv("quant_conv", x).permute(0, 2, 3, 1)

    def latent(self, img: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        mu, log_var = self.moments(img).chunk(2, dim=-1)
        return mu + torch.exp(0.5 * log_var) * eps

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent (B, h, w, z) -> image (B, H, W, C)."""
        n = len(self.p["channel_multipliers"])
        x = self._conv("post_quant_conv", z.permute(0, 3, 1, 2).to(torch.float32))
        x = self._mid("decoder.mid", self._conv("decoder.conv_in", x, padding=1))
        for i in reversed(range(n)):
            for j in range(self.p["n_resnet_blocks"] + 1):
                x = self._block(f"decoder.up.{i}.block.{j}", x)
            if i != 0:
                x = self._conv(f"decoder.up.{i}.upsample.conv",
                               F.interpolate(x, scale_factor=2.0, mode="nearest"), padding=1)
        x = self._conv("decoder.conv_out", F.silu(self._norm("decoder.norm_out", x)), padding=1)
        return x.permute(0, 2, 3, 1)
