"""Stable-Diffusion-style VAE autoencoder (PyTorch port of
ldm_tpu/models/autoencoder.py).

Encoder (conv_in -> levels of ResnetBlocks with a strided-conv DownSample
after each but the last -> mid block / attention / block -> norm, SiLU,
conv_out to 2 * z_channels), a 1x1 ``quant_conv`` on the moments, the
reparameterised latent sample, a 1x1 ``post_quant_conv`` and the mirrored
Decoder (``n_resnet_blocks + 1`` blocks a level, nearest-2x UpSample).

Submodules carry the reference layout's names (``encoder.down.{i}.block.{j}``,
``encoder.mid.attn_1.q``, ``decoder.up.{i}.upsample.conv``...), the layout that
``utils/flax_import.py::autoencoder_state_dict_from_params`` emits, so flax
weights load with ``load_state_dict(strict=True)``.

Layout and types as in ``models/unet.py``: the public methods take and return
NHWC; inside, the NHWC tensor's ``.permute(0, 3, 1, 2)`` is a channels_last
NCHW tensor.  Parameters stay fp32 and are cast to the compute ``dtype`` at
each use; GroupNorm(min(32, C), eps 1e-6) keeps its statistics in fp32; the
attention's logits are scaled and put through softmax in fp32; the moments,
the latents and the decoder's output are fp32, at the JAX package's points.
Every convolution and the attention are plain PyTorch (cuDNN and matmuls
on a card), as they are plain XLA in the JAX package; a norm, with the SiLU
after it where one follows, is the model layer's (``models/unet.py::
GroupNorm``: one hand-written pass for bf16 on a card outside autograd, the
plain chain elsewhere).  Outside
autograd a decoder convolution whose bf16 algorithm makes an image depend
on its position in the batch runs in fp32 on its bf16 values, under cuDNN
flags of its own (:class:`DecoderConv2d`).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tpu_torch.models.unet import Conv2d, GroupNorm

_CL = torch.channels_last


class DecoderConv2d(Conv2d):
    """A convolution of the decoder whose output, outside autograd, does not
    depend on an image's position in the batch.

    A served image must not depend on the batch it rode in, but one of
    cuDNN's bf16 algorithms breaks that (8x8, 512 -> 512 at B=64 on an
    H100: the same image at another slot comes out up to 2^-6 away).  So at
    the first bf16 call of each input shape outside autograd the layer
    probes itself: random inputs, and the same rolled along the batch; if
    the outputs differ, calls of that shape run in fp32 on the bf16 input,
    weight and bias and round to bf16 once (bf16 products are exact in
    fp32: only the order of the fp32 sums differs from a bf16 convolution
    with fp32 accumulation).  Both run under cuDNN flags of their own
    (:meth:`pinned`: no autotuning, deterministic algorithms, no TF32), so
    the verdict and the fp32 algorithm do not change with the caller's
    flags.  Training keeps the bf16 convolution."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.position_independent: dict = {}  # input shape -> the bf16 algorithm's verdict

    @staticmethod
    def pinned():
        """The cuDNN flags the probe and both convolutions run under."""
        return torch.backends.cudnn.flags(enabled=True, benchmark=False, deterministic=True,
                                          allow_tf32=False)

    def _probe(self, x: torch.Tensor) -> bool:
        """Whether the bf16 convolution at x's shape and layout gives every
        image the same output at another position in the batch."""
        g = torch.Generator(device=x.device).manual_seed(0)
        probe = torch.empty_like(x).normal_(generator=g)
        shift = x.shape[0] // 2
        a = super().forward(probe)
        b = super().forward(probe.roll(shift, 0))
        return torch.equal(a.roll(shift, 0), b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype != torch.bfloat16 or torch.is_grad_enabled() or x.shape[0] < 2:
            return super().forward(x)
        key = (tuple(x.shape), x.is_contiguous(memory_format=_CL))
        with self.pinned():
            ok = self.position_independent.get(key)
            if ok is None:
                ok = self.position_independent[key] = self._probe(x)
            if ok:
                return super().forward(x)
            b = None if self.bias is None else self.bias.to(x.dtype).float()
            return self._conv_forward(x.float(), self.weight.to(x.dtype).float(),
                                      b).to(x.dtype)


def _norm(channels: int) -> GroupNorm:
    """GroupNorm(32, eps=1e-6); the group count clamps to the channel count."""
    return GroupNorm(min(32, channels), channels, eps=1e-6)


class ResnetBlock(nn.Module):
    """norm-SiLU-conv twice, plus a 1x1 ``nin_shortcut`` where the width changes."""

    def __init__(self, in_channels: int, out_channels: int, conv=Conv2d):
        super().__init__()
        self.norm1 = _norm(in_channels)
        self.conv1 = conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = _norm(out_channels)
        self.conv2 = conv(out_channels, out_channels, 3, padding=1)
        self.nin_shortcut = (conv(in_channels, out_channels, 1)
                             if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(self.norm1.forward_silu(x))
        h = self.conv2(self.norm2.forward_silu(h))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head softmax self-attention over the grid, scale C^-0.5; the
    1x1 q / k / v / proj_out convs are applied as matmuls on the NHWC view."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = _norm(channels)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(channels, channels, 1)
                                                 for _ in range(4))

    @staticmethod
    def _dense(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
        c = conv.weight.shape[0]
        return x @ conv.weight.view(c, -1).t().to(x.dtype) + conv.bias.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        h = self.norm(x).permute(0, 2, 3, 1).reshape(b, hh * ww, c)
        q, k, v = (self._dense(m, h) for m in (self.q, self.k, self.v))
        sim = (q @ k.transpose(1, 2)).to(torch.float32) * (c ** -0.5)
        attn = torch.softmax(sim, dim=-1).to(x.dtype)
        out = self._dense(self.proj_out, attn @ v)
        return x + out.view(b, hh, ww, c).permute(0, 3, 1, 2)


class DownSample(nn.Module):
    """A 3x3 stride-2 conv after a (0, 1, 0, 1) zero pad: right and bottom,
    flax's ``((0, 1), (0, 1))`` on (H, W)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)).contiguous(memory_format=_CL))


class UpSample(nn.Module):
    """Nearest-neighbour 2x (``jax.image.resize(..., "nearest")`` at 2x:
    output pixel i reads input i // 2), then a 3x3 conv."""

    def __init__(self, channels: int, conv=Conv2d):
        super().__init__()
        self.conv = conv(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


def _level(blocks: Sequence[ResnetBlock], name: str, resample: Optional[nn.Module]
           ) -> nn.Module:
    """One resolution: its ResnetBlocks (``block``) and, where there is one,
    the resampler under ``name``."""
    level = nn.Module()
    level.block = nn.ModuleList(blocks)
    if resample is not None:
        level.add_module(name, resample)
    return level


def _run_level(level: nn.Module, name: str, x: torch.Tensor) -> torch.Tensor:
    for block in level.block:
        x = block(x)
    resample = getattr(level, name, None)
    return x if resample is None else resample(x)


class _Mid(nn.Module):
    def __init__(self, channels: int, conv=Conv2d):
        super().__init__()
        self.block_1 = ResnetBlock(channels, channels, conv)
        self.attn_1 = AttnBlock(channels)
        self.block_2 = ResnetBlock(channels, channels, conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block_2(self.attn_1(self.block_1(x)))


class Encoder(nn.Module):
    """Image (NCHW, compute dtype) -> moments (mu ‖ log_var), 2 * z_channels."""

    def __init__(self, in_channels: int, channels: int, channel_multipliers: Sequence[int],
                 n_resnet_blocks: int, z_channels: int):
        super().__init__()
        chs = [channels * m for m in [1] + list(channel_multipliers)]
        n = len(channel_multipliers)
        self.conv_in = Conv2d(in_channels, channels, 3, padding=1)
        self.down = nn.ModuleList()
        for i in range(n):
            blocks = [ResnetBlock(chs[i] if j == 0 else chs[i + 1], chs[i + 1])
                      for j in range(n_resnet_blocks)]
            self.down.append(_level(blocks, "downsample",
                                    DownSample(chs[i + 1]) if i != n - 1 else None))
        self.mid = _Mid(chs[-1])
        self.norm_out = _norm(chs[-1])
        self.conv_out = Conv2d(chs[-1], 2 * z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(x)
        for level in self.down:
            x = _run_level(level, "downsample", x)
        x = self.mid(x)
        return self.conv_out(self.norm_out.forward_silu(x))


class Decoder(nn.Module):
    """Latent (NCHW, compute dtype) -> image, fp32; ``n_resnet_blocks + 1``
    blocks a level, the levels run from the deepest up."""

    def __init__(self, channels: int, channel_multipliers: Sequence[int],
                 n_resnet_blocks: int, z_channels: int, out_channels: int):
        super().__init__()
        chs = [channels * m for m in channel_multipliers]
        conv = DecoderConv2d
        self.conv_in = conv(z_channels, chs[-1], 3, padding=1)
        self.mid = _Mid(chs[-1], conv)
        up = [None] * len(chs)
        prev = chs[-1]
        for i in reversed(range(len(chs))):
            blocks = [ResnetBlock(prev if j == 0 else chs[i], chs[i], conv)
                      for j in range(n_resnet_blocks + 1)]
            up[i] = _level(blocks, "upsample", UpSample(chs[i], conv) if i != 0 else None)
            prev = chs[i]
        self.up = nn.ModuleList(up)
        self.norm_out = _norm(chs[0])
        self.conv_out = conv(chs[0], out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.mid(self.conv_in(z))
        for i in reversed(range(len(self.up))):
            x = _run_level(self.up[i], "upsample", x)
        return self.conv_out(self.norm_out.forward_silu(x)).to(torch.float32)


class Autoencoder(nn.Module):
    """The VAE: ``forward(img, eps)`` returns ``(recon, mu, log_var)``, NHWC fp32.

    Constructor surface as the config schema (in_channels, z_channels,
    out_channels, channels, channel_multipliers, n_resnet_blocks) plus the
    compute ``dtype`` and the ``device`` to build on.
    """

    def __init__(self, in_channels: int = 1, z_channels: int = 512, out_channels: int = 1,
                 channels: int = 64, channel_multipliers: Sequence[int] = (1, 2, 4, 8),
                 n_resnet_blocks: int = 2, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.z_channels = z_channels
        self.channel_multipliers = tuple(channel_multipliers)
        self.dtype = dtype
        self.encoder = Encoder(in_channels, channels, channel_multipliers, n_resnet_blocks,
                               z_channels)
        self.quant_conv = Conv2d(2 * z_channels, 2 * z_channels, 1)
        self.post_quant_conv = DecoderConv2d(z_channels, z_channels, 1)
        self.decoder = Decoder(channels, channel_multipliers, n_resnet_blocks, z_channels,
                               out_channels)
        if device is not None:
            self.to(device)

    def encode_moments(self, img: torch.Tensor) -> torch.Tensor:
        """Image (B, H, W, C) -> moments (mu ‖ log_var) (B, h, w, 2z), fp32."""
        h = self.encoder(img.to(self.dtype).permute(0, 3, 1, 2))
        return self.quant_conv(h).permute(0, 2, 3, 1).to(torch.float32)

    @staticmethod
    def moments_split(moments: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mu, log_var): the halves of the channel axis, the last in NHWC."""
        return moments.chunk(2, dim=-1)

    @staticmethod
    def sample_latent(moments: torch.Tensor, eps: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The reparameterised z = mu + exp(log_var / 2) * eps; ``eps`` (the
        latent's shape) drawn from ``generator`` if not given."""
        mu, log_var = Autoencoder.moments_split(moments)
        sigma = torch.exp(0.5 * log_var)
        if eps is None:
            eps = torch.randn(sigma.shape, generator=generator, device=sigma.device,
                              dtype=sigma.dtype)
        return mu + sigma * eps.to(sigma.device, sigma.dtype)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latent (B, h, w, z) -> image (B, H, W, C), fp32."""
        h = self.post_quant_conv(z.to(self.dtype).permute(0, 3, 1, 2))
        return self.decoder(h).permute(0, 2, 3, 1)

    def forward(self, img: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        moments = self.encode_moments(img)
        mu, log_var = self.moments_split(moments)
        z = self.sample_latent(moments, eps, generator)
        return self.decode(z), mu, log_var


def latent_shape_of(autoencoder, image_size: int) -> Tuple[int, int, int]:
    """(h, w, z): the VAE halves the side after every level but the last."""
    z = image_size // 2 ** (len(autoencoder.channel_multipliers) - 1)
    return (z, z, autoencoder.z_channels)
