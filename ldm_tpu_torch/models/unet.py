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
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ldm_tpu_torch.ops.collectives import copy_to_model, reduce_from_model
from ldm_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_torch, takes_kernel
from ldm_tpu_torch.ops.linear_attention import (
    KernelWeights,
    linear_attention_block,
    linear_attention_block_torch,
    make_kernel_weights,
)


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
    and in channels_last (flax nn.GroupNorm with ``dtype=``).

    A bf16 CUDA input outside autograd takes the one-pass kernel
    (``ops/group_norm.py``), and :meth:`forward_silu` the SiLU after the norm
    in the same pass; everything else the plain chain."""

    def _norm(self, x: torch.Tensor, silu: bool) -> torch.Tensor:
        op = group_norm_silu if takes_kernel(x) else group_norm_silu_torch
        return op(x, self.weight, self.bias, self.num_groups, self.eps, silu)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._norm(x, silu=False)

    def forward_silu(self, x: torch.Tensor) -> torch.Tensor:
        """``F.silu(self(x))``."""
        return self._norm(x, silu=True)


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
        return self.conv2d(self.norm.forward_silu(x))


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
    view.

    Under tensor parallelism (``parallel/tp.py``) ``to_qkv`` holds the q, k
    and v rows of this process's heads and ``to_out`` their columns, and
    ``model_group`` is the model axis's group: the input enters through
    ``copy_to_model``, the partial output projection leaves through
    ``reduce_from_model``, and the bias is added once."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)
        self.model_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        n = hh * ww
        cd = x.dtype
        heads = self.to_qkv.weight.shape[0] // (3 * self.dim_head)  # this process's
        xs = copy_to_model(x.permute(0, 2, 3, 1).reshape(b, n, c), self.model_group)
        qkv = xs @ self.to_qkv.weight.view(-1, c).t().to(cd)
        q, k, v = (
            t.reshape(b, n, heads, self.dim_head).transpose(1, 2)
            for t in qkv.chunk(3, dim=-1)
        )
        q = q * (self.dim_head**-0.5)
        sim = (q @ k.transpose(-1, -2)).to(torch.float32)
        sim = sim - sim.amax(dim=-1, keepdim=True)
        attn = torch.softmax(sim, dim=-1).to(cd)
        out = (attn @ v).transpose(1, 2).reshape(b, n, -1)
        w_out = self.to_out.weight.view(c, -1).t().to(cd)
        out = reduce_from_model(out @ w_out, self.model_group) + self.to_out.bias.to(cd)
        return out.view(b, hh, ww, c).permute(0, 3, 1, 2)


class LinearAttention(nn.Module):
    """Parameters of the per-level linear attention in the reference layout:
    ``to_qkv`` (1x1 conv, no bias) and ``to_out`` (1x1 conv, GroupNorm(1)).
    :class:`LinAttnBlock` runs them, with its pre-norm, as one fused op.
    ``model_group``: as :class:`Attention`'s."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Sequential(nn.Conv2d(hidden, dim, 1), nn.GroupNorm(1, dim))
        self.model_group = None


def _check_attention_impl(impl: Optional[str]) -> Optional[str]:
    if impl not in (None, "torch"):
        raise ValueError(f"attention impl must be None or 'torch', got {impl!r}")
    return impl


class LinAttnBlock(Residual):
    """The whole per-level block, Residual(PreNorm(LinearAttention)), as ONE op.

    ``impl=None`` runs :func:`linear_attention_block` (the Hopper kernels on a
    CUDA tensor, the plain versions on a CPU tensor; in grad mode through the
    autograd op ``LinearAttentionBlockFn``); ``impl="torch"`` runs the plain
    forward under torch autograd on any device, over the heads whose weights
    the block holds: the path of every block under a model axis > 1 (the
    JAX trainer's ``attention_impl="xla_heads"``), with the model axis's
    group in ``fn.fn.model_group`` under tensor parallelism (this process's
    heads and the collectives around them; the kernels compute whole blocks
    and refuse a group).
    """

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32,
                 impl: Optional[str] = None):
        super().__init__(PreNorm(dim, LinearAttention(dim, heads, dim_head)))
        self.heads, self.dim_head, self.impl = heads, dim_head, _check_attention_impl(impl)
        self._kernel_w_key, self._kernel_w = None, None
        self.replayed_steps = 0

    def _weights_key(self) -> tuple:
        """What the cached copies are good for: the two weights' addresses and
        versions, and the count of replayed steps.  A replayed CUDA graph
        that updates the weights in place bumps no version counter; its owner
        says so through :meth:`UNet.weights_replayed`."""
        wq, wo = self.fn.fn.to_qkv.weight, self.fn.fn.to_out[0].weight
        return (wq.data_ptr(), wq._version, wo.data_ptr(), wo._version, self.replayed_steps)

    def kernel_weights(self, dtype: torch.dtype, backward: bool = False) -> KernelWeights:
        """The (3H, C, 1, 1) / (C, H, 1, 1) conv weights as the kernels read
        them (:class:`KernelWeights`: contiguous, in the compute type, both
        orientations; the forward's two alone until a backward asks).  Made
        once per weight version and compute type: again only when a weight
        changes (an optimizer step, a load_state_dict and any in-place update
        bump its version; a replayed graph's update is counted in
        ``replayed_steps``) or moves, not on every call of the sampler's loop.
        A C that is no multiple of 16 comes zero-padded (``ops.pad_width``)."""
        key = (self._weights_key(), dtype)
        kw = self._kernel_w
        if key != self._kernel_w_key or (backward and kw.wqkv is None):
            wq, wo = self.fn.fn.to_qkv.weight, self.fn.fn.to_out[0].weight
            c = wo.shape[0]
            self._kernel_w = make_kernel_weights(wq.view(-1, c).t(), wo.view(c, -1).t(),
                                                  dtype, backward=backward)
            self._kernel_w_key = key
        return self._kernel_w

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hh, ww = x.shape
        pre, attn = self.fn.norm, self.fn.fn
        out_conv, out_norm = attn.to_out
        params = (out_conv.bias, pre.weight, pre.bias, out_norm.weight, out_norm.bias)
        tracked = torch.is_grad_enabled() and (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))
        kw = {}
        if self.impl == "torch":
            op = linear_attention_block_torch
            kw["group"] = attn.model_group
        elif attn.model_group is not None:
            raise ValueError("the attention kernels compute whole blocks: a block whose heads "
                             "are split over a model axis takes impl='torch'")
        else:
            op = linear_attention_block
            if x.is_cuda:
                kw["weights"] = self.kernel_weights(x.dtype, backward=tracked)
        # views of the conv weights, inside the graph when it is tracked: their
        # grads reach to_qkv.weight and to_out.0.weight
        wqkv, wout = attn.to_qkv.weight.view(-1, c).t(), out_conv.weight.view(c, -1).t()
        y = op(
            x.permute(0, 2, 3, 1).reshape(b, hh * ww, c).contiguous(),
            wqkv, wout, *params,
            heads=wout.shape[0] // self.dim_head, dim_head=self.dim_head, eps=1e-5,
            compute_dtype=x.dtype, **kw,
        )
        return y.view(b, hh, ww, c).permute(0, 3, 1, 2)


def group_norm_calls(model: nn.Module) -> int:
    """The GroupNorm modules one forward of ``model`` calls: every one but the
    pre-norms of the linear-attention blocks, which the attention op
    computes itself."""
    inside = {id(m) for block in model.modules() if isinstance(block, LinAttnBlock)
              for m in block.modules()}
    return sum(isinstance(m, GroupNorm) and id(m) not in inside for m in model.modules())


class UNet(nn.Module):
    """The noise-prediction U-Net.

    Constructor surface matches the config schema (in_channels, out_channels,
    channels, channel_multipliers, with_time_emb, num_classes) plus the
    compute ``dtype``, the attention ``attention_impl`` (None or "torch":
    :class:`LinAttnBlock`'s; :meth:`set_attention_impl` changes it), the
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
        # the widths of encode's outputs (a skip per level, h_mid, t_emb) and
        # of decode's: what a pipeline stage sizes its buffers by
        self.chs, self.time_dim, self.out_channels = chs, d_time, out_channels

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

    # ---- the attention kernels' weight copies and CUDA graphs
    def lin_attn_blocks(self) -> List[LinAttnBlock]:
        return [m for m in self.modules() if isinstance(m, LinAttnBlock)]

    def set_attention_impl(self, impl: Optional[str]) -> "UNet":
        """Every linear-attention block's ``impl`` (the JAX model's
        ``clone(attention_impl=...)``, in place)."""
        _check_attention_impl(impl)
        for block in self.lin_attn_blocks():
            block.impl = impl
        return self

    def weights_replayed(self) -> None:
        """Tell the blocks that a replayed CUDA graph changed the weights in
        place (no version counter moved): their cached kernel copies are
        stale, and the next eager call makes new ones."""
        for block in self.lin_attn_blocks():
            block.replayed_steps += 1

    def drop_kernel_weights(self) -> None:
        """Forget the cached kernel copies.  Before the capture of a step that
        updates the weights: the copies are then made inside the captured
        region, so every replay makes them again from the current weights."""
        for block in self.lin_attn_blocks():
            block._kernel_w_key, block._kernel_w = None, None

    def kernel_weights_state(self) -> tuple:
        """(key, copies): what the blocks' cached kernel copies are good for,
        and the copies themselves.  A captured graph that read the copies
        holds them (their memory must not be reused while it can replay) and
        is stale once the key has changed."""
        blocks = self.lin_attn_blocks()
        return tuple(b._weights_key() for b in blocks), [b._kernel_w for b in blocks]

    @property
    def null_label(self) -> int:
        """Label id reserved for the unconditional pass (embeds to exactly zero)."""
        if self.num_classes is None:
            raise ValueError("an unconditional UNet has no null label")
        return self.num_classes

    def conditioning(self, t: torch.Tensor, y: Optional[torch.Tensor] = None
                     ) -> Optional[torch.Tensor]:
        """The time embedding in the compute type, the class embedding added
        (zero for the null label); None without a time MLP."""
        cd = self.dtype
        if self.time_emb is None:
            return None
        t_emb = self.time_emb(t, cd)
        if self.label_emb is not None and y is not None:
            is_null = y >= self.num_classes
            safe_y = torch.where(is_null, torch.zeros_like(y), y)
            lab = self.label_emb.weight.to(cd)[safe_y]
            t_emb = t_emb + lab * (1.0 - is_null.to(cd))[:, None]
        return t_emb

    def encode(self, x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, List[torch.Tensor], Optional[torch.Tensor]]:
        """The conditioning, the stem, the encoder and the bottleneck: the
        first stage of the pipeline's cut (``parallel/pp.py``).  Returns
        (h_mid, the skips in level order, t_emb), each activation an NCHW
        view of channels_last memory in the compute type."""
        cd = self.dtype
        t_emb = self.conditioning(t, y)

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
        return h, skips, t_emb

    def decode(self, h: torch.Tensor, skips: Sequence[torch.Tensor],
               t_emb: Optional[torch.Tensor]) -> torch.Tensor:
        """The decoder and the head on :meth:`encode`'s output: the second
        stage of the cut.  Returns the eps prediction, NHWC float32."""
        skips = list(skips)
        for res, attn, up in self.decoder.ups:
            h = torch.cat([up(h), skips.pop()], dim=1)
            h = attn(res(h, t_emb))

        res, conv = self.final_conv
        h = conv(res(h))
        return h.permute(0, 2, 3, 1).to(torch.float32)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                y: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x: (B, H, W, C) NHWC; t: (B,) int steps; y: (B,) int labels or None.
        Returns the eps prediction, (B, H, W, out_channels) float32."""
        return self.decode(*self.encode(x, t, y))
