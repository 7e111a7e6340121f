"""ResNet image classifier (PyTorch port of ldm_tpu/models/resnet.py).

A 7x7 stride-2 stem conv + BatchNorm, stacked residual blocks
(conv-BN-ReLU-conv-BN with a 1x1 projection shortcut where the shape
changes) or bottleneck blocks (1x1-3x3-1x1), a global average pool and a
linear head that returns LOGITS (``probs=True``: their softmax;
``features=True``: the pooled embedding that classifier FID reads).  The
experiment protocol builds it as ResNet-18: ``n_blocks=(2, 2, 2, 2)``,
``n_channels=(64, 128, 256, 512)`` (``factory.build_classifier``).

What it keeps from the JAX module, each a difference from torchvision:

* only the first block of the whole stack strides (the reference's quirk):
  stages 2-4 change channels through the projection, not the resolution,
  so a 32px input runs them all at 8x8;
* the 1x1 shortcut conv has a bias; the stem and the 3x3 convs do not;
* BatchNorm is flax's (:class:`BatchNorm`): momentum 0.99 (torch's 0.01),
  eps 1e-5, the running variance updated with the BIASED batch variance
  (``nn.BatchNorm2d`` uses n/(n-1) of it), statistics in fp32;
* the initial weights are flax's: truncated-normal ``lecun_normal`` kernels,
  zero biases, unit BN scales (:meth:`ResNetBase.init_weights`).

Submodules carry the reference layout's names (``conv``, ``bn``,
``blocks.{i}.conv1`` / ``bn1`` / ``conv2`` / ``bn2`` (/ ``conv3`` / ``bn3``
in a bottleneck), ``blocks.{i}.shortcut.conv`` / ``.bn``,
``final_linear``), the layout of ``ldm_tpu/utils/torch_export.py::
resnet_state_dict_from_params``; ``utils/flax_import.py::resnet_from_flax``
turns a flax ``{"params", "batch_stats"}`` tree into it.

Layout and types as in the port's UNet: the public ``forward`` takes NHWC
and works on the channels_last NCHW view; parameters stay fp32 and are cast
to the compute ``dtype`` at each use; BatchNorm normalizes in fp32 and
returns the compute type; the logits and features are fp32.  Train or eval
mode is the module's (``model.train()`` is flax's ``train=True``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ldm_tpu_torch.models.unet import Conv2d, Linear

_CL = torch.channels_last
MOMENTUM = 0.99  # flax's: running = MOMENTUM * running + (1 - MOMENTUM) * batch
EPS = 1e-5


class BatchNorm(nn.BatchNorm2d):
    """flax ``nn.BatchNorm`` over the channels of an NCHW (channels_last)
    tensor: in training, normalize by the batch's mean and biased variance
    and move the running statistics toward them by ``1 - MOMENTUM``; in
    eval, normalize by the running statistics.  fp32 statistics, output in
    the input's dtype.  ``num_batches_tracked`` counts the training calls.

    Under data parallelism (``mesh``, set by :func:`sync_batch_norm`) the
    batch is the global one, as GSPMD's batch axis is in the JAX classifier:
    each process sums its rows' values and squares (fp64) and the processes
    all-reduce the sums and the count through a collective that autograd
    differentiates (its backward all-reduces the sums' gradients), then
    normalize and move the running statistics by the global mean and biased
    variance, with flax's momentum.  Torch's ``SyncBatchNorm`` is not used:
    it keeps torch's running-variance convention (unbiased), not flax's."""

    def __init__(self, num_features: int, device=None):
        super().__init__(num_features, eps=EPS, momentum=1.0 - MOMENTUM, device=device)
        self.mesh = None

    def _global(self, xf: torch.Tensor):
        """(normalized output, global mean, global biased variance)."""
        from torch.distributed.nn.functional import all_reduce

        c = xf.shape[1]
        sums = torch.cat([xf.sum((0, 2, 3), dtype=torch.float64),
                          (xf * xf).sum((0, 2, 3), dtype=torch.float64),
                          xf.new_full((1,), xf.numel() // c, dtype=torch.float64)])
        sums = all_reduce(sums, group=self.mesh.data_group)
        n = sums[2 * c]
        mean = sums[:c] / n
        var = (sums[c: 2 * c] / n - mean * mean).clamp_min(0.0)
        mean32, var32 = mean.float(), var.float()
        shape = (1, c, 1, 1)
        y = ((xf - mean32.view(shape)) * torch.rsqrt(var32 + self.eps).view(shape)
             * self.weight.view(shape) + self.bias.view(shape))
        return y, mean32.detach(), var32.detach()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            if self.mesh is not None:
                y, mean, var = self._global(xf)
            else:
                # one pass gives the output and the batch's mean and 1/sqrt(var + eps)
                y, mean, invstd = torch.native_batch_norm(xf, self.weight, self.bias, None,
                                                          None, True, 0.0, self.eps)
                var = invstd.detach().pow(-2).sub_(self.eps)  # the biased batch variance
            with torch.no_grad():
                for run, batch in ((self.running_mean, mean), (self.running_var, var)):
                    run.mul_(MOMENTUM).add_(batch * (1.0 - MOMENTUM))
                self.num_batches_tracked.add_(1)
        else:
            y = F.batch_norm(xf, self.running_mean, self.running_var, self.weight, self.bias,
                             False, 0.0, self.eps)
        return y.to(x.dtype, memory_format=_CL)


def sync_batch_norm(model: nn.Module, mesh) -> nn.Module:
    """Every :class:`BatchNorm` of ``model`` normalizes in training by the
    statistics of the global batch over ``mesh`` (None: its own rows)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.mesh = mesh
    return model


class Shortcut(nn.Module):
    """The 1x1 projection (with bias) + BatchNorm where a block changes shape."""

    def __init__(self, cin: int, cout: int, stride: int):
        super().__init__()
        self.conv = Conv2d(cin, cout, 1, stride=stride)
        self.bn = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.bn(self.conv(x))


class ResidualBlock(nn.Module):
    """conv3x3-BN-ReLU-conv3x3-BN + shortcut, ReLU."""

    def __init__(self, cin: int, cout: int, stride: int = 1):
        super().__init__()
        self.shortcut = Shortcut(cin, cout, stride) if stride != 1 or cin != cout else None
        self.conv1 = Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(cout)
        self.conv2 = Conv2d(cout, cout, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = self.bn2(self.conv2(h))
        return F.relu(h + shortcut)


class BottleneckResidualBlock(nn.Module):
    """1x1-BN-ReLU, 3x3 (strided)-BN-ReLU, 1x1-BN + shortcut, ReLU."""

    def __init__(self, cin: int, bottleneck: int, cout: int, stride: int = 1):
        super().__init__()
        self.shortcut = Shortcut(cin, cout, stride) if stride != 1 or cin != cout else None
        self.conv1 = Conv2d(cin, bottleneck, 1, bias=False)
        self.bn1 = BatchNorm(bottleneck)
        self.conv2 = Conv2d(bottleneck, bottleneck, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(bottleneck)
        self.conv3 = Conv2d(bottleneck, cout, 1, bias=False)
        self.bn3 = BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x if self.shortcut is None else self.shortcut(x)
        h = F.relu(self.bn1(self.conv1(x)))
        h = F.relu(self.bn2(self.conv2(h)))
        h = self.bn3(self.conv3(h))
        return F.relu(h + shortcut)


class ResNetBase(nn.Module):
    """Stacked residual blocks + linear head; the constructor surface of the
    JAX module (``img_channels``, ``out_channels``, ``n_blocks``,
    ``n_channels``, ``bottlenecks``, ``first_kernel_size``) plus the compute
    ``dtype`` and the ``device`` to build on.  The weights start from
    :meth:`init_weights` with ``seed``."""

    def __init__(self, img_channels: int = 3, out_channels: int = 10,
                 n_blocks: Sequence[int] = (2, 2, 2, 2),
                 n_channels: Sequence[int] = (64, 128, 256, 512),
                 bottlenecks: Optional[Sequence[int]] = None, first_kernel_size: int = 7,
                 dtype: torch.dtype = torch.float32, device=None, seed: int = 0):
        super().__init__()
        if len(n_blocks) != len(n_channels):
            raise ValueError(f"n_blocks {n_blocks} and n_channels {n_channels} differ in length")
        self.dtype = dtype
        k = first_kernel_size
        self.conv = Conv2d(img_channels, n_channels[0], k, stride=2, padding=k // 2, bias=False)
        self.bn = BatchNorm(n_channels[0])
        self.blocks = nn.ModuleList()
        cin = n_channels[0]
        for i, (n, cout) in enumerate(zip(n_blocks, n_channels)):
            for j in range(n):
                # only the very first block of the stack strides
                stride = 2 if i == 0 and j == 0 else 1
                if bottlenecks is None:
                    self.blocks.append(ResidualBlock(cin, cout, stride))
                else:
                    self.blocks.append(BottleneckResidualBlock(cin, bottlenecks[i], cout, stride))
                cin = cout
        self.final_linear = Linear(cin, out_channels)
        self.init_weights(seed)
        if device is not None:
            self.to(device)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """flax's initial state, drawn on the CPU from ``seed`` and copied in
        place (a captured train step keeps the tensors' addresses): every
        conv and dense kernel ``lecun_normal`` (a normal truncated at 2
        standard deviations, scaled to variance 1 / fan_in), biases 0, BN
        scales 1, running means 0 and variances 1."""
        gen = torch.Generator().manual_seed(int(seed))
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = int(np.prod(m.weight.shape[1:]))
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                w = torch.empty(m.weight.shape)
                nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.reset_running_stats()

    def forward(self, x: torch.Tensor, probs: bool = False,
                features: bool = False) -> torch.Tensor:
        """x: (B, H, W, C) NHWC.  Returns fp32 logits (B, out_channels), their
        softmax with ``probs``, or the pooled (B, C) embedding with
        ``features``."""
        h = self.bn(self.conv(x.to(self.dtype).permute(0, 3, 1, 2)))
        for block in self.blocks:
            h = block(h)
        h = h.mean(dim=(2, 3))  # global average pool, in the compute dtype
        if features:
            return h.to(torch.float32)
        logits = self.final_linear(h).to(torch.float32)
        return torch.softmax(logits, dim=-1) if probs else logits
