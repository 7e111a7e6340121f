"""The weight bridge: flax parameter trees -> the port's tensors.

The port's UNet names its submodules in the reference layout that
``ldm_tpu.utils.torch_export.unet_state_dict_from_params`` already emits, so
the bridge is that function plus ``torch.from_numpy``, and
``load_state_dict(strict=True)`` proves the key sets equal.  The export
takes care of the layout details: OIHW conv weights, the spatial flip of the
transposed convs, the zero time MLP of a ``bottleneck_time_emb=False``
bottleneck, and no time MLP on the final head block.

The fused ResNet-block op (``ops/resnet_block.py``) takes the JAX op's
arguments; :func:`resnet_block_from_flax` makes them from a flax
``ResNetBlock`` tree and :func:`resnet_block_args` from the port's
``models.unet.ResNetBlock``, so the op can be held against either module.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ldm_tpu.utils.torch_export import unet_state_dict_from_params


def unet_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax UNet tree (``{"params": ...}`` or bare; numpy or array-like
    leaves) -> state_dict of float32 CPU tensors for the port's UNet."""
    sd = unet_state_dict_from_params(params)
    # np.array copies: arrays handed over from other frameworks may be read-only
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def resnet_block_from_flax(
    params: Dict[str, Any], time_emb: np.ndarray
) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """Flax ``ResNetBlock`` tree (``{"params": ...}`` or bare) and the raw
    time embedding (B, D) -> the op's arguments after x, (temb, n1s, n1b,
    w1, b1, n2s, n2b, w2, b2, ws, bs) as float32 CPU tensors, and whether
    the block has its 1x1 shortcut.  The module's Dense projection is
    applied here, ``temb = silu(time_emb) @ kernel + bias`` (zero rows for a
    block built without one); ws / bs are (1, 1) dummies without a
    shortcut."""
    p = params.get("params", params)

    def t(a) -> torch.Tensor:
        return torch.from_numpy(np.array(a, dtype=np.float32))

    blocks = [p["Block_0"], p["Block_1"]]
    cout = blocks[0]["Conv_0"]["kernel"].shape[-1]
    if "Dense_0" in p:
        raw = t(time_emb)
        temb = torch.nn.functional.silu(raw) @ t(p["Dense_0"]["kernel"]) + t(p["Dense_0"]["bias"])
    else:
        temb = torch.zeros((np.shape(time_emb)[0], cout))
    norm_conv = []
    for bp in blocks:
        norm_conv += [t(bp["GroupNorm_0"]["scale"]), t(bp["GroupNorm_0"]["bias"]),
                      t(bp["Conv_0"]["kernel"]), t(bp["Conv_0"]["bias"])]
    use_sc = "Conv_0" in p
    if use_sc:
        sc = (t(np.asarray(p["Conv_0"]["kernel"])[0, 0]), t(p["Conv_0"]["bias"]))
    else:
        sc = (torch.zeros((1, 1)), torch.zeros((1, 1)))
    return (temb, *norm_conv, *sc), use_sc


def resnet_block_args(
    module: torch.nn.Module, time_emb: Optional[torch.Tensor], batch: int = 1
) -> Tuple[Tuple[torch.Tensor, ...], bool]:
    """The port's ``models.unet.ResNetBlock`` (OIHW convs) and its raw time
    embedding -> the op's arguments after x, in the JAX op's layout (HWIO
    convs, projected temb; zeros of (batch, C_out) without a time MLP or
    time embedding), and whether the block has its 1x1 shortcut."""
    b1, b2 = module.block1, module.block2
    cout = b1.conv2d.out_channels
    if time_emb is not None and module.mlp_t is not None:
        temb = module.mlp_t(time_emb)
    else:
        n = batch if time_emb is None else time_emb.shape[0]
        temb = torch.zeros((n, cout), device=b1.conv2d.weight.device)
    norm_conv = []
    for blk in (b1, b2):
        norm_conv += [blk.norm.weight, blk.norm.bias,
                      blk.conv2d.weight.permute(2, 3, 1, 0).contiguous(), blk.conv2d.bias]
    use_sc = isinstance(module.shortcut, torch.nn.Conv2d)
    if use_sc:
        sc = (module.shortcut.weight[:, :, 0, 0].t().contiguous(), module.shortcut.bias)
    else:
        z = torch.zeros((1, 1), device=b1.conv2d.weight.device)
        sc = (z, z)
    return (temb, *norm_conv, *sc), use_sc
