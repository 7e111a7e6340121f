"""The weight bridge: flax parameter trees -> the port's tensors.

The port's UNet names its submodules in the reference layout, so the bridge
is :func:`unet_state_dict_from_params` (the port's own copy of the UNet part
of ``ldm_tpu/utils/torch_export.py``; it imports nothing of the JAX package
and takes the tree's leaves as numpy arrays) plus ``torch.from_numpy``, and
``load_state_dict(strict=True)`` proves the key sets equal.  The export
takes care of the layout details: OIHW conv weights, the spatial flip of the
transposed convs, the zero time MLP of a ``bottleneck_time_emb=False``
bottleneck, and no time MLP on the final head block.  The autoencoder and
ResNet-classifier exporters come with their models.

The fused ResNet-block op (``ops/resnet_block.py``) takes the JAX op's
arguments; :func:`resnet_block_from_flax` makes them from a flax
``ResNetBlock`` tree and :func:`resnet_block_args` from the port's
``models.unet.ResNetBlock``, so the op can be held against either module.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch



def _np(v) -> np.ndarray:
    return np.asarray(v)


# ----------------------------------------------------------- layout conversions
def conv_weight(k: np.ndarray) -> np.ndarray:
    """flax conv kernel (kh, kw, I, O) -> torch Conv2d weight (O, I, kh, kw)."""
    return np.transpose(_np(k), (3, 2, 0, 1))


def linear_weight(k: np.ndarray) -> np.ndarray:
    return _np(k).T


def convT_weight(k: np.ndarray) -> np.ndarray:
    """flax (kh, kw, I, O) spatially-flipped -> torch ConvTranspose2d
    (I, O, kh, kw).  The flip turns flax's correlation into torch's transposed convolution."""
    return np.ascontiguousarray(
        np.transpose(_np(k)[::-1, ::-1], (2, 3, 0, 1))
    )


def conv1x1_from_dense(k: np.ndarray) -> np.ndarray:
    """dense kernel (I, O) -> torch 1x1 Conv2d weight (O, I, 1, 1)."""
    return _np(k).T[:, :, None, None]


def _put_conv(out: dict, pre: str, p: dict) -> None:
    out[f"{pre}.weight"] = conv_weight(p["kernel"])
    if "bias" in p:
        out[f"{pre}.bias"] = _np(p["bias"])


def _put_norm(out: dict, pre: str, p: dict) -> None:
    out[f"{pre}.weight"] = _np(p["scale"])
    out[f"{pre}.bias"] = _np(p["bias"])


def _put_linear(out: dict, pre: str, p: dict) -> None:
    out[f"{pre}.weight"] = linear_weight(p["kernel"])
    if "bias" in p:
        out[f"{pre}.bias"] = _np(p["bias"])


# ------------------------------------------------------------------------ UNet
def _put_unet_resblock(out: dict, pre: str, p: dict, time_dim: int) -> None:
    def put_block(b: str, bp: dict) -> None:
        _put_norm(out, f"{pre}.{b}.norm", bp["GroupNorm_0"])
        _put_conv(out, f"{pre}.{b}.conv2d", bp["Conv_0"])

    put_block("block1", p["Block_0"])
    put_block("block2", p["Block_1"])
    out_ch = _np(p["Block_1"]["Conv_0"]["kernel"]).shape[-1]
    if "Dense_0" in p:
        _put_linear(out, f"{pre}.mlp_t.1", p["Dense_0"])
    else:
        # reference blocks built with time_emb_dim always own these params
        out[f"{pre}.mlp_t.1.weight"] = np.zeros((out_ch, time_dim), np.float32)
        out[f"{pre}.mlp_t.1.bias"] = np.zeros((out_ch,), np.float32)
    if "Conv_0" in p:
        _put_conv(out, f"{pre}.shortcut", p["Conv_0"])


def _put_lin_attn(out: dict, pre: str, p: dict) -> None:
    out[f"{pre}.fn.norm.weight"] = _np(p["norm_pre_scale"])
    out[f"{pre}.fn.norm.bias"] = _np(p["norm_pre_bias"])
    out[f"{pre}.fn.fn.to_qkv.weight"] = conv1x1_from_dense(p["qkv_kernel"])
    out[f"{pre}.fn.fn.to_out.0.weight"] = conv1x1_from_dense(p["out_kernel"])
    out[f"{pre}.fn.fn.to_out.0.bias"] = _np(p["out_bias"])
    out[f"{pre}.fn.fn.to_out.1.weight"] = _np(p["norm_post_scale"])
    out[f"{pre}.fn.fn.to_out.1.bias"] = _np(p["norm_post_bias"])


def unet_state_dict_from_params(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A flax UNet tree (``{"params": ...}`` or bare; numpy or array-like
    leaves) -> the state_dict of numpy arrays that the port's UNet loads
    strictly: the UNet part of ``ldm_tpu/utils/torch_export.py``."""
    p = params.get("params", params)
    n_levels = 0
    while f"ConvTranspose_{n_levels}" in p:
        n_levels += 1
    if n_levels == 0:
        raise ValueError("no ConvTranspose_* keys — not a UNet parameter tree")
    time_dim = _np(p["TimeEmbedding_0"]["Dense_1"]["kernel"]).shape[-1]

    out: dict = {}
    _put_linear(out, "time_emb.time_mlp.1", p["TimeEmbedding_0"]["Dense_0"])
    _put_linear(out, "time_emb.time_mlp.3", p["TimeEmbedding_0"]["Dense_1"])
    if "Embed_0" in p:
        out["label_emb.weight"] = _np(p["Embed_0"]["embedding"])
    _put_conv(out, "initial_conv", p["Conv_0"])

    for i in range(n_levels):
        _put_unet_resblock(out, f"encoder.downs.{i}.0",
                           p[f"ResNetBlock_{i}"], time_dim)
        _put_lin_attn(out, f"encoder.downs.{i}.1", p[f"LinAttnBlock_{i}"])

    _put_unet_resblock(out, "bottleneck.res1",
                       p[f"ResNetBlock_{n_levels}"], time_dim)
    _put_norm(out, "bottleneck.attn.fn.norm",
              p["PreNormResidual_0"]["GroupNorm_0"])
    out["bottleneck.attn.fn.fn.to_qkv.weight"] = conv1x1_from_dense(
        p["Attention_0"]["Dense_0"]["kernel"])
    out["bottleneck.attn.fn.fn.to_out.weight"] = conv1x1_from_dense(
        p["Attention_0"]["Dense_1"]["kernel"])
    out["bottleneck.attn.fn.fn.to_out.bias"] = _np(
        p["Attention_0"]["Dense_1"]["bias"])
    _put_unet_resblock(out, "bottleneck.res2",
                       p[f"ResNetBlock_{n_levels + 1}"], time_dim)

    for i in range(n_levels):
        out[f"decoder.ups.{i}.2.weight"] = convT_weight(
            p[f"ConvTranspose_{i}"]["kernel"])
        out[f"decoder.ups.{i}.2.bias"] = _np(p[f"ConvTranspose_{i}"]["bias"])
        _put_unet_resblock(out, f"decoder.ups.{i}.0",
                           p[f"ResNetBlock_{n_levels + 2 + i}"], time_dim)
        _put_lin_attn(out, f"decoder.ups.{i}.1",
                      p[f"LinAttnBlock_{n_levels + i}"])

    _put_unet_resblock(out, "final_conv.0",
                       p[f"ResNetBlock_{2 * n_levels + 2}"], time_dim)
    # final head block carries no time MLP in the reference either
    del out["final_conv.0.mlp_t.1.weight"], out["final_conv.0.mlp_t.1.bias"]
    _put_conv(out, "final_conv.1", p["Conv_1"])
    return out


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
