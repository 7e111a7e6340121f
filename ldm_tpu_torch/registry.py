"""Config ``target:`` strings -> the port's classes.

The YAML configs name the JAX package's classes; this map sends each to its
PyTorch counterpart.  The reference's ``src.*`` names are aliases of them,
as in ``ldm_tpu/registry.py``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.models.autoencoder import Autoencoder
from ldm_tpu_torch.models.latent import LatentDiffusionModel
from ldm_tpu_torch.models.resnet import ResNetBase
from ldm_tpu_torch.models.unet import UNet

TARGETS: Dict[str, Callable[..., Any]] = {
    "ldm_tpu.models.unet.UNet": UNet,
    "ldm_tpu.models.resnet.ResNetBase": ResNetBase,
    "ldm_tpu.models.autoencoder.Autoencoder": Autoencoder,
    "ldm_tpu.models.latent.LatentDiffusionModel": LatentDiffusionModel,
    "ldm_tpu.diffusion.ddpm.GaussianDiffusion": GaussianDiffusion,
    "ldm_tpu.diffusion.flow.RectifiedFlow": RectifiedFlow,
}
# the reference's target strings
TARGET_ALIASES: Dict[str, str] = {
    "src.DDPM.Diffusion": "ldm_tpu.diffusion.ddpm.GaussianDiffusion",
    "src.UNet.UNet": "ldm_tpu.models.unet.UNet",
    "src.Autoencoder.Autoencoder": "ldm_tpu.models.autoencoder.Autoencoder",
    "src.ResNetClassifier.ResNetBase": "ldm_tpu.models.resnet.ResNetBase",
    "src.LatentDiffusionModel.LatentDiffusionModel": "ldm_tpu.models.latent.LatentDiffusionModel",
}


def instantiate_from_config(cfg: Dict[str, Any], **extra: Any) -> Any:
    """Build a component from a ``{"target": ..., "params": {...}}`` mapping."""
    target = TARGET_ALIASES.get(cfg["target"], cfg["target"])
    if target not in TARGETS:
        raise KeyError(
            f"target {target!r} has no PyTorch port yet; ported: {sorted(TARGETS)}"
        )
    return TARGETS[target](**(cfg.get("params") or {}), **extra)
