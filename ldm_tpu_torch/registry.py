"""Config ``target:`` strings -> the port's classes.

The YAML configs name the JAX package's classes; this map sends each to its
PyTorch counterpart.  The reference's ``src.*`` names are aliases of them,
as in ``ldm_tpu/registry.py``.  A model the JAX package does not have goes
by the class name its source config gives (Stable Diffusion 2.x's U-Net:
``ldm.modules.diffusionmodules.openaimodel.UNetModel``).  ``register`` adds a name to the map, and
``resolve`` / ``instantiate_from_config`` read it as the JAX functions do.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.models.autoencoder import Autoencoder
from ldm_tpu_torch.models.latent import LatentDiffusionModel
from ldm_tpu_torch.models.resnet import ResNetBase
from ldm_tpu_torch.models.sd_unet import SDUNet
from ldm_tpu_torch.models.unet import UNet

TARGETS: Dict[str, Callable[..., Any]] = {
    "ldm_tpu.models.unet.UNet": UNet,
    "ldm_tpu.models.resnet.ResNetBase": ResNetBase,
    "ldm_tpu.models.autoencoder.Autoencoder": Autoencoder,
    "ldm_tpu.models.latent.LatentDiffusionModel": LatentDiffusionModel,
    "ldm_tpu.diffusion.ddpm.GaussianDiffusion": GaussianDiffusion,
    "ldm_tpu.diffusion.flow.RectifiedFlow": RectifiedFlow,
    "ldm.modules.diffusionmodules.openaimodel.UNetModel": SDUNet,
}
# the reference's target strings
TARGET_ALIASES: Dict[str, str] = {
    "src.DDPM.Diffusion": "ldm_tpu.diffusion.ddpm.GaussianDiffusion",
    "src.UNet.UNet": "ldm_tpu.models.unet.UNet",
    "src.Autoencoder.Autoencoder": "ldm_tpu.models.autoencoder.Autoencoder",
    "src.ResNetClassifier.ResNetBase": "ldm_tpu.models.resnet.ResNetBase",
    "src.LatentDiffusionModel.LatentDiffusionModel": "ldm_tpu.models.latent.LatentDiffusionModel",
}

# constructor keywords of the reference's configs that mean nothing here
# (the torch-era ``device: cuda``; the caller passes the device)
_IGNORED_PARAMS = ("device",)


def register(name: str) -> Callable[[Callable[..., Any]], Callable[..., Any]]:
    """Class or function decorator: add a component to ``TARGETS`` under
    ``name``."""

    def deco(obj: Callable[..., Any]) -> Callable[..., Any]:
        TARGETS[name] = obj
        return obj

    return deco


def resolve(target: str) -> Callable[..., Any]:
    """The constructor of a target string (a JAX dotted name, or a
    reference alias of one)."""
    target = TARGET_ALIASES.get(target, target)
    if target not in TARGETS:
        raise KeyError(f"Unknown component target {target!r}; known: {sorted(TARGETS)}")
    return TARGETS[target]


def instantiate_from_config(cfg: Dict[str, Any], **extra: Any) -> Any:
    """Build a component from a ``{"target": ..., "params": {...}}`` mapping:
    the params without ``device``, then ``extra`` over them."""
    if "target" not in cfg:
        raise KeyError(f"config has no 'target': {cfg}")
    ctor = resolve(cfg["target"])
    params = dict(cfg.get("params") or {})
    for bad in _IGNORED_PARAMS:
        params.pop(bad, None)
    params.update(extra)
    return ctor(**params)
