"""Config ``target:`` strings -> the port's classes.

The YAML configs name the JAX package's classes; this map sends each to its
PyTorch counterpart.  Only what the port carries is mapped.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.models.resnet import ResNetBase
from ldm_tpu_torch.models.unet import UNet

TARGETS: Dict[str, Callable[..., Any]] = {
    "ldm_tpu.models.unet.UNet": UNet,
    "ldm_tpu.models.resnet.ResNetBase": ResNetBase,
    "ldm_tpu.diffusion.ddpm.GaussianDiffusion": GaussianDiffusion,
    "ldm_tpu.diffusion.flow.RectifiedFlow": RectifiedFlow,
}


def instantiate_from_config(cfg: Dict[str, Any], **extra: Any) -> Any:
    """Build a component from a ``{"target": ..., "params": {...}}`` mapping."""
    target = cfg["target"]
    if target not in TARGETS:
        raise KeyError(
            f"target {target!r} has no PyTorch port yet; ported: {sorted(TARGETS)}"
        )
    return TARGETS[target](**(cfg.get("params") or {}), **extra)
