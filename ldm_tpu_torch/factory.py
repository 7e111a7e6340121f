"""Config -> component builders (port of ldm_tpu/factory.py).

The config is the port's own ``ldm_tpu_torch.config.Config``; ``use_amp``
selects bf16 compute with fp32 parameters, as in the JAX package.  ``load_config`` is re-exported here so that the port's callers
reach the config through the port alone.
"""

from __future__ import annotations

import torch

from ldm_tpu_torch.config import Config, load_config
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.registry import instantiate_from_config

__all__ = ["build_diffusion", "build_model", "compute_dtype", "load_config"]


def compute_dtype(config: Config) -> torch.dtype:
    return torch.bfloat16 if config.use_amp else torch.float32


def build_model(config: Config, device=None, **overrides):
    """Instantiate the eps-model (UNet) from the ``model:`` block on
    ``device``; ``overrides`` (e.g. ``attention_impl="torch"``) go to its
    constructor."""
    mc = config.model
    return instantiate_from_config(
        {"target": mc.target, "params": mc.params},
        dtype=compute_dtype(config), device=device, **overrides,
    )


def build_diffusion(config: Config, device=None) -> GaussianDiffusion:
    """Instantiate the diffusion process from the ``diffusion:`` block, with
    its schedule on ``device``."""
    dc = config.diffusion
    return instantiate_from_config(
        {
            "target": dc.target,
            "params": {
                "n_steps": dc.n_steps,
                "n_samples": dc.n_samples,
                "schedule": dc.schedule,
                "beta_start": dc.beta_start,
                "beta_end": dc.beta_end,
            },
        },
        device=device,
    )
