"""Config -> component builders (port of ldm_tpu/factory.py).

The config is the port's own ``ldm_tpu_torch.config.Config``; ``use_amp``
selects bf16 compute with fp32 parameters, as in the JAX package.  ``load_config`` is re-exported here so that the port's callers
reach the config through the port alone.
"""

from __future__ import annotations

import dataclasses

import torch

from ldm_tpu_torch.config import Config, load_config
from ldm_tpu_torch.diffusion.sampling import SamplingProcess
from ldm_tpu_torch.registry import instantiate_from_config

__all__ = ["build_classifier", "build_diffusion", "build_model", "compute_dtype",
           "config_summary", "load_config"]


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


def build_diffusion(config: Config, device=None) -> SamplingProcess:
    """Instantiate the diffusion process from the ``diffusion:`` block
    (``GaussianDiffusion`` or ``RectifiedFlow``), with its tables on
    ``device``.  A ``parameterization`` in the model's params (what the
    network predicts, where Stable Diffusion's configs keep it) goes to the
    process too."""
    dc = config.diffusion
    params = {
        "n_steps": dc.n_steps,
        "n_samples": dc.n_samples,
        "schedule": dc.schedule,
        "beta_start": dc.beta_start,
        "beta_end": dc.beta_end,
    }
    if "parameterization" in config.model.params:
        params["parameterization"] = config.model.params["parameterization"]
    return instantiate_from_config({"target": dc.target, "params": params}, device=device)


def build_classifier(config: Config, img_channels: int, num_classes: int = 10, device=None):
    """The ResNet-18-shaped classifier the experiment protocol hardcodes
    (``ldm_tpu/factory.py::build_classifier``), computing in the config's
    dtype, on ``device``."""
    return instantiate_from_config(
        {"target": "ldm_tpu.models.resnet.ResNetBase",
         "params": {"img_channels": img_channels, "out_channels": num_classes,
                    "n_blocks": (2, 2, 2, 2), "n_channels": (64, 128, 256, 512)}},
        dtype=compute_dtype(config), device=device,
    )


def config_summary(config: Config) -> dict:
    return dataclasses.asdict(config)
