"""Latent diffusion trainer: a DDPM over a frozen VAE's latents (port of
ldm_tpu/training/latent_trainer.py).

:class:`LatentDiffusionTrainer` is the diffusion trainer with its hooks
filled in: the frozen VAE's encode (``scale * z``, no gradient, outside the
optimizer) runs inside the train step, so on a card it is part of the
replayed CUDA graph and the latents never leave the device; the encode's
noise is drawn eagerly after the step's own draws, into the step's fixed
buffers.  Sampling runs the latent sampler (its replayed graph on a card)
and then one decoder forward.

The latent scaling factor is a number, or ``auto``: 1 / std of the latents
of the first 512 transformed training images, the latent noise drawn from a
CPU generator seeded by the config's seed (so the draws do not depend on
the device).  The resolved constant is written to
``<checkpoints>/latent_scaling.json``, which serving and later runs read: a
decode with another scale is this family's known failure, and the
protocol's negative control.

The first stage's weights are ``config.ae_checkpoint``, a state_dict that
``python -m ldm_tpu_torch.train_autoencoder`` writes (``autoencoder.pt``);
a path ending in ``.msgpack`` (the JAX package's) is read as the ``.pt`` of
the same stem: the port has no flax reader.  An empty ``ae_checkpoint`` gives
a randomly initialised frozen first stage, seeded by the config's seed.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.factory import compute_dtype
from ldm_tpu_torch.models.autoencoder import latent_shape_of
from ldm_tpu_torch.models.latent import LatentDiffusionModel, calibrate_latent_scaling
from ldm_tpu_torch.registry import instantiate_from_config
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.utils.logging import MetricsLogger

SCALING_FILE = "latent_scaling.json"
CALIBRATION_IMAGES = 512


def first_stage_path(ae_checkpoint: str) -> str:
    """The state_dict the port reads for ``ae_checkpoint``: the ``.pt`` of
    the same stem where it names a ``.msgpack``."""
    stem, ext = os.path.splitext(ae_checkpoint)
    return stem + ".pt" if ext == ".msgpack" else ae_checkpoint


def load_autoencoder(config: Config, device) -> torch.nn.Module:
    """The frozen first stage of a latent config (its ``autoencoder:``
    block, computing in the config's dtype) on ``device``: the weights of
    ``ae_checkpoint`` (strict), or a random init seeded by the config's seed
    where it is empty."""
    if config.autoencoder is None:
        raise ValueError("a latent config needs an autoencoder: block")
    block = {"target": config.autoencoder.target, "params": config.autoencoder.params}
    with torch.random.fork_rng(devices=[]):  # seeded init, the caller's RNG untouched
        torch.manual_seed(config.seed)
        ae = instantiate_from_config(block, dtype=compute_dtype(config))
    if config.ae_checkpoint:
        path = first_stage_path(config.ae_checkpoint)
        if not os.path.exists(path):
            raise FileNotFoundError(f"autoencoder checkpoint not found: {path} (train it "
                                    "with python -m ldm_tpu_torch.train_autoencoder)")
        ae.load_state_dict(torch.load(path, map_location="cpu", weights_only=True),
                           strict=True)
    else:
        print(f"no ae_checkpoint: a random frozen first stage from seed {config.seed}")
    return ae.to(device).requires_grad_(False).eval()


def resolve_latent_scaling(config: Config, autoencoder, train_loader) -> float:
    """``diffusion.latent_scaling_factor``: the number, or for ``auto``
    :func:`calibrate_latent_scaling` over the first 512 training images,
    transformed as the training batches are."""
    factor = config.diffusion.latent_scaling_factor
    if factor != "auto":
        return float(factor)
    device = next(autoencoder.parameters()).device
    images = train_loader.transform(train_loader.dataset.images[:CALIBRATION_IMAGES])
    images = torch.as_tensor(images).to(device, torch.float32)
    shape = (len(images),) + latent_shape_of(autoencoder, config.data.image_size)
    eps = torch.randn(shape, generator=torch.Generator().manual_seed(config.seed))
    return calibrate_latent_scaling(autoencoder, images, eps.to(device))


def load_latent_scaling(config: Config) -> float:
    """The factor a latent run resolved: the config's number, or for
    ``auto`` the one in ``<checkpoints>/latent_scaling.json``."""
    factor = config.diffusion.latent_scaling_factor
    if factor != "auto":
        return float(factor)
    path = os.path.join(config.checkpoints, SCALING_FILE)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"latent_scaling_factor is 'auto' but {path} does not exist: train the latent "
            "model first (the trainer writes it), or set a number in the config")
    with open(path) as f:
        return float(json.load(f)["latent_scaling_factor"])


def _persist_latent_scaling(config: Config, factor: float) -> None:
    os.makedirs(config.checkpoints, exist_ok=True)
    with open(os.path.join(config.checkpoints, SCALING_FILE), "w") as f:
        json.dump({"latent_scaling_factor": float(factor)}, f)


def build_ldm(config: Config, eps_model, autoencoder, factor: float,
              device=None) -> LatentDiffusionModel:
    """A config's :class:`LatentDiffusionModel` (its sqrt-linear schedule
    from the ``diffusion:`` block) on ``device``."""
    dc = config.diffusion
    return LatentDiffusionModel(eps_model, autoencoder, factor, dc.n_steps, dc.beta_start,
                                dc.beta_end, device=device)


def load_ldm(config: Config, eps_model, device) -> LatentDiffusionModel:
    """A trained latent config's model for sampling: its frozen first stage
    (:func:`load_autoencoder`) and the scale its run resolved
    (:func:`load_latent_scaling`)."""
    return build_ldm(config, eps_model, load_autoencoder(config, device),
                     load_latent_scaling(config), device)


class LatentDiffusionTrainer(DiffusionTrainer):
    """The diffusion trainer over ``ldm``'s latents (see the module's doc);
    writes the scaling factor beside its checkpoints."""

    def __init__(self, config: Config, ldm: LatentDiffusionModel, train_loader, val_loader,
                 classes, device=None, logger: Optional[MetricsLogger] = None,
                 graphs: Optional[bool] = None):
        self.ldm = ldm
        _persist_latent_scaling(config, ldm.latent_scaling_factor)
        z_shape = latent_shape_of(ldm.autoencoder, config.data.image_size)
        super().__init__(config, ldm.eps_model, ldm.diffusion, train_loader, val_loader,
                         classes, device=device, logger=logger, graphs=graphs,
                         input_shape=z_shape)

    @property
    def output_image_shape(self) -> Tuple[int, int, int]:
        d = self.config.data
        return (d.image_size, d.image_size, d.image_channels)

    def _encode(self, image: torch.Tensor, *enc: torch.Tensor) -> torch.Tensor:
        return self.ldm.autoencoder_encode(image, eps=enc[0])

    def _encode_draws(self, image, enc, generator) -> tuple:
        if enc is None:
            enc = torch.randn((image.shape[0],) + self.image_shape, generator=generator,
                              device=self.device)
        return (enc.to(self.device, torch.float32),)

    def _postprocess(self, z0: torch.Tensor, decode_scale_override: float = 0.0
                     ) -> torch.Tensor:
        """One decoder forward; ``decode_scale_override`` != 0 decodes
        ``z0 / override`` instead of ``z0 / scale`` (the negative control:
        Stable Diffusion's 0.18215 on another VAE)."""
        with torch.inference_mode():
            return self.ldm.autoencoder_decode(z0, decode_scale_override or None)
