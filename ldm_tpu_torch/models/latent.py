"""Latent diffusion wiring: a DDPM over a frozen VAE's latents (port of
ldm_tpu/models/latent.py).

:class:`LatentDiffusionModel` holds the eps-UNet, the frozen autoencoder, the
latent scaling factor and a ``sqrt_linear`` ``GaussianDiffusion``; the
encode (``scale * sample(encode(image))``) and the decode
(``decode(z / scale)``) are its methods.  It is not an ``nn.Module``: the
autoencoder's weights never reach an optimizer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion

SD_SCALING = 0.18215  # Stable Diffusion's constant: 1/std of ITS VAE's latents


@torch.no_grad()
def calibrate_latent_scaling(autoencoder, images: torch.Tensor,
                             eps: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None) -> float:
    """1 / std of sampled latents over a calibration batch (NHWC [-1, 1]),
    the population std (ddof 0, as ``jnp.std``), in fp32.  ``eps`` (the
    latents' shape) is drawn from ``generator`` if not given."""
    moments = autoencoder.encode_moments(images)
    z = autoencoder.sample_latent(moments, eps, generator)
    return float(1.0 / z.to(torch.float32).std(correction=0))


class LatentDiffusionModel:
    """An eps-model over scaled VAE latents."""

    def __init__(self, eps_model, autoencoder, latent_scaling_factor: float, n_steps: int,
                 linear_start: float, linear_end: float, device=None):
        self.eps_model = eps_model
        self.autoencoder = autoencoder.requires_grad_(False).eval()
        self.latent_scaling_factor = float(latent_scaling_factor)
        self.n_steps = int(n_steps)
        self.diffusion = GaussianDiffusion(n_steps, schedule="sqrt_linear",
                                           beta_start=linear_start, beta_end=linear_end,
                                           device=device)

    @torch.no_grad()
    def autoencoder_encode(self, image: torch.Tensor, eps: Optional[torch.Tensor] = None,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """scale * z, z sampled from the VAE's posterior (``eps`` injectable)."""
        moments = self.autoencoder.encode_moments(image)
        return self.latent_scaling_factor * self.autoencoder.sample_latent(moments, eps,
                                                                            generator)

    @torch.no_grad()
    def autoencoder_decode(self, z: torch.Tensor, scale: Optional[float] = None
                           ) -> torch.Tensor:
        """decode(z / scale), fp32 NHWC; ``scale`` defaults to the calibrated one."""
        return self.autoencoder.decode(z / (scale or self.latent_scaling_factor))

    def sample_images(self, classes: torch.Tensor, latent_shape: Tuple[int, int, int],
                      cfg_scale: float = 3.0, **kw) -> torch.Tensor:
        """Latents from the ancestral CFG sampler (``kw`` go to it), then
        one decode to images."""
        z0 = self.diffusion.sample(self.eps_model, classes, latent_shape, cfg_scale=cfg_scale,
                                   null_label=self.eps_model.null_label, **kw)
        return self.autoencoder_decode(z0)
