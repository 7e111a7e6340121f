"""Latent diffusion wiring: a DDPM over a frozen VAE's latents (port of
ldm_tpu/models/latent.py).

:class:`LatentDiffusionModel` holds the UNet (an eps model, or a v model such
as ``models/sd_unet.py::SDUNet`` at ``parameterization: v``), the frozen
autoencoder, the latent scaling factor (calibrated, or a fixed one such as
Stable Diffusion's :data:`SD_SCALING`) and a ``sqrt_linear``
``GaussianDiffusion`` of the UNet's parameterization; the encode
(``scale * sample(encode(image))``) and the decode (``decode(z / scale)``)
are its methods.  It is not an ``nn.Module``: the autoencoder's weights never
reach an optimizer.

Each decode is one ``sampler.decode`` record (``utils/profiling.py``: the
images, the host's ns, and on a card the CUDA timing events around it) and,
while torch's profiler runs, a ``sampler.decode`` range on the host's
timeline.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.sampling import NullCond
from ldm_tpu_torch.utils import profiling

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
    """A diffusion model over scaled VAE latents, of the model's
    parameterization (``eps_model.parameterization``, else "eps")."""

    def __init__(self, eps_model, autoencoder, latent_scaling_factor: float, n_steps: int,
                 linear_start: float, linear_end: float, device=None):
        self.eps_model = eps_model
        self.autoencoder = autoencoder.requires_grad_(False).eval()
        self.latent_scaling_factor = float(latent_scaling_factor)
        self.n_steps = int(n_steps)
        self.diffusion = GaussianDiffusion(
            n_steps, schedule="sqrt_linear", beta_start=linear_start, beta_end=linear_end,
            device=device,
            parameterization=getattr(eps_model, "parameterization", "eps"))

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
        """decode(z / scale), fp32 NHWC; ``scale`` defaults to the model's
        own.  Recorded as one ``sampler.decode``."""
        on = profiling.profiler_on()
        t0 = time.perf_counter_ns()
        timed = z.is_cuda and profiling.RECORDER.enabled and \
            not torch.cuda.is_current_stream_capturing()
        events = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) if timed else ()
        if timed:
            events[0].record()
        with profiling.host_range("sampler.decode", on):
            out = self.autoencoder.decode(z / (scale or self.latent_scaling_factor))
        if timed:
            events[1].record()
        profiling.record("sampler.decode", t0, on or profiling.profiler_on(),
                         images=int(z.shape[0]), host_ns=time.perf_counter_ns() - t0,
                         events=events)
        return out

    def apply_eps(self, x: torch.Tensor, t: torch.Tensor,
                  y: Optional[torch.Tensor]) -> torch.Tensor:
        """The eps model's prediction in latent space."""
        return self.eps_model(x, t, y)

    def sample_images(self, classes: torch.Tensor, latent_shape: Tuple[int, int, int],
                      cfg_scale: float = 3.0, sampler: str = "ddpm", n_sample_steps: int = 50,
                      null_cond: Optional[NullCond] = None, **kw) -> torch.Tensor:
        """Latents from a CFG sampler over the condition ``classes`` (labels,
        or a text encoder's contexts), then one decode of the batch.
        ``sampler``: "ddpm" (ancestral over every step) or "ddim" (over
        ``n_sample_steps``); ``null_cond``: the unconditional pass's
        condition (default the model's null label); ``kw`` go to the
        sampler."""
        null = self.eps_model.null_label if null_cond is None else null_cond
        if sampler == "ddpm":
            z0 = self.diffusion.sample(self.eps_model, classes, latent_shape,
                                       cfg_scale=cfg_scale, null_label=null, **kw)
        elif sampler == "ddim":
            z0 = self.diffusion.sample_ddim(self.eps_model, classes, latent_shape,
                                            n_sample_steps=n_sample_steps, cfg_scale=cfg_scale,
                                            null_label=null, **kw)
        else:
            raise ValueError(f"sampler must be 'ddpm' or 'ddim', got {sampler!r}")
        return self.autoencoder_decode(z0)
