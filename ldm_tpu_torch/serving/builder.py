"""Config and checkpoint -> a ready :class:`GenerationService` (the twin of
``ldm_tpu/serving/builder.py``, pixel family).

The service samples through the port's samplers (``run_sampler``): DDIM
(the default: 50 steps, eta 0, deterministic, so a request's images do not
depend on how the batcher packed it), the ancestral DDPM loop over all T
steps, or DPM-Solver++(2M) (deterministic too, DDIM-50-class quality at
10-15 steps).  On a CUDA device each runs as one step captured into a CUDA
graph and replayed (``diffusion/ddpm.py``).

The weights are the state_dict the port's trainer writes:
``<checkpoints>/diffusion_model_ema.pt`` (``use_ema``) or
``diffusion_model.pt``, loaded strictly.  Latent configs and the distilled
consistency sampler are not ported yet (ROADMAP queue 1, items 10-11).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.factory import build_diffusion, build_model
from ldm_tpu_torch.serving.service import GenerationService, XInitFn
from ldm_tpu_torch.training.diffusion_trainer import SAMPLERS, run_sampler

NOT_PORTED = "not ported yet: it waits for ROADMAP queue 1, items 10-11"


def checkpoint_path(config: Config, use_ema: bool = True) -> str:
    """Where the port's trainer leaves the best weights."""
    name = "diffusion_model_ema.pt" if use_ema else "diffusion_model.pt"
    return os.path.join(config.checkpoints, name)


def load_sampler(config: Config, checkpoint: Optional[str] = None, use_ema: bool = True,
                 device="cuda") -> Tuple[torch.nn.Module, GaussianDiffusion]:
    """The UNet with the checkpoint's weights (strict), in eval mode on
    ``device``, and the config's diffusion process there."""
    if config.type == "latent":
        raise ValueError(f"latent serving is {NOT_PORTED}")
    checkpoint = checkpoint or checkpoint_path(config, use_ema)
    if not os.path.exists(checkpoint):
        raise FileNotFoundError(f"diffusion checkpoint not found: {checkpoint} "
                                "(train first, or pass --checkpoint)")
    device = torch.device(device)
    model = build_model(config)
    model.load_state_dict(torch.load(checkpoint, map_location="cpu", weights_only=True),
                          strict=True)
    return model.to(device).eval(), build_diffusion(config, device)


def build_generation_service(
    config: Config,
    checkpoint: Optional[str] = None,
    *,
    use_ema: bool = True,
    sampler: str = "ddim",
    ddim_steps: int = 50,
    eta: float = 0.0,
    cfg_scale: Optional[float] = None,
    batch_size: int = 64,
    max_delay_s: float = 0.02,
    base_seed: Optional[int] = None,
    use_native: bool = True,
    device="cuda",
    x_init_fn: Optional[XInitFn] = None,
) -> GenerationService:
    """Build (not start) a GenerationService for a pixel config on ``device``.

    Args:
      checkpoint: a UNet state_dict (``.pt``); by default the config's run
        directory's best weights (the EMA copy with ``use_ema``).
      sampler: ``ddim`` (``ddim_steps``, ``eta``), ``ddpm`` or ``dpmpp``
        (``ddim_steps`` steps).
      cfg_scale: the guidance scale; by default the config's.
      x_init_fn: see :class:`GenerationService`.
    """
    if sampler == "consistency":
        raise ValueError(f"the consistency sampler is {NOT_PORTED}")
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
    cfg = config.diffusion.cfg_scale if cfg_scale is None else cfg_scale
    d = config.data
    shape = (d.image_size, d.image_size, d.image_channels)
    model, diffusion = load_sampler(config, checkpoint, use_ema, device)

    def sample_fn(classes, x_init, generator):
        return run_sampler(diffusion, sampler, model, classes, shape, ddim_steps=ddim_steps,
                           eta=eta, cfg_scale=cfg, null_label=model.null_label,
                           x_init=x_init, generator=generator)

    return GenerationService(
        sample_fn, image_shape=shape, num_classes=d.num_classes, batch_size=batch_size,
        max_delay_s=max_delay_s, base_seed=config.seed if base_seed is None else base_seed,
        use_native=use_native, device=device, x_init_fn=x_init_fn)
