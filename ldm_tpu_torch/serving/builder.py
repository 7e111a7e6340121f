"""Config and checkpoint -> a ready :class:`GenerationService` (the twin of
``ldm_tpu/serving/builder.py``: the pixel DDPM, the rectified flow and the
latent family).

The service samples through the port's samplers (``run_sampler``): DDIM
(the default: 50 steps, eta 0, deterministic, so a request's images do not
depend on how the batcher packed it), the ancestral DDPM loop over all T
steps, or DPM-Solver++(2M) (deterministic too, DDIM-50-class quality at
10-15 steps).  A rectified-flow config maps them as the JAX builder's duck
typing does: ``ddim`` to Euler, ``dpmpp`` to Heun, ``ddpm`` to Euler over
``n_steps`` (all deterministic).  On a CUDA device each runs as one step
captured into a CUDA graph and replayed (``diffusion/sampling.py``).

The weights are the state_dict the port's trainer writes:
``<checkpoints>/diffusion_model_ema.pt`` (``use_ema``) or
``diffusion_model.pt``, loaded strictly.  ``sampler="consistency"`` serves a
distilled student (``python -m ldm_tpu_torch.distill``; the weights default
to ``consistency_model_ema.pt``) in ``ddim_steps`` guidance-free steps, each
slot's re-noise drawn from its own generator, so multistep sampling stays
independent of the batching too.  A ``type: latent`` config samples the
latent UNet over the VAE's latents and decodes each batch with the frozen
first stage at the scale the trainer resolved (``latent_scaling.json`` for
``auto``; ``training/latent_trainer.py::load_ldm``).

``mesh``, a list of local devices (the JAX builder's mesh over local chips),
builds one replica a device, each with its own copy of the weights and its
own captured sampler, and the service splits every batch's slots over them.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.diffusion.sampling import SamplingProcess
from ldm_tpu_torch.factory import build_diffusion, build_model
from ldm_tpu_torch.models.autoencoder import latent_shape_of
from ldm_tpu_torch.serving.service import GenerationService, XInitFn
from ldm_tpu_torch.training.diffusion_trainer import CONSISTENCY, SAMPLERS, run_sampler
from ldm_tpu_torch.training.latent_trainer import load_ldm


def checkpoint_path(config: Config, use_ema: bool = True, stem: str = "diffusion_model") -> str:
    """Where the port's trainers leave the best weights (``stem``
    ``consistency_model``: the distilled student)."""
    return os.path.join(config.checkpoints, f"{stem}_ema.pt" if use_ema else f"{stem}.pt")


def sampler_checkpoint(config: Config, use_ema: bool, sampler: str) -> str:
    """The weights ``sampler`` reads by default: the distilled student's for
    ``consistency``, else the diffusion model's."""
    stem = "consistency_model" if sampler == CONSISTENCY else "diffusion_model"
    return checkpoint_path(config, use_ema, stem)


def load_sampler(config: Config, checkpoint: Optional[str] = None, use_ema: bool = True,
                 device="cuda") -> Tuple[torch.nn.Module, SamplingProcess]:
    """The UNet with the checkpoint's weights (strict), in eval mode on
    ``device``, and the config's process there (``GaussianDiffusion`` or
    ``RectifiedFlow``)."""
    checkpoint = checkpoint or checkpoint_path(config, use_ema)
    if not os.path.exists(checkpoint):
        raise FileNotFoundError(f"diffusion checkpoint not found: {checkpoint} (train "
                                "first, or name the weights: serve's --checkpoint, "
                                "generate's --weights)")
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
    mesh: Optional[Sequence] = None,
) -> GenerationService:
    """Build (not start) a GenerationService for a pixel config on ``device``.

    Args:
      checkpoint: a UNet state_dict (``.pt``); by default the config's run
        directory's best weights (the EMA copy with ``use_ema``; the
        distilled student's for ``consistency``).
      sampler: ``ddim`` (``ddim_steps``, ``eta``), ``ddpm``, ``dpmpp``
        (``ddim_steps`` steps) or ``consistency`` (``ddim_steps`` steps).
      cfg_scale: the guidance scale; by default the config's.
      x_init_fn: see :class:`GenerationService`.
      mesh: local devices, one replica each (``device`` is then unused);
        ``batch_size`` must divide by their count.
    """
    if sampler not in SAMPLERS + (CONSISTENCY,):
        raise ValueError(f"sampler must be one of {SAMPLERS + (CONSISTENCY,)}, got {sampler!r}")
    consistency = sampler == CONSISTENCY
    cfg = config.diffusion.cfg_scale if cfg_scale is None else cfg_scale
    d = config.data
    pixel_shape = (d.image_size, d.image_size, d.image_channels)
    checkpoint = checkpoint or sampler_checkpoint(config, use_ema, sampler)
    devices = [torch.device(dv) for dv in (mesh if mesh is not None else [device])]
    if mesh is not None and (not devices or batch_size % len(devices)):
        raise ValueError(f"batch_size={batch_size} must divide by the mesh's "
                         f"{len(devices)} devices")

    def replica(dev):
        model, diffusion = load_sampler(config, checkpoint, use_ema, dev)
        shape, decode = pixel_shape, None
        if config.type == "latent":
            ldm = load_ldm(config, model, dev)
            diffusion, decode = ldm.diffusion, ldm.autoencoder_decode
            shape = latent_shape_of(ldm.autoencoder, d.image_size)

        def sample_fn(classes, x_init, generator, slot_generators=None):
            kw = {"slot_generators": slot_generators} if consistency else {}
            x0 = run_sampler(diffusion, sampler, model, classes, shape, ddim_steps=ddim_steps,
                             eta=eta, cfg_scale=cfg, null_label=model.null_label,
                             x_init=x_init, generator=generator, **kw)
            return x0 if decode is None else decode(x0)
        return sample_fn, shape

    replicas = [replica(dv) for dv in devices]
    shape = replicas[0][1]
    fns = [fn for fn, _ in replicas]
    return GenerationService(
        fns[0] if mesh is None else fns, image_shape=shape, out_shape=pixel_shape,
        num_classes=d.num_classes, batch_size=batch_size, max_delay_s=max_delay_s,
        base_seed=config.seed if base_seed is None else base_seed, per_slot_keys=consistency,
        use_native=use_native, device=devices[0], x_init_fn=x_init_fn,
        devices=None if mesh is None else devices)
