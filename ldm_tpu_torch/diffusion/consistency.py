"""Consistency models: the boundary parameterisation and the few-step sampler
(port of ldm_tpu/diffusion/consistency.py).

A distilled student is the same eps-UNet; the consistency function wraps it:

    f(x, t) = c_skip(t) * x + c_out(t) * x0_pred(x, t)
    c_skip(t) = sd^2 / ((10 t)^2 + sd^2),  c_out(t) = 10 t / sqrt((10 t)^2 + sd^2)

with sd = 0.5 (LCM's discrete-timestep form), so ``f(x, 0) == x`` exactly and
``f ~= x0_pred`` elsewhere.  Sampling is 1-4 steps of ``f -> clip -> re-noise
-> f`` with guidance distilled in: one B-batch forward a step, no CFG pass.

The sampler runs through the loop of ``diffusion/sampling.py`` as a
:class:`~ldm_tpu_torch.diffusion.sampling.Method` of its own: a table of the
timesteps and a "first step" flag on the device, one step that re-noises the
carried x0 (all but the first step) and applies f, eagerly or as one step
captured into a CUDA graph and replayed.  Randomness is an input: ``x_init``
(x_T) and ``noise`` (t -> the re-noise draw of the step at t) can be given;
otherwise they come from ``generator``, or, with ``slot_generators``, from
one CPU generator a batch slot, so that a slot's images depend on its own
generator alone (what the serving layer's per-slot seeds need).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion, gather
from ldm_tpu_torch.diffusion.sampling import Method, ModelFn, NoiseFn
from ldm_tpu_torch.utils.graphs import use_graphs

SIGMA_DATA = 0.5
T_SCALE = 10.0


def boundary_scalings(t: torch.Tensor, sigma_data: float = SIGMA_DATA,
                      t_scale: float = T_SCALE) -> Tuple[torch.Tensor, torch.Tensor]:
    """(c_skip, c_out) per sample, (B, 1, 1, 1) fp32; exact at t=0."""
    st = (t.to(torch.float32) * t_scale).reshape(-1, 1, 1, 1)
    denom2 = st * st + sigma_data * sigma_data
    return (sigma_data * sigma_data) / denom2, st * torch.rsqrt(denom2)


def consistency_from_eps(diffusion: GaussianDiffusion, x: torch.Tensor, t: torch.Tensor,
                         eps: torch.Tensor, sigma_data: float = SIGMA_DATA,
                         t_scale: float = T_SCALE) -> torch.Tensor:
    """f(x, t) from the model's eps prediction at (x, t), fp32."""
    ab = gather(diffusion.schedule.alpha_bars, t)
    x32 = x.to(torch.float32)
    x0_pred = (x32 - torch.sqrt(1.0 - ab) * eps.to(torch.float32)) * torch.rsqrt(ab)
    c_skip, c_out = boundary_scalings(t, sigma_data, t_scale)
    return c_skip * x32 + c_out * x0_pred


def consistency_fn(diffusion: GaussianDiffusion, model: ModelFn, x: torch.Tensor,
                   t: torch.Tensor, y: torch.Tensor, sigma_data: float = SIGMA_DATA,
                   t_scale: float = T_SCALE) -> torch.Tensor:
    """f(x, t): one forward of ``model`` -> the trajectory's x_0 estimate (fp32)."""
    return consistency_from_eps(diffusion, x, t, model(x, t, y), sigma_data, t_scale)


def boundary_timesteps(n_steps: int, skip: int) -> np.ndarray:
    """Ascending distillation boundaries 0, skip, 2*skip, ..., n_steps-1
    (int32): adjacent pairs are the teacher-ODE segments the student learns
    to collapse."""
    if not 0 < skip < n_steps:
        raise ValueError(f"skip must be in (0, {n_steps}), got {skip}")
    sub = np.arange(0, n_steps, skip, dtype=np.int32)
    if sub[-1] != n_steps - 1:
        sub = np.append(sub, np.int32(n_steps - 1))
    return sub


def sampling_timesteps(n_steps: int, n_sample_steps: int) -> tuple:
    """Descending inference timesteps, top-down greedy halving: 1 step ->
    (T-1,); k steps -> T-1 and k-1 points t // 2 - 1 (T=400, 4 steps ->
    (399, 199, 99, 49))."""
    if n_sample_steps < 1:
        raise ValueError(f"n_sample_steps must be >= 1, got {n_sample_steps}")
    ts = [n_steps - 1]
    t = n_steps
    for _ in range(n_sample_steps - 1):
        t = t // 2
        ts.append(max(t - 1, 1))
    return tuple(ts)


def _method(diffusion: GaussianDiffusion, ts: Sequence[int], sigma_data: float,
            t_scale: float, clip: float) -> Method:
    """The sampler as the loop runs it: rows (t, first-step flag); the carry
    is x_T before the first step and the last x0 after each."""

    def update(method, rows, carry, z, predict):
        t_vec, first = rows
        x = carry[0]
        if z is not None:  # every step but the first re-noises the clipped x0 to t
            x0 = x.clamp(-clip, clip) if clip else x
            x = torch.where(first > 0, x, diffusion.q_sample(x0, t_vec, z))
        eps = predict(x, t_vec)
        return (consistency_from_eps(diffusion, x, t_vec, eps, sigma_data, t_scale),)

    def make() -> Method:
        t_host = np.asarray(ts, np.int64)
        first = np.zeros(len(t_host), np.float32)
        first[0] = 1.0
        tables = (diffusion._table(t_host, torch.int64), diffusion._table(first, torch.float32))
        return Method("consistency", t_host, tables, 1, len(t_host) > 1, key, update=update)

    key = ("consistency", tuple(int(t) for t in ts), float(sigma_data), float(t_scale),
           float(clip))
    return diffusion._method(key, make)


def _slot_noise(slot_generators: Sequence[torch.Generator], ts: Sequence[int],
                image_shape, device) -> NoiseFn:
    """The re-noise draws of every step after the first from each slot's own
    CPU generator (slot by slot, step by step), uploaded once; the first
    step's draw, which the update ignores, is zeros."""
    steps = len(ts) - 1
    z = torch.stack([torch.stack([torch.randn(tuple(image_shape), generator=g)
                                  for _ in range(steps)]) for g in slot_generators], dim=1)
    if device.type == "cuda":  # from pinned memory: a pageable upload would wait for the stream
        z = z.pin_memory()
    z = z.to(device, non_blocking=True)
    index = {int(t): i for i, t in enumerate(ts[1:])}
    zeros = torch.zeros_like(z[0])
    return lambda t: z[index[t]] if t in index else zeros


@torch.inference_mode()
def sample_consistency(
    diffusion: GaussianDiffusion,
    model: ModelFn,
    classes: torch.Tensor,
    image_shape: Tuple[int, int, int],
    ts: Sequence[int] = (),
    x_init: Optional[torch.Tensor] = None,
    noise: Optional[NoiseFn] = None,
    generator: Optional[torch.Generator] = None,
    slot_generators: Optional[Sequence[torch.Generator]] = None,
    sigma_data: float = SIGMA_DATA,
    t_scale: float = T_SCALE,
    clip: float = 1.0,
    graph: Optional[bool] = None,
) -> torch.Tensor:
    """Multistep consistency sampling (Song et al. 2023, alg. 1) from the
    distilled ``model`` (no guidance pass: one B-batch forward a step).

    Args:
      ts: the descending timesteps; x_T is injected at the first (default:
        the top trained timestep, one step).
      x_init: x_T, (B, H, W, C); drawn from ``generator`` if None.
      noise: t -> the (B, H, W, C) re-noise draw of the step at t (every
        entry of ``ts`` but the first).
      slot_generators: one CPU generator a slot: the re-noise draws come
        from them (``noise`` must be None), so a slot's output depends on
        its generator alone.
      graph: None: the replayed CUDA graph on a CUDA device (injected
        ``noise`` asks for the eager loop unless True), the eager loop
        elsewhere.

    Returns x_0 (B, H, W, C) fp32, unclipped."""
    ts = [int(t) for t in ts] or [diffusion.n_steps - 1]
    method = _method(diffusion, ts, sigma_data, t_scale, clip)
    if slot_generators is not None:
        if noise is not None:
            raise ValueError("pass noise or slot_generators, not both")
        if len(slot_generators) != classes.shape[0]:
            raise ValueError(f"{len(slot_generators)} slot generators for "
                             f"{classes.shape[0]} slots")
        if len(ts) > 1:
            noise = _slot_noise(slot_generators, ts, image_shape, classes.device)
        graph = use_graphs(classes.device, graph)
    return diffusion._loop(model, method, classes, image_shape, 0.0, None, x_init, noise,
                           generator, graph)
