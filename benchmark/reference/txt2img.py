"""The plain reference of Stable Diffusion 2.x's text-to-image sampling with a
v-predicting U-Net, in float32: DDIM with classifier-free guidance over a
text context, then the first stage's decode (Stability-AI/stablediffusion
``scripts/txt2img.py`` with ``ldm/models/diffusion/ddim.py``; Salimans and
Ho 2022 for v; Song et al. 2021 for DDIM).

* Guidance: one prediction at the prompt's context and one at the empty
  prompt's, ``uncond + s (cond - uncond)``, on the model output (v).
* From v at x_t: eps = sqrt(abar) v + sqrt(1 - abar) x_t and
  x_0 = sqrt(abar) x_t - sqrt(1 - abar) v.
* DDIM, eta 0: x_prev = sqrt(abar_prev) x_0 + sqrt(1 - abar_prev) eps over
  ``reference/diffusion.py::ddim_steps`` (timesteps spread evenly over
  [0, T - 1], rounded, descending; the last step goes to x_0).  The source's
  ``ddim_discretize="uniform"`` takes 1, 21, ..., 981 and ends at abar of
  step 1: that departure is the program's too, and is stated in the
  configuration's ``assumed``.
* The decode: ``reference/vae.py::RefVAE`` of z_0 / scale_factor.

The schedule is ``reference/diffusion.py::Schedule`` (sqrt-linear betas).
"""

from __future__ import annotations

from typing import Callable

import torch

from benchmark.reference.diffusion import Schedule, ddim_steps

Model = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def guided(model: Model, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
           null_ctx: torch.Tensor, scale: float) -> torch.Tensor:
    """The guided prediction at (x, t): ``null_ctx`` is one item's empty
    prompt context, broadcast over the batch."""
    cond = model(x, t, ctx)
    uncond = model(x, t, null_ctx.expand_as(ctx))
    return uncond + scale * (cond - uncond)


def from_v(s: Schedule, x: torch.Tensor, step: int, v: torch.Tensor):
    """(eps, x_0) of a v prediction at x_t, timestep ``step``."""
    ab = s.abar[step]
    return torch.sqrt(ab) * v + torch.sqrt(1.0 - ab) * x, \
        torch.sqrt(ab) * x - torch.sqrt(1.0 - ab) * v


def ddim_v(s: Schedule, model: Model, x: torch.Tensor, ctx: torch.Tensor,
           null_ctx: torch.Tensor, scale: float, n: int) -> torch.Tensor:
    """``n`` DDIM steps (eta 0) from x_T with a v model under guidance."""
    ts = ddim_steps(s.n_steps, n)
    for step, prev in zip(ts, ts[1:] + [-1]):
        t = torch.full((x.shape[0],), step, dtype=torch.int64, device=x.device)
        eps, x0 = from_v(s, x, step, guided(model, x, t, ctx, null_ctx, scale))
        ab_prev = s.abar[prev] if prev >= 0 else torch.ones_like(s.abar[0])
        x = torch.sqrt(ab_prev) * x0 + torch.sqrt(1.0 - ab_prev) * eps
    return x
