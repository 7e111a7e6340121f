"""Rectified flow / flow matching (port of ldm_tpu/diffusion/flow.py).

    x_t = (1 - t) x_0 + t eps,          t ~ U(0, 1),  eps ~ N(0, I)
    target velocity  v = dx_t/dt = eps - x_0
    loss             E || v_theta(x_t, t, y) - (eps - x_0) ||^2

The velocity model is the UNet; its time input is ``t * (n_steps - 1)`` as
an fp32 timestep, so the sinusoidal embedding works in the band of a T-step
DDPM.  Sampling integrates dx/dt = v_theta from t = 1 to t = 0 with Euler or
Heun steps, with CFG on the velocity as on eps.

:class:`RectifiedFlow` has the surface of the port's ``GaussianDiffusion``
that the trainer, the entry points and the service call: ``noise_batch`` /
``draw_t_eps`` / ``noised`` put the VELOCITY in the target slot, and the
sampler slots map ``sample`` to Euler over ``n_steps``, ``sample_ddim`` to
Euler and ``sample_dpmpp`` to Heun.  Both solvers run through the loop the
DDPM samplers run (``diffusion/sampling.py``): one step (one forward for
Euler, two for Heun) replayed as a CUDA graph on a card.

The time tables are built in fp32 on the host as the JAX package builds them
(``arange(n, 0, -1, float32) / n`` and Heun's ``t - 1/n``), times
``n_steps - 1``.  ``ode_direction = -1`` integrates the ODE the wrong way
(``dt = -1/n`` on the same t: 1 -> 0 grid): the family's negative control.
It is part of the method, so of the graph cache's key.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_tpu_torch.diffusion.sampling import (
    Method,
    ModelFn,
    PredictFn,
    SamplingProcess,
)


class RectifiedFlow(SamplingProcess):
    """Continuous-time rectified flow with the GaussianDiffusion surface.

    ``n_steps`` scales the time input (``t * (n_steps - 1)``) and is the
    Euler step count of :meth:`sample`; ``schedule`` / ``beta_start`` /
    ``beta_end`` are accepted for the config surface and ignored (a flow has
    no beta schedule).  The step tables live on ``device``.
    """

    def __init__(self, n_steps: int = 1000, n_samples: int = 1, schedule: str = "linear",
                 beta_start: float = 1e-4, beta_end: float = 0.02, device=None):
        super().__init__()
        del schedule, beta_start, beta_end  # no beta schedule in a flow
        self.n_steps = int(n_steps)
        self.n_samples = int(n_samples)
        self.device = torch.device(device if device is not None else "cpu")

    # ------------------------------------------------------------ time scale
    def t_embed(self, t: torch.Tensor) -> torch.Tensor:
        """Continuous t in [0, 1] -> the model's fp32 timestep input."""
        return t.to(torch.float32) * (self.n_steps - 1)

    # ------------------------------------------------------------ forward (q)
    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """x_t on the straight path: (1 - t) x_0 + t eps; ``t`` in [0, 1], (B,)."""
        tb = t.to(torch.float32).reshape(-1, 1, 1, 1)
        return (1.0 - tb) * x0 + tb * eps.to(x0.dtype)

    def draw_t_eps(self, x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(t ~ U(0, 1) fp32 (B,), eps ~ N(0, I)) on x0's device; what is not
        given is drawn from ``generator``, t first."""
        if (t is None or eps is None) and generator is None:
            raise ValueError("pass a generator, or both t and eps")
        if t is None:
            t = torch.rand((x0.shape[0],), generator=generator, device=x0.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                              dtype=x0.dtype)
        return t.to(x0.device, torch.float32), eps.to(x0.device, x0.dtype)

    def noised(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(v target = eps - x_0 in fp32, x_t, the model's time input) for
        drawn ``t`` and ``eps``: the trainer's ``mean((target - out)^2)`` is
        then the flow-matching objective."""
        v = eps.to(torch.float32) - x0.to(torch.float32)
        return v, self.q_sample(x0, t, eps), self.t_embed(t)

    def noise_batch(self, x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`draw_t_eps`, then :meth:`noised`: (v target, x_t, time input)."""
        return self.noised(x0, *self.draw_t_eps(x0, t, eps, generator))

    # --------------------------------------------------------------- sampling
    def _update(self, method: Method, rows: Sequence[torch.Tensor],
                carry: Sequence[torch.Tensor], z: Optional[torch.Tensor],
                predict: PredictFn) -> Tuple[torch.Tensor, ...]:
        """An Euler step, or Heun's: the predictor's Euler step, a second
        velocity at ``t - 1/n`` on it, then the averaged update."""
        xt = carry[0]
        v1 = predict(xt, rows[0])
        x_pred = xt - method.dt * v1
        if method.name == "heun":
            v2 = predict(x_pred, rows[1].expand(xt.shape[0]))
            return (xt - method.dt * 0.5 * (v1 + v2),)
        return (x_pred,)

    def _solve(self, model: ModelFn, classes: torch.Tensor, image_shape: Tuple[int, int, int],
               n_sample_steps: int, cfg_scale: float, null_label: Optional[int],
               x_init: Optional[torch.Tensor], solver: str, ode_direction: float,
               generator: Optional[torch.Generator], graph: Optional[bool]) -> torch.Tensor:
        """Integrate dx/dt = v_theta from t = 1 to t = 0 in ``n_sample_steps``
        steps of ``solver`` ("euler" or "heun")."""
        n = max(1, int(n_sample_steps))
        direction = float(ode_direction)

        def make():
            ts = np.arange(n, 0, -1, dtype=np.float32) / np.float32(n)  # 1, ..., 1/n
            scale = np.float32(self.n_steps - 1)
            tables = (self._table(ts * scale, torch.float32),)
            if solver == "heun":
                tables += (self._table((ts - np.float32(1.0 / n)) * scale, torch.float32),)
            return Method(solver, ts, tables, 1, False, (solver, n, direction),
                          dt=direction / n)

        method = self._method((solver, n, direction), make)
        return self._loop(model, method, classes, image_shape, cfg_scale, null_label,
                          x_init, None, generator, graph)

    @torch.inference_mode()
    def sample(self, model: ModelFn, classes: torch.Tensor, image_shape: Tuple[int, int, int],
               cfg_scale: float = 3.0, null_label: Optional[int] = None,
               x_init: Optional[torch.Tensor] = None, n_sample_steps: Optional[int] = None,
               ode_direction: float = 1.0, generator: Optional[torch.Generator] = None,
               graph: Optional[bool] = None) -> torch.Tensor:
        """Euler over ``n_sample_steps`` (default ``n_steps``): the slot the
        trainers call for ``method="ddpm"``.  ``generator`` draws x_T where
        ``x_init`` is not given; ``graph`` as in ``GaussianDiffusion.sample``."""
        return self._solve(model, classes, image_shape,
                           self.n_steps if n_sample_steps is None else n_sample_steps,
                           cfg_scale, null_label, x_init, "euler", ode_direction,
                           generator, graph)

    @torch.inference_mode()
    def sample_ddim(self, model: ModelFn, classes: torch.Tensor,
                    image_shape: Tuple[int, int, int], n_sample_steps: int = 50,
                    eta: float = 0.0, cfg_scale: float = 3.0,
                    null_label: Optional[int] = None, x_init: Optional[torch.Tensor] = None,
                    ode_direction: float = 1.0, generator: Optional[torch.Generator] = None,
                    graph: Optional[bool] = None) -> torch.Tensor:
        """The deterministic few-step slot -> Euler; ``eta`` must be 0."""
        if eta:
            raise ValueError("rectified flow is deterministic; eta must be 0")
        return self._solve(model, classes, image_shape, n_sample_steps, cfg_scale, null_label,
                           x_init, "euler", ode_direction, generator, graph)

    @torch.inference_mode()
    def sample_dpmpp(self, model: ModelFn, classes: torch.Tensor,
                     image_shape: Tuple[int, int, int], n_sample_steps: int = 15,
                     cfg_scale: float = 3.0, null_label: Optional[int] = None,
                     x_init: Optional[torch.Tensor] = None, order: int = 2,
                     ode_direction: float = 1.0, generator: Optional[torch.Generator] = None,
                     graph: Optional[bool] = None) -> torch.Tensor:
        """The higher-order few-step slot -> Heun (2 CFG forwards a step);
        ``order=1`` falls back to Euler."""
        return self._solve(model, classes, image_shape, n_sample_steps, cfg_scale, null_label,
                           x_init, "heun" if order >= 2 else "euler", ode_direction,
                           generator, graph)
