"""The DDPM process: forward noising (and the training batch's noising), one
reverse step, and three samplers with classifier-free guidance: ancestral
DDPM, DDIM and DPM-Solver++(2M) (port of ldm_tpu/diffusion/ddpm.py).

Images are NHWC, as in the JAX package.  The samplers run through the loop
the rectified flow shares (``diffusion/sampling.py``): a table of timesteps
(and, for DPM-Solver++, of coefficients) on the device, one step that reads
its row, eagerly or as a CUDA graph captured once and replayed.  On a CUDA
device the replayed graph is the default; ``graph=False`` asks for the eager
loop, and a caller who injects the per-step noise gets the eager loop unless
``graph=True``.  A capture that fails raises.

Randomness is an input: ``x_init`` (x_T) and ``noise`` (the per-step
draws), and ``t`` and ``eps`` of a training batch, can be given, so a test
can feed the JAX key stream; what is not given is drawn from the
``torch.Generator`` the caller passes.  DDIM with ``eta == 0`` and
DPM-Solver++ draw nothing after x_T.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_tpu_torch.diffusion.sampling import (
    Method,
    ModelFn as EpsModelFn,
    NoiseFn,
    PredictFn,
    SamplingProcess,
)
from ldm_tpu_torch.diffusion.schedule import DiffusionSchedule


def gather(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample schedule value broadcastable over NHWC images."""
    return a[t].reshape(-1, 1, 1, 1)


class GaussianDiffusion(SamplingProcess):
    """DDPM process with a linear (or sqrt-linear) beta schedule."""

    def __init__(self, n_steps: int, n_samples: int = 1, schedule: str = "linear",
                 beta_start: float = 1e-4, beta_end: float = 0.02, device=None):
        super().__init__()
        self.n_steps = int(n_steps)
        self.n_samples = int(n_samples)
        self.schedule = DiffusionSchedule.make(
            schedule, n_steps, beta_start, beta_end, device
        )
        self.device = self.schedule.betas.device

    # ------------------------------------------------------------ forward (q)
    def q_xt_x0(self, x0: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance of q(x_t | x_0)."""
        ab = gather(self.schedule.alpha_bars, t)
        return torch.sqrt(ab) * x0, 1.0 - ab

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Sample x_t ~ q(x_t | x_0)."""
        mean, var = self.q_xt_x0(x0, t)
        return mean + torch.sqrt(var) * eps.to(mean.dtype)

    def noise_batch(self, x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                    eps: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Per-sample t ~ U[0, T) and eps ~ N(0, I); returns (eps, x_t, t).

        The training-time noising of the diffusion trainer's step.  ``t``
        (int, (B,)) and ``eps`` (x0's shape) can be given, so a test can feed
        the JAX draws; what is not given is drawn from ``generator`` on x0's
        device, t first.
        """
        return self.noised(x0, *self.draw_t_eps(x0, t, eps, generator))

    def noised(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor,
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(target eps, x_t, the model's time input t) for drawn ``t`` and
        ``eps``: the part of :meth:`noise_batch` after the draws."""
        return eps, self.q_sample(x0, t, eps), t

    def draw_t_eps(self, x0: torch.Tensor, t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The draws of :meth:`noise_batch` alone: (t, eps) on x0's device,
        what is not given drawn from ``generator``, t first."""
        if (t is None or eps is None) and generator is None:
            raise ValueError("pass a generator, or both t and eps")
        if t is None:
            t = torch.randint(0, self.n_steps, (x0.shape[0],), generator=generator,
                              device=x0.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                              dtype=x0.dtype)
        return t.to(x0.device, torch.int64), eps.to(x0.device, x0.dtype)

    # ------------------------------------------------------------ reverse (p)
    def p_sample(self, xt: torch.Tensor, t: torch.Tensor, eps_theta: torch.Tensor,
                 noise: torch.Tensor) -> torch.Tensor:
        """One ancestral step x_t -> x_{t-1}; ``noise`` is masked out where
        ``t == 0``."""
        s = self.schedule
        alpha_bar = gather(s.alpha_bars, t)
        alpha = gather(s.alphas, t)
        eps_coef = (1.0 - alpha) * torch.rsqrt(1.0 - alpha_bar)
        mean = torch.rsqrt(alpha) * (xt - eps_coef * eps_theta.to(xt.dtype))
        sigma = torch.sqrt(gather(s.sigma2, t))
        sigma = torch.where(t.reshape(-1, 1, 1, 1) > 0, sigma, 0.0)
        return mean + sigma * noise

    def ddim_step(self, xt: torch.Tensor, t: torch.Tensor, t_prev: torch.Tensor,
                  eps_theta: torch.Tensor, noise: Optional[torch.Tensor],
                  eta: float = 0.0) -> torch.Tensor:
        """One DDIM update x_t -> x_{t_prev} (Song et al. 2021, eq. 12).
        ``t`` and ``t_prev`` are int (B,); ``t_prev < 0`` means "to x_0"
        (alpha_bar_prev == 1, where the noise scale vanishes).  ``eta`` is
        static; with ``eta == 0`` the update is deterministic and ``noise``
        may be None."""
        s = self.schedule
        ab_t = gather(s.alpha_bars, t)
        ab_prev = torch.where(t_prev.reshape(-1, 1, 1, 1) >= 0,
                              gather(s.alpha_bars, t_prev.clamp_min(0)), 1.0)
        eps = eps_theta.to(torch.float32)
        x0_pred = (xt - torch.sqrt(1.0 - ab_t) * eps) * torch.rsqrt(ab_t)
        sigma = eta * torch.sqrt(
            ((1.0 - ab_prev) / (1.0 - ab_t)).clamp_min(0.0)
            * (1.0 - ab_t / ab_prev).clamp_min(0.0)
        )
        dir_xt = torch.sqrt((1.0 - ab_prev - sigma**2).clamp_min(0.0)) * eps
        out = torch.sqrt(ab_prev) * x0_pred + dir_xt
        return out if noise is None else out + sigma * noise

    # --------------------------------------------------------------- sampling
    def _update(self, method: Method, rows: Sequence[torch.Tensor],
                carry: Sequence[torch.Tensor], z: Optional[torch.Tensor],
                predict: PredictFn) -> Tuple[torch.Tensor, ...]:
        """One step of the ancestral, DDIM or DPM-Solver++ sampler: one (CFG)
        noise prediction at the step's t, then the method's update."""
        xt, t_vec = carry[0], rows[0]
        eps = predict(xt, t_vec)
        if method.name == "ddpm":
            return (self.p_sample(xt, t_vec, eps, z),)
        if method.name == "ddim":
            return (self.ddim_step(xt, t_vec, rows[1].expand(xt.shape[0]), eps, z,
                                   method.eta),)
        # DPM-Solver++(2M): the data prediction, extrapolated by the previous one
        _, c_x, c_d, c2 = rows
        ab_t = gather(self.schedule.alpha_bars, t_vec)
        x0 = (xt - torch.sqrt(1.0 - ab_t) * eps.to(torch.float32)) * torch.rsqrt(ab_t)
        d = x0 + c2 * (x0 - carry[1])
        return (c_x * xt + c_d * d, x0)

    @torch.inference_mode()
    def sample(
        self,
        eps_model: EpsModelFn,
        classes: torch.Tensor,
        image_shape: Tuple[int, int, int],
        cfg_scale: float = 3.0,
        null_label: Optional[int] = None,
        x_init: Optional[torch.Tensor] = None,
        noise: Optional[NoiseFn] = None,
        generator: Optional[torch.Generator] = None,
        graph: Optional[bool] = None,
    ) -> torch.Tensor:
        """The full ancestral sampling loop (the north-star hot path).

        Args:
          eps_model: ``(x, t, y) -> eps``, e.g. the UNet.
          classes: int (B,) class labels on the sampling device.
          image_shape: (H, W, C) — NHWC without the batch dim.
          cfg_scale: classifier-free guidance scale; <= 0 disables the uncond
            pass (conditional sampling without guidance).
          null_label: label id that embeds to zero; required if cfg_scale > 0.
          x_init: x_T, (B, H, W, C) float32; drawn from ``generator`` if None.
          noise: t -> that step's N(0, I) draw; drawn from ``generator`` if None.
          generator: the source of whatever of x_T and noise is not given.
          graph: None: the replayed CUDA graph on a CUDA device unless
            ``noise`` is given, the eager loop otherwise; True / False ask
            for one by name.

        Returns:
          x_0 of shape (B, H, W, C), float32.
        """
        def make():
            ts = np.arange(self.n_steps - 1, -1, -1, dtype=np.int64)
            return Method("ddpm", ts, (self._table(ts, torch.int64),), 1, True, ("ddpm",))

        return self._loop(eps_model, self._method(("ddpm",), make), classes, image_shape,
                          cfg_scale, null_label, x_init, noise, generator, graph)

    def ddim_timesteps(self, n_sample_steps: int) -> Tuple[np.ndarray, np.ndarray]:
        """DDIM's (t, t_prev) by step: an evenly spaced subsequence of the
        training timesteps, endpoints included, descending; the last
        ``t_prev`` is -1, "to x_0"."""
        n_sub = min(int(n_sample_steps), self.n_steps)
        sub = np.unique(np.linspace(0, self.n_steps - 1, n_sub).round().astype(np.int32))[::-1]
        return sub.astype(np.int64), np.append(sub[1:], -1).astype(np.int64)

    @torch.inference_mode()
    def sample_ddim(
        self,
        eps_model: EpsModelFn,
        classes: torch.Tensor,
        image_shape: Tuple[int, int, int],
        n_sample_steps: int = 50,
        eta: float = 0.0,
        cfg_scale: float = 3.0,
        null_label: Optional[int] = None,
        x_init: Optional[torch.Tensor] = None,
        noise: Optional[NoiseFn] = None,
        generator: Optional[torch.Generator] = None,
        graph: Optional[bool] = None,
    ) -> torch.Tensor:
        """Few-step DDIM sampling over :meth:`ddim_timesteps`, the same fused
        2B-CFG loop as :meth:`sample` at ``n_sample_steps / n_steps`` of its
        cost.  ``eta == 0`` (default) is the deterministic DDIM and draws
        nothing after x_T; ``eta == 1`` over the full subsequence has the
        ancestral sampler's stochasticity with the beta-tilde variance.  The
        other arguments are :meth:`sample`'s."""
        eta = float(eta)

        def make():
            ts, t_prevs = self.ddim_timesteps(n_sample_steps)
            tables = (self._table(ts, torch.int64), self._table(t_prevs, torch.int64))
            return Method("ddim", ts, tables, 1, eta != 0.0, ("ddim", len(ts), eta), eta)

        method = self._method(("ddim", int(n_sample_steps), eta), make)
        return self._loop(eps_model, method, classes, image_shape, cfg_scale, null_label,
                          x_init, noise, generator, graph)

    # ----------------------------------------------------- DPM-Solver++ (2M)
    def _dpmpp_coeffs(self, n_sample_steps: int, order: int = 2):
        """Host-precomputed per-step scalars for the 2M multistep update.

        The timestep subsequence is uniform in ``lambda = log(alpha/sigma)``
        (the solver's natural variable, the DPM-Solver paper's recommended
        grid), snapped to the trained discrete timesteps.  All coefficients
        are finite even for the final "to x_0" step (``sigma_target == 0``):
        computed in float64 directly from the alpha/sigma ratios instead of
        through lambda, which would be +inf there.
        """
        ab = self.schedule.alpha_bars.cpu().numpy().astype(np.float64)
        n_sub = min(int(n_sample_steps), self.n_steps)
        lam_all = 0.5 * (np.log(ab) - np.log1p(-ab))
        targets = np.linspace(lam_all[-1], lam_all[0], n_sub)
        idx = np.abs(lam_all[:, None] - targets[None, :]).argmin(axis=0)
        sub = np.unique(idx.astype(np.int64))[::-1]  # descending: T-1 ... 0
        n = len(sub)

        alpha = np.sqrt(ab[sub])
        sigma = np.sqrt(1.0 - ab[sub])
        lam = np.log(alpha / sigma)
        # targets: sub[1:], then the analytic projection to x_0 (alpha = 1,
        # sigma = 0: lambda = +inf, handled by the ratio form below)
        a_t = np.append(alpha[1:], 1.0)
        s_t = np.append(sigma[1:], 0.0)
        c_x = s_t / sigma                       # sigma_t / sigma_s
        exp_mh = (s_t / sigma) * (alpha / a_t)  # e^{-h}; exactly 0 at the end
        c_d = a_t * (1.0 - exp_mh)              # -alpha_t * expm1(-h)
        # second-order extrapolation weight 1/(2 r_i), r_i = h_{i-1}/h_i: zero
        # on the first step (no previous model eval) and on the final "to x_0"
        # step (h = +inf; first order there IS the exact projection)
        c2 = np.zeros(n)
        if n >= 2 and order >= 2:
            h = np.append(lam[1:] - lam[:-1], np.inf)  # h_i for step i
            with np.errstate(divide="ignore"):
                r = h[:-1] / h[1:]
                c2[1:] = np.where(np.isfinite(r) & (r > 0), 0.5 / np.maximum(r, 1e-12), 0.0)
            c2[-1] = 0.0
        return sub.astype(np.int32), c_x, c_d, c2

    @torch.inference_mode()
    def sample_dpmpp(
        self,
        eps_model: EpsModelFn,
        classes: torch.Tensor,
        image_shape: Tuple[int, int, int],
        n_sample_steps: int = 15,
        cfg_scale: float = 3.0,
        null_label: Optional[int] = None,
        x_init: Optional[torch.Tensor] = None,
        order: int = 2,
        generator: Optional[torch.Generator] = None,
        graph: Optional[bool] = None,
    ) -> torch.Tensor:
        """DPM-Solver++(2M): second-order multistep few-step sampling (Lu et
        al. 2022, the data-prediction multistep variant), the same fused
        2B-CFG loop as :meth:`sample`.  Exponential-integrator form in the
        half-log-SNR variable ``lambda = log(alpha/sigma)``:

            x_t = (sigma_t/sigma_s) x_s - alpha_t (e^{-h} - 1) D,
            D   = x0_i + (1/(2 r_i)) (x0_i - x0_{i-1}),   r_i = h_{i-1}/h_i

        with D = x0_i on the first step and on the final projection to x_0.
        The carry is (x_t, the previous x0 prediction), the latter starting
        from zeros.  Deterministic: ``generator`` draws x_T only."""
        def make():
            sub, c_x, c_d, c2 = self._dpmpp_coeffs(n_sample_steps, order)
            tables = (self._table(sub, torch.int64),) + tuple(
                self._table(c, torch.float32) for c in (c_x, c_d, c2))
            return Method("dpmpp", sub.astype(np.int64), tables, 2, False,
                           ("dpmpp", len(sub), int(order)))

        method = self._method(("dpmpp", int(n_sample_steps), int(order)), make)
        return self._loop(eps_model, method, classes, image_shape, cfg_scale, null_label,
                          x_init, None, generator, graph)

