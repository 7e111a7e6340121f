"""The DDPM process: forward noising, one reverse step, and the ancestral
sampler with classifier-free guidance (port of ldm_tpu/diffusion/ddpm.py).

Images are NHWC, as in the JAX package.  The sampler is a Python loop over
the timesteps as Python ints: the ``t == 0`` noise mask is built from a
tensor made on the device from that int, so no step waits for the device.
CFG runs the conditional and unconditional passes as ONE forward on a 2B
batch.

Randomness is an input: ``x_init`` (x_T) and ``noise`` (the per-step draws)
can be given, so a test can feed the JAX key stream; what is not given is
drawn from the ``torch.Generator`` the caller passes.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ldm_tpu_torch.diffusion.schedule import DiffusionSchedule

# eps model: (x_noisy, t, y) -> eps_theta.  `y` is int (B,); the unconditional
# pass uses the model's null label (UNet.null_label), which embeds to zero.
EpsModelFn = Callable[..., torch.Tensor]
# per-step noise: t -> the (B, H, W, C) N(0, I) draw for the step from t
NoiseFn = Callable[[int], torch.Tensor]


def gather(a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Per-sample schedule value broadcastable over NHWC images."""
    return a[t].reshape(-1, 1, 1, 1)


class GaussianDiffusion:
    """DDPM process with a linear (or sqrt-linear) beta schedule."""

    def __init__(self, n_steps: int, n_samples: int = 1, schedule: str = "linear",
                 beta_start: float = 1e-4, beta_end: float = 0.02, device=None):
        self.n_steps = int(n_steps)
        self.n_samples = int(n_samples)
        self.schedule = DiffusionSchedule.make(
            schedule, n_steps, beta_start, beta_end, device
        )

    # ------------------------------------------------------------ forward (q)
    def q_xt_x0(self, x0: torch.Tensor, t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Mean and variance of q(x_t | x_0)."""
        ab = gather(self.schedule.alpha_bars, t)
        return torch.sqrt(ab) * x0, 1.0 - ab

    def q_sample(self, x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """Sample x_t ~ q(x_t | x_0)."""
        mean, var = self.q_xt_x0(x0, t)
        return mean + torch.sqrt(var) * eps.to(mean.dtype)

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

    # --------------------------------------------------------------- sampling
    def _cfg_eps(self, eps_model: EpsModelFn, xt: torch.Tensor, t_vec: torch.Tensor,
                 y_in: torch.Tensor, cfg_scale: float, use_cfg: bool) -> torch.Tensor:
        """One noise prediction, with CFG fused as a single 2B-batch forward."""
        if use_cfg:
            x_in = torch.cat([xt, xt], dim=0)
            t_in = torch.cat([t_vec, t_vec], dim=0)
            eps_cond, eps_uncond = eps_model(x_in, t_in, y_in).chunk(2, dim=0)
            return eps_uncond + cfg_scale * (
                eps_cond.to(torch.float32) - eps_uncond.to(torch.float32)
            )
        return eps_model(xt, t_vec, y_in)

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

        Returns:
          x_0 of shape (B, H, W, C), float32.
        """
        b = classes.shape[0]
        device = classes.device
        shape = (b,) + tuple(image_shape)
        if (x_init is None or noise is None) and generator is None:
            raise ValueError("pass a generator, or both x_init and noise")

        def draw() -> torch.Tensor:
            return torch.randn(shape, generator=generator, device=device)

        xt = draw() if x_init is None else x_init.to(device, torch.float32)

        use_cfg = cfg_scale is not None and cfg_scale > 0
        if use_cfg:
            if null_label is None:
                raise ValueError("null_label is required when cfg_scale > 0")
            y_in = torch.cat([classes, torch.full_like(classes, null_label)])
        else:
            y_in = classes

        for t in range(self.n_steps - 1, -1, -1):
            t_vec = torch.full((b,), t, dtype=torch.int64, device=device)
            eps = self._cfg_eps(eps_model, xt, t_vec, y_in, cfg_scale, use_cfg)
            z = draw() if noise is None else noise(t).to(device)
            xt = self.p_sample(xt, t_vec, eps, z)
        return xt
