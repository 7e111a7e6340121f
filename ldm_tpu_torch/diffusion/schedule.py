"""Variance schedules for the diffusion process (port of
ldm_tpu/diffusion/schedule.py).

The constants are computed once in float64 with numpy, exactly as the JAX
package computes them, then stored as float32 tensors on the device the
sampler runs on.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed schedule constants, each of shape ``(n_steps,)`` float32."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alpha_bars: torch.Tensor
    sigma2: torch.Tensor  # posterior variance; the reference uses sigma^2 = beta

    @property
    def n_steps(self) -> int:
        return self.betas.shape[0]

    @classmethod
    def from_betas(cls, betas_f64: np.ndarray, device=None) -> "DiffusionSchedule":
        alphas = 1.0 - betas_f64
        alpha_bars = np.cumprod(alphas)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        return cls(betas=put(betas_f64), alphas=put(alphas),
                   alpha_bars=put(alpha_bars), sigma2=put(betas_f64))

    @classmethod
    def linear(cls, n_steps: int, beta_start: float = 1e-4, beta_end: float = 0.02,
               device=None) -> "DiffusionSchedule":
        """Linear beta schedule (the pixel DDPM's)."""
        return cls.from_betas(
            np.linspace(beta_start, beta_end, n_steps, dtype=np.float64), device
        )

    @classmethod
    def sqrt_linear(cls, n_steps: int, beta_start: float = 8.5e-4,
                    beta_end: float = 1.2e-2, device=None) -> "DiffusionSchedule":
        """Linear in sqrt(beta) (the latent DDPM's)."""
        root = np.linspace(beta_start**0.5, beta_end**0.5, n_steps, dtype=np.float64)
        return cls.from_betas(root**2, device)

    @classmethod
    def make(cls, name: str, n_steps: int, beta_start: float, beta_end: float,
             device=None) -> "DiffusionSchedule":
        if name == "linear":
            return cls.linear(n_steps, beta_start, beta_end, device)
        if name == "sqrt_linear":
            return cls.sqrt_linear(n_steps, beta_start, beta_end, device)
        raise ValueError(f"unknown schedule {name!r}")
