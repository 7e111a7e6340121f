"""Forward-process visualization (the twin of ``ldm_tpu/utils/viz.py``).

:func:`forward_diffusion_at` noises an image at a chosen t and
reverse-transforms it; :func:`forward_process_grid` sweeps t (every 10th
step by default) in one batched ``q_sample`` and tiles the result into one
image, written as a PNG when asked.  The noise is an argument, since
torch cannot replay ``jax.random``: without it, it is drawn from a CPU
``torch.Generator`` seeded 0.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.utils.images import image_grid, save_images


def noised(diffusion: GaussianDiffusion, x0: np.ndarray, ts: Sequence[int],
           noise: Optional[np.ndarray] = None) -> np.ndarray:
    """``q_sample`` of the (N, H, W, C) float batch ``x0`` at the N steps
    ``ts`` on the diffusion's device, as float32 numpy; ``noise`` (x0's
    shape) or N(0, I) from a generator seeded 0."""
    x0 = torch.tensor(np.asarray(x0, np.float32))
    if noise is None:
        eps = torch.randn(x0.shape, generator=torch.Generator().manual_seed(0))
    else:
        eps = torch.tensor(np.asarray(noise, np.float32))
    dev = diffusion.device
    t = torch.as_tensor(np.asarray(ts, np.int64), device=dev)
    return diffusion.q_sample(x0.to(dev), t, eps.to(dev)).cpu().numpy()


def forward_diffusion_at(diffusion: GaussianDiffusion, image: np.ndarray, t: int,
                         noise: Optional[np.ndarray] = None) -> np.ndarray:
    """``image`` ((H, W, C) float in [-1, 1]) noised at step ``t``, as uint8
    HWC; ``noise``: (1, H, W, C)."""
    return reverse_transform(noised(diffusion, np.asarray(image)[None], [t], noise))[0]


def forward_process_grid(diffusion: GaussianDiffusion, image: np.ndarray,
                         ts: Optional[Sequence[int]] = None, out_path: Optional[str] = None,
                         noise: Optional[np.ndarray] = None) -> np.ndarray:
    """``image`` noised at each step of ``ts`` (default every 10th) in one
    batched ``q_sample``, tiled into one uint8 grid (written to
    ``out_path`` when given); ``noise``: (len(ts), H, W, C)."""
    if ts is None:
        ts = list(range(0, diffusion.n_steps, 10))
    image = np.asarray(image, np.float32)
    x0 = np.broadcast_to(image[None], (len(ts),) + image.shape)
    grid = image_grid(reverse_transform(noised(diffusion, x0, ts, noise)))
    if out_path:
        save_images([grid], [out_path])
    return grid
