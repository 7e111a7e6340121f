"""FLOP counts of the port's models, for the bench's model FLOPs utilization
(``ldm_tpu_torch/bench.py``; the JAX bench counts with XLA's cost analysis).

PyTorch's ``FlopCounterMode`` counts the products of what runs under it
(matrix products and convolutions, forward and backward, 2 operations a
multiply-add).  It runs on a twin of the model on the meta device: the same
modules and shapes, no memory and no arithmetic.  The twin's linear
attention takes the plain path (``impl="torch"``): a kernel launched through
ctypes is opaque to the counter, as a Pallas call is to XLA's cost analysis,
which is why the JAX bench counts on its ``attention_impl="xla"`` twin.  The
counter leaves out elementwise work, normalisation and the optimizer, which
XLA counts, so at equal shapes it reads 0.5-2 % under XLA for a UNet
forward and about 3 % under for a train step
(``tests/test_torch_port_bench.py`` holds both).  Every counted op is per
item, so a count is linear in the batch.
"""

from __future__ import annotations

import copy
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from ldm_tpu_torch.models.autoencoder import latent_shape_of
from ldm_tpu_torch.training.autoencoder_trainer import elbo_mse

# NVIDIA H100 SXM, dense bf16 tensor-core peak at its full 700 W (data sheet)
H100_SXM_BF16_PEAK_FLOPS = 989e12
META = torch.device("meta")


def count_flops(fn: Callable[[], object]) -> float:
    """The products ``fn()`` runs, in FLOPs."""
    with FlopCounterMode(display=False) as mode:
        fn()
    return float(mode.get_total_flops())


def build_flops_twin(model: torch.nn.Module) -> torch.nn.Module:
    """``model`` on the meta device, its linear attention on the plain path."""
    twin = copy.deepcopy(model).to(META)
    if hasattr(twin, "set_attention_impl"):
        twin.set_attention_impl("torch")
    return twin


def _unet_inputs(batch: int, image_shape: Sequence[int]):
    return (torch.zeros((batch, *image_shape), device=META),
            torch.zeros((batch,), dtype=torch.int64, device=META),
            torch.zeros((batch,), dtype=torch.int64, device=META))


def sampler_flops_per_img_step(model: torch.nn.Module, image_shape=(32, 32, 3),
                               batch: int = 32) -> float:
    """FLOPs a sampled image costs a step: one CFG forward of ``model`` (a
    UNet) on the fused 2B batch, over ``batch``.  The sampler's update is
    elementwise and uncounted (about 30 KFLOP an image, negligible)."""
    twin = build_flops_twin(model)
    with torch.inference_mode():
        return count_flops(lambda: twin(*_unet_inputs(2 * batch, image_shape))) / batch


def _step_flops(model: torch.nn.Module, loss_fn: Callable[[torch.nn.Module], torch.Tensor]
                ) -> float:
    twin = build_flops_twin(model).train()
    return count_flops(lambda: loss_fn(twin).backward())


def diffusion_step_flops(model: torch.nn.Module, batch: int, image_shape=(32, 32, 3)) -> float:
    """FLOPs of one diffusion train step at ``batch``: the UNet's forward
    and backward under the eps-MSE (the backward of the plain attention)."""
    x, t, y = _unet_inputs(batch, image_shape)
    return _step_flops(model, lambda m: torch.mean((x - m(x, t, y)) ** 2))


def classifier_step_flops(model: torch.nn.Module, batch: int, image_shape=(32, 32, 3)
                          ) -> float:
    """FLOPs of one classifier train step at ``batch``: forward and backward
    under the cross-entropy."""
    x = torch.zeros((batch, *image_shape), device=META)
    y = torch.zeros((batch,), dtype=torch.int64, device=META)
    return _step_flops(model, lambda m: F.cross_entropy(m(x), y))


def vae_step_flops(model: torch.nn.Module, batch: int, image_shape=(32, 32, 3)) -> float:
    """FLOPs of one VAE train step at ``batch``: encode, the reparameterised
    latent, decode, and the backward of ``elbo_mse``."""
    x = torch.zeros((batch, *image_shape), device=META)
    eps = torch.zeros((batch, *latent_shape_of(model, image_shape[0])), device=META)

    def loss(m):
        recon, mu, log_var = m(x, eps)
        return elbo_mse(recon, x, mu, log_var)

    return _step_flops(model, loss)
