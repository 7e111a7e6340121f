"""The frozen yardsticks: the card's published peaks, the least time a
kernel could take, and the operations of a step counted over the plain
reference.

* Peaks: NVIDIA H100 SXM data sheet, dense bf16 tensor cores 989 TFLOP/s,
  HBM3 3.35 TB/s, both at the full 700 W.  The card's ``power.limit`` is
  printed beside them in every run.
* ``bound``: the larger of the bytes a function must move (each input read
  once, each output written once) over the memory rate and its products
  (2 operations a multiply-add) over the bf16 rate.
* ``la_bound``: the linear-attention block at (B, N, C) in bf16; x in and y
  out (backward: x and dy in, dx out), the fp32 parameters in (backward:
  their gradients out too); the products of h Wqkv, the four 32x32 blocks of
  k^T v, ctx Wout and q ctx_w, and in the backward those again plus the
  eight products of the chain rule.
* ``adam_ema_bytes``: Adam and the EMA in one pass move 36 bytes a float32
  parameter (read p, g, m, v, ema; write p, m, v, ema).
* ``count_flops``: PyTorch's ``FlopCounterMode`` over the reference on the
  meta device: the products of convolutions and matrix products, forward
  and backward, 2 a multiply-add.  Elementwise work, norms and the optimizer
  are not counted.
"""

from __future__ import annotations

import subprocess
from typing import Callable, Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.unet import RefUNet, param_shapes as unet_shapes
from benchmark.reference.vae import RefVAE, param_shapes as vae_shapes

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_S = 3.35e12
ADAM_EMA_BYTES = 36
HIDDEN, DIM_HEAD = 128, 32
META = torch.device("meta")


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES_S, flops / PEAK_BF16_FLOPS)


def la_bound_s(b: int, n: int, c: int, backward: bool) -> float:
    params = 4 * (c * 3 * HIDDEN + HIDDEN * c + 5 * c)
    small = 2 * HIDDEN * DIM_HEAD * c
    fwd = 2 * n * c * 3 * HIDDEN + 2 * n * HIDDEN * DIM_HEAD + small + 2 * n * HIDDEN * c
    if not backward:
        return bound_s(2 * b * n * c * 2 + params, b * fwd)
    bwd = (fwd + 2 * (2 * n * HIDDEN * c) + 2 * small + 2 * (2 * n * HIDDEN * DIM_HEAD)
           + 2 * (2 * n * c * 3 * HIDDEN))
    return bound_s(3 * b * n * c * 2 + 2 * params, b * bwd)


def adam_ema_bound_s(n_params: int) -> float:
    return bound_s(ADAM_EMA_BYTES * n_params, 0.0)


def count_flops(fn: Callable[[], object]) -> float:
    with FlopCounterMode(display=False) as mode:
        fn()
    return float(mode.get_total_flops())


def _meta(shapes) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(s, device=META) for k, s in shapes.items()}


def _inputs(batch: int, shape):
    return (torch.zeros((batch, *shape), device=META),
            torch.zeros((batch,), dtype=torch.int64, device=META),
            torch.zeros((batch,), dtype=torch.int64, device=META))


def unet_forward_flops(p: dict, batch: int, shape) -> float:
    model = RefUNet(_meta(unet_shapes(p)), p)
    return count_flops(lambda: model(*_inputs(batch, shape)))


def train_step_flops(p: dict, batch: int, shape) -> float:
    """One training step: the U-Net forward and backward under the MSE."""
    w = {k: v.requires_grad_(True) for k, v in _meta(unet_shapes(p)).items()}
    model = RefUNet(w, p)
    x, t, y = _inputs(batch, shape)
    return count_flops(lambda: torch.mean((x - model(x, t, y)) ** 2).backward())


def decode_flops(p: dict, batch: int, latent_shape) -> float:
    vae = RefVAE(_meta(vae_shapes(p)), p)
    return count_flops(lambda: vae.decode(torch.zeros((batch, *latent_shape), device=META)))


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"

