"""TrainState: everything a training step changes (port of ldm_tpu/training/state.py).

The model, an EMA copy of it, Adam and the step counter.  Adam has optax's
formula and hyperparameters (betas 0.9/0.999, eps 1e-8: ``make_optimizer``);
the EMA is ``ema = d*ema + (1-d)*params`` after each update, with the warmup
``d = min(decay, (1+step)/(10+step))`` taken at the step BEFORE the
increment, as ``TrainState.apply_gradients`` does.

Updates are in place, on the device.  Adam is torch's multi-tensor
(``foreach``) implementation: its in-place updates bump each parameter's
version counter, which ``LinAttnBlock.kernel_weights`` keys its cached
kernel-layout copies on (the ``fused`` implementation does not bump it).
The per-step random stream is :func:`step_generator`, the counterpart of
``fold_in(key, step)``: a generator seeded from (seed, step), so a resumed
run continues the stream without saving generator state.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn


def ema_decay_at(decay: float, step: int) -> float:
    """The EMA weight of the update that follows ``step`` steps, in fp32 as
    ``jnp.minimum(decay, (1 + step) / (10 + step))`` computes it."""
    f = np.float32
    return float(np.minimum(f(decay), f(1.0 + step) / f(10.0 + step)))


def step_generator(seed: int, step: int, device, *salt: int) -> torch.Generator:
    """The draws of one step: a generator on ``device`` with a 64-bit seed
    made from (seed, step, salt...)."""
    words = np.random.SeedSequence([seed, step, *salt]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(words[0]))


class TrainState:
    """Model, EMA model, Adam (optax's formula) and the step counter."""

    def __init__(self, model: nn.Module, lr: float, ema_decay: float = 0.9999):
        self.model = model
        self.ema = copy.deepcopy(model).requires_grad_(False).eval()
        self.lr = float(lr)
        self.ema_decay = float(ema_decay)
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8, foreach=True
        )
        self.step = 0

    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """Adam on the parameters' ``.grad``, then the EMA, then step += 1."""
        self.optimizer.step()
        d = ema_decay_at(self.ema_decay, self.step)
        ema = list(self.ema.parameters())
        torch._foreach_mul_(ema, d)
        torch._foreach_add_(ema, self.params(), alpha=1.0 - d)
        self.step += 1

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "ema": self.ema.state_dict(),
            "optimizer": self.optimizer.state_dict(),
        }

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        self.ema.load_state_dict(sd["ema"], strict=True)
        self.optimizer.load_state_dict(sd["optimizer"])
        self.step = int(sd["step"])
