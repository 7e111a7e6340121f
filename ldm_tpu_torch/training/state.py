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

The update is a function of device tensors alone, so that a CUDA graph can
replay it: the step counter that the EMA warmup reads is a device tensor
that the update increments itself (beside the host's ``step``, which the
per-step generator and the checkpoints use), the EMA weight is computed from
it on the device, and on a CUDA device Adam is ``capturable`` (its own step
counts are device tensors).  :meth:`TrainState.update` is that part;
:meth:`TrainState.count_step` is what the host does a step, and after a
replayed step :meth:`TrainState.count_replayed_step` also tells both models
that their weights changed without a version counter moving.
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


def ema_decay_tensor(decay: float, step: torch.Tensor) -> torch.Tensor:
    """:func:`ema_decay_at` on the device: ``step`` a 0-d integer tensor, the
    weight a 0-d fp32 tensor on its device, the same fp32 arithmetic."""
    s = step.to(torch.float32)
    return torch.clamp((1.0 + s) / (10.0 + s), max=decay)  # a scalar: no copy to the device


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
        device = next(model.parameters()).device
        # capturable Adam keeps its step counts on the device, so a CUDA graph
        # can replay it; on CPU parameters some PyTorch versions refuse it
        self.capturable = device.type == "cuda"
        self.optimizer = torch.optim.Adam(
            model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8, foreach=True,
            capturable=self.capturable,
        )
        self.step = 0
        self.step_t = torch.zeros((), dtype=torch.int64, device=device)  # step, on the device

    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    @torch.no_grad()
    def update(self) -> None:
        """The device's part of a step: Adam on the parameters' ``.grad``, the
        EMA with the weight of the device step counter, that counter += 1."""
        self.optimizer.step()
        d = ema_decay_tensor(self.ema_decay, self.step_t)
        ema = list(self.ema.parameters())
        torch._foreach_mul_(ema, d)
        # ema += (1 - d) * p with one rounding, as ``add_(p, alpha=1 - d)`` has
        # it (which takes no tensor for alpha); a kernel a leaf
        rest = 1.0 - d
        for e, p in zip(ema, self.params()):
            e.addcmul_(p, rest)
        self.step_t += 1

    def count_step(self) -> None:
        """The host's part of a step."""
        self.step += 1

    def count_replayed_step(self) -> None:
        """After a replay of a captured :meth:`update`: the host's count, and
        word to both models that their weights changed in place."""
        self.step += 1
        for m in (self.model, self.ema):
            replayed = getattr(m, "weights_replayed", None)
            if replayed is not None:
                replayed()

    def apply_gradients(self) -> None:
        """Adam on the parameters' ``.grad``, then the EMA, then step += 1."""
        self.update()
        self.count_step()

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
        # a checkpoint written on another kind of device carries its
        # optimizer's ``capturable``: this device's holds (torch then puts
        # Adam's step counts where a capturable optimizer wants them)
        opt = dict(sd["optimizer"])
        opt["param_groups"] = [dict(g, capturable=self.capturable)
                               for g in opt["param_groups"]]
        self.optimizer.load_state_dict(opt)
        self.step = int(sd["step"])
        self.step_t.fill_(self.step)
