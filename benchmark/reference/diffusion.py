"""The plain reference of the DDPM process, its samplers and one training
step (Ho et al. 2020; Song et al. 2021 for DDIM; classifier-free guidance,
Ho and Salimans 2022), in float32.

* Schedules: linear betas, or linear in sqrt(beta) (the LDM variant),
  computed in float64 and kept in float32.
* Guidance: one prediction at the class and one at the null label,
  ``uncond + s (cond - uncond)``.
* Ancestral step: ``(x - (1 - a) / sqrt(1 - abar) eps) / sqrt(a) + sqrt(beta) z``,
  no noise at t = 0.
* DDIM (eta 0) over ``n`` timesteps spread evenly over [0, T - 1], rounded,
  descending; the last step goes to x_0.
* Training: x_t = sqrt(abar) x_0 + sqrt(1 - abar) eps, the labels dropped
  to the null label where the drop mask says, the mean squared error of eps,
  then Adam (optax's formula: betas 0.9 / 0.999, eps 1e-8 outside the root)
  and the EMA ``ema = d ema + (1 - d) p``, ``d = min(decay, (1 + s) / (10 + s))``
  at the step s before the update.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

Model = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


class Schedule:
    def __init__(self, n_steps: int, kind: str = "linear", beta_start: float = 1e-4,
                 beta_end: float = 0.02, device="cpu"):
        if kind == "linear":
            betas = np.linspace(beta_start, beta_end, n_steps, dtype=np.float64)
        elif kind == "sqrt_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n_steps,
                                dtype=np.float64) ** 2
        else:
            raise ValueError(f"unknown schedule {kind!r}")
        put = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        self.n_steps = n_steps
        self.beta = put(betas)
        self.alpha = put(1.0 - betas)
        self.abar = put(np.cumprod(1.0 - betas))

    def col(self, a: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return a[t].reshape(-1, 1, 1, 1)


def guided(model: Model, x: torch.Tensor, t: torch.Tensor, y: torch.Tensor, null: int,
           scale: float) -> torch.Tensor:
    cond = model(x, t, y)
    uncond = model(x, t, torch.full_like(y, null))
    return uncond + scale * (cond - uncond)


def ancestral(s: Schedule, model: Model, x: torch.Tensor, y: torch.Tensor, null: int,
              scale: float, noise: Callable[[int], torch.Tensor]) -> torch.Tensor:
    """T steps from x_T; ``noise(i)`` is step i's draw (i = 0 first)."""
    for i, step in enumerate(range(s.n_steps - 1, -1, -1)):
        t = torch.full((x.shape[0],), step, dtype=torch.int64, device=x.device)
        eps = guided(model, x, t, y, null, scale)
        a, ab = s.col(s.alpha, t), s.col(s.abar, t)
        mean = (x - (1.0 - a) / torch.sqrt(1.0 - ab) * eps) / torch.sqrt(a)
        z = noise(i)
        x = mean + (torch.sqrt(s.col(s.beta, t)) * z if step > 0 else 0.0)
    return x


def ddim_steps(n_steps: int, n: int) -> List[int]:
    sub = np.unique(np.linspace(0, n_steps - 1, min(n, n_steps)).round().astype(np.int64))
    return [int(v) for v in sub[::-1]]


def ddim(s: Schedule, model: Model, x: torch.Tensor, y: torch.Tensor, null: int,
         scale: float, n: int) -> torch.Tensor:
    ts = ddim_steps(s.n_steps, n)
    for step, prev in zip(ts, ts[1:] + [-1]):
        t = torch.full((x.shape[0],), step, dtype=torch.int64, device=x.device)
        eps = guided(model, x, t, y, null, scale)
        ab = s.abar[step]
        ab_prev = s.abar[prev] if prev >= 0 else torch.ones_like(ab)
        x0 = (x - torch.sqrt(1.0 - ab) * eps) / torch.sqrt(ab)
        x = torch.sqrt(ab_prev) * x0 + torch.sqrt(1.0 - ab_prev) * eps
    return x


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 levels, ``floor(clip((x + 1) / 2, 0, 1) * 255)``."""
    return ((x + 1.0) / 2.0).clamp(0.0, 1.0).mul(255.0).floor()


def loss(s: Schedule, model: Model, x0: torch.Tensor, y: torch.Tensor, t: torch.Tensor,
         eps: torch.Tensor, drop: torch.Tensor, null: int) -> torch.Tensor:
    ab = s.col(s.abar, t)
    xt = torch.sqrt(ab) * x0 + torch.sqrt(1.0 - ab) * eps
    y = torch.where(drop, torch.full_like(y, null), y)
    return torch.mean((eps - model(xt, t, y)) ** 2)


class Adam:
    """Adam and the EMA over a dict of leaves, as one training run moves them."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.p = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.ema = {k: v.detach().clone() for k, v in params.items()}
        self.lr, self.decay, self.b1, self.b2, self.eps = lr, decay, b1, b2, eps
        self.steps = 0

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        self.steps += 1
        c1, c2 = 1.0 - self.b1 ** self.steps, 1.0 - self.b2 ** self.steps
        s = self.steps - 1
        d = min(self.decay, (1.0 + s) / (10.0 + s))
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps))
            self.ema[k].mul_(d).add_(p, alpha=1.0 - d)


def _step(s: Schedule, model: Model, params: Dict[str, torch.Tensor], opt: Adam,
          batch: Tuple[torch.Tensor, ...], null: int) -> Tuple[float, Dict[str, torch.Tensor]]:
    """One step of ``batch`` ((x0, y, t, eps, drop)): its loss and the
    gradients Adam and the EMA then took."""
    for p in params.values():
        p.grad = None
    value = loss(s, model, *batch, null)
    value.backward()
    grads = {k: p.grad for k, p in params.items()}
    opt.update(grads)
    return value.item(), grads


def _norms(a: Dict[str, torch.Tensor], b: Dict[str, torch.Tensor] = None) -> Dict[str, float]:
    """Each leaf's norm of ``a`` (less ``b``, where given)."""
    return {k: (v.detach() if b is None else v.detach() - b[k]).norm().item()
            for k, v in a.items()}


def train_steps(s: Schedule, make_model: Callable[[Dict[str, torch.Tensor]], Model],
                weights: Dict[str, torch.Tensor], batches: Sequence[Tuple[torch.Tensor, ...]],
                null: int, lr: float, decay: float) -> dict:
    """The steps of ``batches`` ((x0, y, t, eps, drop) each) from ``weights``:
    each step's loss, each leaf's first gradient, each leaf's change and its
    EMA's change after the last step."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in weights.items()}
    opt = Adam(params, lr, decay)
    model = make_model(params)
    losses, first = [], None
    for batch in batches:
        value, grads = _step(s, model, params, opt, batch, null)
        if first is None:
            first = _norms(grads)
        losses.append(value)
    return {"losses": losses, "grad": first,
            "change": _norms(params, weights), "ema_change": _norms(opt.ema, weights)}


def step_from(s: Schedule, make_model: Callable[[Dict[str, torch.Tensor]], Model],
              state: dict, batch: Tuple[torch.Tensor, ...], null: int, lr: float,
              decay: float) -> dict:
    """One step of ``batch`` from ``state`` (params, m, v, ema: dicts of
    leaves; steps: the steps taken before it): its loss, each leaf's
    gradient, and each leaf's change and its EMA's change."""
    before = state["params"]
    params = {k: v.detach().clone().requires_grad_(True) for k, v in before.items()}
    opt = Adam(params, lr, decay)
    opt.m = {k: v.clone() for k, v in state["m"].items()}
    opt.v = {k: v.clone() for k, v in state["v"].items()}
    opt.ema = {k: v.clone() for k, v in state["ema"].items()}
    opt.steps = int(state["steps"])
    value, grads = _step(s, make_model(params), params, opt, batch, null)
    return {"loss": value, "grad": _norms(grads), "change": _norms(params, before),
            "ema_change": _norms(opt.ema, state["ema"])}
