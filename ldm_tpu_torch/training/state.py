"""TrainState: everything a training step changes (port of ldm_tpu/training/state.py).

The model, an EMA copy of it, Adam and the step counter.  Adam has optax's
formula and hyperparameters (betas 0.9/0.999, eps 1e-8: ``make_optimizer``);
the EMA is ``ema = d*ema + (1-d)*params`` after each update, with the warmup
``d = min(decay, (1+step)/(10+step))`` taken at the step BEFORE the
increment, as ``TrainState.apply_gradients`` does.

Updates are in place, on the device, as one pass over every leaf: the JAX
package's ``fused_apply_gradients`` (:func:`fused_apply_gradients` here),
Adam and the EMA together with optax's association, which
:meth:`TrainState.update` runs at every step (``ops/fused_adam_ema.py``: one
launch of a Hopper kernel on a card, the plain version on the CPU).
``torch.optim.Adam`` only holds the state (``exp_avg``, ``exp_avg_sq`` and
``step`` a leaf, the hyperparameters), so checkpoints keep its layout; its
``step()`` is never called.  The kernel bumps the version counters of what
it wrote, which ``LinAttnBlock.kernel_weights`` keys its cached
kernel-layout copies on.

The update is a function of device tensors alone, so that a CUDA graph can
replay it: the step counter that the EMA warmup reads is a device tensor
that the update increments itself (beside the host's ``step``, which the
per-step generator and the checkpoints use), the EMA weight is computed from
it on the device, and on a CUDA device Adam's step counts are device
tensors (``capturable``), which the pass reads and then increments.
:meth:`TrainState.update` is that part; :meth:`TrainState.count_step` is
what the host does a step, and after a replayed step
:meth:`TrainState.count_replayed_step` also tells both models that their
weights changed without a version counter moving.
The per-step random stream is :func:`step_generator`, the counterpart of
``fold_in(key, step)``: a generator seeded from (seed, step), so a resumed
run continues the stream without saving generator state.

A model's BatchNorm statistics (the JAX state's ``batch_stats``) are buffers
of the model: they travel in ``state_dict()`` with its parameters.  The
classifier keeps no EMA (``ema=False``): the JAX classifier updates one but
never reads it (evaluation and ``load_best`` use the raw parameters and
``batch_stats``).

Under a mesh (``parallel/mesh.py``) each process holds its rows of the
global batch, and :meth:`TrainState.reduce_grads` makes the gradients the
global batch's before Adam: with ``param_sharding`` ``"replicated"`` (plain
DP) one all-reduce of one flat bucket of every gradient and the loss; with
``"fsdp"`` the model and the EMA are sharded by the leaf rule
(``parallel/fsdp.py``), FSDP2 reduce-scatters the sharded leaves' gradients
in the backward, and the bucket holds the replicated leaves' and the loss.
:meth:`TrainState.norm` is the global norm (under FSDP a cross-process sum
of the shards' squares).  Adam and the EMA run on each process's shards.
:meth:`TrainState.state_dict` is then the whole state, gathered (every
process calls it); :meth:`TrainState.load_state_dict` takes a whole state
and keeps each process's chunk.

Under a model axis (``"tp"``, ``"fsdp_tp"``; ``parallel/tp.py``) the
attention projections of the model and the EMA are this process's heads'
shares, plain tensors that Adam and the EMA update in place; under
``"fsdp_tp"`` FSDP2 shards the other large leaves over the data axis and
ignores the shares.  Every gradient FSDP2 does not reduce, the shares'
included, is averaged over the data axis alone: *f* and *g* leave a
replicated leaf's gradient the same on every process of a model group.
:meth:`TrainState.norm` sums the shares' squares over the model axis and
counts a replicated leaf once; the whole state gathers the shares and
re-slices them on load, so a checkpoint moves between one process and a
model axis bit for bit.  Under spatial parallelism (``spatial``) each
process's loss and gradients are its image rows' terms: they are summed
over the model axis and averaged over the data axis.
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

import torch.distributed as dist

from ldm_tpu_torch.ops.fused_adam_ema import fused_adam_ema
from ldm_tpu_torch.parallel import fsdp, tp
from ldm_tpu_torch.utils.logging import global_norm


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
    """Model, EMA model (None with ``ema=False``), Adam (optax's formula)
    and the step counter."""

    def __init__(self, model: nn.Module, lr: float, ema_decay: float = 0.9999,
                 ema: bool = True, mesh=None, param_sharding: str = "replicated",
                 spatial: bool = False):
        """``mesh``: a ``parallel.Mesh`` (None: one process);
        ``param_sharding``: ``"replicated"``, ``"fsdp"``, ``"tp"`` or
        ``"fsdp_tp"`` under a mesh; ``spatial``: the loss and gradients are
        each process's image rows' terms (spatial parallelism)."""
        self.model = model
        self.ema = copy.deepcopy(model).requires_grad_(False).eval() if ema else None
        self.mesh = mesh
        self.sharding = "replicated"
        self.spatial = spatial
        if mesh is not None:
            fsdp.check_modes(param_sharding)
            self.sharding = param_sharding
        # the tensor-parallel shares by name (empty without a model axis)
        self.tp_layout: dict = {}
        models = [m for m in (model, self.ema) if m is not None]
        if self.sharding in ("tp", "fsdp_tp"):
            for m in models:
                self.tp_layout = tp.shard_module(m, mesh)
        if self.sharding in ("fsdp", "fsdp_tp"):
            for m in models:
                fsdp.shard_module(m, mesh, ignored=[p for n, p in m.named_parameters()
                                                    if n in self.tp_layout])
        self.lr = float(lr)
        self.ema_decay = float(ema_decay)
        device = next(model.parameters()).device
        # Adam's state as a capturable Adam keeps it (its step counts on the
        # device), so a CUDA graph can replay the pass; on CPU parameters some
        # PyTorch versions refuse the flag
        self.capturable = device.type == "cuda"
        self.optimizer = torch.optim.Adam(
            fsdp.param_groups(list(model.parameters())), lr=self.lr, betas=(0.9, 0.999),
            eps=1e-8, capturable=self.capturable,
        )
        self._adam_state()
        self.step = 0
        self.step_t = torch.zeros((), dtype=torch.int64, device=device)  # step, on the device
        names = {id(p): n for n, p in model.named_parameters()}
        # the optimizer's parameter indices' names, and which parameters are shares
        self._opt_names = [names[id(p)] for g in self.optimizer.param_groups for p in g["params"]]
        self._tp_flags = [n in self.tp_layout for n, _ in model.named_parameters()]

    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())

    @torch.no_grad()
    def reduce_grads(self, loss: torch.Tensor, mean: bool = True) -> torch.Tensor:
        """After the backward of this process's ``loss``: the gradients of
        the global batch in ``.grad``, and the global batch's loss (a device
        scalar).  ``mean``: the loss is a mean over the batch, so the
        processes' gradients and losses are averaged; else (a sum over the
        batch) summed.  Without a mesh: the loss alone."""
        loss = loss.detach()
        if self.mesh is None:
            return loss
        grads = [p.grad for p in self.params()]
        # one bucket, one all-reduce: every gradient FSDP2 does not reduce
        # (all of them under plain DP) and the loss
        plain = [g for g in grads if not fsdp.is_sharded(g)]
        flat = torch.cat([g.reshape(-1) for g in plain] + [loss.reshape(1).to(plain[0].dtype)]
                         if plain else [loss.reshape(1)])
        if self.spatial:
            self.mesh.split_mean_(flat)
        elif mean:
            self.mesh.all_reduce_mean_(flat)
        else:
            self.mesh.all_reduce_(flat)
        if plain:
            torch._foreach_copy_(plain, [v.view_as(g) for v, g in zip(
                flat[:-1].split([g.numel() for g in plain]), plain)])
        return flat[-1].to(loss.dtype)

    @torch.no_grad()
    def norm(self, tensors) -> torch.Tensor:
        """The global L2 norm of tensors placed as the state's leaves are
        (its parameters, their gradients, in the parameters' order): under
        FSDP the shards' squares summed over the data axis and the TP
        shares' over the model axis (collectives), plus the replicated
        leaves' once."""
        tensors = list(tensors)
        if self.sharding == "replicated" or (self.sharding == "tp" and not self.tp_layout):
            return global_norm(tensors)
        shares = [t for t, f in zip(tensors, self._tp_flags) if f]
        plain = [t for t, f in zip(tensors, self._tp_flags) if not f and not fsdp.is_sharded(t)]
        sq = torch.zeros((), device=self.step_t.device)
        if self.sharding in ("fsdp", "fsdp_tp"):
            shards = [fsdp.local(t) for t in tensors if fsdp.is_sharded(t)]
            if shards:
                sq = torch.stack(torch._foreach_norm(shards)).square().sum()
            self.mesh.all_reduce_(sq)
        if shares:
            sq_m = torch.stack(torch._foreach_norm(shares)).square().sum()
            dist.all_reduce(sq_m, group=self.mesh.model_group)
            sq = sq + sq_m
        if plain:
            sq = sq + global_norm(plain).square()
        return sq.sqrt()

    def hparams(self) -> tuple:
        """Adam's ``(lr, b1, b2, eps)``: the one set its parameter groups hold."""
        found = {(float(g["lr"]), *map(float, g["betas"]), float(g["eps"]))
                 for g in self.optimizer.param_groups}
        if len(found) != 1:
            raise ValueError(f"Adam's parameter groups differ in their hyperparameters: {found}")
        return found.pop()

    def _adam_state(self) -> list[dict]:
        """Adam's state of each parameter, made as ``torch.optim.Adam`` makes it
        where it is missing (zero moments, step 0 on the device when
        capturable, on the CPU otherwise)."""
        out = []
        for p in self.params():
            st = self.optimizer.state[p]
            if not st:
                where = p.device if self.capturable else torch.device("cpu")
                st["step"] = torch.zeros((), dtype=torch.float32, device=where)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            out.append(st)
        return out

    @torch.no_grad()
    def update(self) -> None:
        """The device's part of a step: Adam on the parameters' ``.grad`` and
        the EMA with the weight of the device step counter, in one pass over
        every leaf (:func:`fused_apply_gradients`'s arithmetic); then Adam's
        step counts of the leaves with a gradient, and the device step
        counter, += 1.  Under FSDP each process moves its own shards."""
        lr, b1, b2, eps = self.hparams()
        params = self.params()
        adam = self._adam_state()
        d = ema_decay_tensor(self.ema_decay, self.step_t) if self.ema is not None else None
        fused_adam_ema(
            [fsdp.local(p) for p in params],
            [None if p.grad is None else fsdp.local(p.grad) for p in params],
            [fsdp.local(st["exp_avg"]) for st in adam],
            [fsdp.local(st["exp_avg_sq"]) for st in adam],
            None if self.ema is None else [fsdp.local(e) for e in self.ema.parameters()],
            [st["step"] for st in adam], d, lr, b1, b2, eps)
        # after the pass, never in it: the kernel's CTAs all read the counts
        counts = [st["step"] for st, p in zip(adam, params) if p.grad is not None]
        if counts:
            torch._foreach_add_(counts, 1.0)
        self.step_t += 1

    def count_step(self) -> None:
        """The host's part of a step.  Under FSDP, also word to both models
        that their weights moved: FSDP2 all-gathers them into storage it
        keeps, possibly at the same address, and leaves its version counter
        as it was, while Adam moved only the shards."""
        self.step += 1
        if self.sharding in ("fsdp", "fsdp_tp"):
            self._weights_moved()

    def count_replayed_step(self) -> None:
        """After a replay of a captured :meth:`update`: the host's count, and
        word to both models that their weights changed in place."""
        self.step += 1
        self._weights_moved()

    def _weights_moved(self) -> None:
        for m in (self.model, self.ema):
            replayed = getattr(m, "weights_replayed", None) if m is not None else None
            if replayed is not None:
                replayed()

    def apply_gradients(self) -> None:
        """Adam on the parameters' ``.grad``, then the EMA, then step += 1."""
        self.update()
        self.count_step()

    @torch.no_grad()
    def restart(self) -> None:
        """Back to step 0 with Adam's moments and step counts zeroed in place
        (a captured step keeps their addresses); the caller re-initializes
        the model's weights and buffers."""
        for st in self.optimizer.state.values():
            for v in st.values():
                if torch.is_tensor(v):
                    v.zero_()
        self.step = 0
        self.step_t.zero_()

    def _tp_opt_state(self, state: dict, leaf_fn) -> dict:
        """Adam's per-parameter state with ``leaf_fn(tensor, layout)`` applied
        to the moments of every TP share."""
        out = {}
        for i, st in state.items():
            leaf = self.tp_layout.get(self._opt_names[int(i)])
            out[i] = st if leaf is None else {
                k: leaf_fn(v, leaf) if torch.is_tensor(v) and v.dim() > 0 else v
                for k, v in st.items()}
        return out

    def state_dict(self) -> dict:
        """The whole state; under FSDP and a model axis gathered from the
        shards and shares (a collective: every process calls it)."""
        sd = {"step": self.step, "model": self.model.state_dict(),
              "optimizer": self.optimizer.state_dict()}
        if self.ema is not None:
            sd["ema"] = self.ema.state_dict()
        if self.tp_layout:
            for part in ("model", "ema"):
                if part in sd:
                    sd[part] = tp.gather_state(sd[part], self.tp_layout, self.mesh)
            sd["optimizer"] = dict(sd["optimizer"], state=self._tp_opt_state(
                sd["optimizer"]["state"], lambda v, leaf: tp.gather(v, leaf, self.mesh)))
        return fsdp.full_tree(sd) if self.sharding in ("fsdp", "fsdp_tp") else sd

    def load_state_dict(self, sd: dict) -> None:
        """A whole state (:meth:`state_dict`'s); under FSDP and a model axis
        each process keeps its chunk of every sharded leaf and its share of
        every TP leaf."""
        if self.tp_layout:
            m = self.mesh
            sd = dict(sd)
            for part in ("model", "ema"):
                if part in sd:
                    sd[part] = tp.local_state(sd[part], self.tp_layout, m)
            sd["optimizer"] = dict(sd["optimizer"], state=self._tp_opt_state(
                sd["optimizer"]["state"],
                lambda v, leaf: tp.local_slice(v, leaf, m.model_rank, m.model_size)))
        if self.sharding in ("fsdp", "fsdp_tp"):
            fsdp.load_full_state_dict(self.model, sd["model"])
            if self.ema is not None:
                fsdp.load_full_state_dict(self.ema, sd["ema"])
        else:
            self.model.load_state_dict(sd["model"], strict=True)
            if self.ema is not None:
                self.ema.load_state_dict(sd["ema"], strict=True)
        # a checkpoint written on another kind of device carries its
        # optimizer's ``capturable``: this device's holds (torch then puts
        # Adam's step counts where a capturable optimizer wants them)
        opt = dict(sd["optimizer"])
        opt["param_groups"] = [dict(g, capturable=self.capturable)
                               for g in opt["param_groups"]]
        if self.sharding in ("fsdp", "fsdp_tp"):
            params = [p for g in self.optimizer.param_groups for p in g["params"]]
            opt["state"] = {i: {k: fsdp.shard_like(v, params[int(i)])
                                if torch.is_tensor(v) and v.dim() > 0 else v
                                for k, v in st.items()}
                            for i, st in opt["state"].items()}
        self.optimizer.load_state_dict(opt)
        self._adam_state()  # a state written before the first step holds none
        self.step = int(sd["step"])
        self.step_t.fill_(self.step)


def fused_apply_gradients(state: TrainState, lr: float, b1: float = 0.9, b2: float = 0.999,
                          eps: float = 1e-8) -> None:
    """``state.apply_gradients()`` stated as the JAX package's
    ``fused_apply_gradients``: Adam and the EMA in one explicit pass over
    every leaf (p, g, m, v and ema read, p, m, v and ema written: 36 bytes a
    parameter), on the gradients in ``.grad``, then step += 1; in place.

    ``lr``, ``b1``, ``b2`` and ``eps`` must be the hyperparameters Adam's state
    holds (the drift guard of the JAX function): the moments belong to them,
    and a pass with others, a wrong ``lr`` the likeliest, would move the
    parameters silently.  Any mismatch raises ``AssertionError``."""
    known = state.hparams()
    if known != (float(lr), b1, b2, eps):
        raise AssertionError(f"state.optimizer is Adam{known} but the fused pass was given "
                             f"({lr}, {b1}, {b2}, {eps})")
    state.apply_gradients()
