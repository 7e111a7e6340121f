"""Pipeline parallelism over the mesh's model axis (port of ldm_tpu/parallel/pp.py).

The UNet's skip connections admit one cut: every skip crosses the
bottleneck, so the cut sits there.  Stage 0 is the conditioning, the stem,
the encoder and the bottleneck (``UNet.encode``); stage 1 is the decoder and
the head (``UNet.decode``), and ``UNet.forward`` is ``decode(*encode(...))``,
so the staged model is the whole one by construction.  What crosses the cut
is the payload: (h_mid, every skip in level order, t_emb), packed into one
flat buffer in the compute dtype, in the JAX package's order and NHWC
layout.  Its size follows from the architecture and the microbatch's shape,
so the receiving stage allocates it before anything arrives.

The counterparts of the JAX module's names:

* ``split_unet_params`` -> :func:`split_unet_state_dict` (by name prefix;
  a name of neither stage raises);
* ``unet_stage0`` / ``unet_stage1`` / ``unet_staged_apply`` ->
  ``UNet.encode`` / ``UNet.decode`` / ``UNet.forward``;
* ``pack_tree`` / ``unpack_tree`` / ``tree_size`` / ``_payload_template``
  -> :func:`pack_payload` / :func:`unpack_payload` / :func:`payload_shapes`;
* ``PPParams`` / ``pp_pack_params`` -> :func:`pp_stage`: the UNet with the
  other stage's submodules deleted, so a process holds exactly its stage's
  parameters (no (K, Pmax) stack and no padding); ``PPParams.stage_trees``
  -> :func:`gather_state_dict`;
* ``pipeline_unet_apply`` / ``make_pp_apply`` -> the same names.

The schedule is GPipe's: the batch splits into M microbatches; stage 0 runs
``encode`` on each and sends its payload, stage 1 receives it and runs
``decode``.  A transfer is a broadcast over the model group
(``ops/collectives.py::stage_transfer``): gloo offers no send / recv for
CUDA tensors.  Stage 1's output goes to every process of its model group by
one more broadcast (JAX's ``psum`` over the axis), and over the data axis by
a gather, so every process holds the whole batch's eps: the samplers'
contract.  The data axis passes through: each data row runs its own
pipeline on its rows (``Mesh.local_rows``).

The backward is the reverse pipeline, and this module makes its transfers
itself (:class:`_Pipeline`).  JAX gets it from ``jax.grad``: the transpose
of ``ppermute`` is the reverse permutation.  Here each process's autograd
graph would hold M independent microbatch branches, and the autograd engine
promises no order in which it visits them, the same on no two processes;
gloo pairs broadcasts up in call order, so a transfer made from the
engine's walk could deadlock or hand one microbatch's gradient to another.
So the forward runs the stages under ``enable_grad`` and keeps each
microbatch's graph, and the backward walks the microbatches in reverse:
stage 1 differentiates its stash and sends each payload gradient, stage 0
receives it and differentiates its own.  The stage's parameter gradients
are returned as the function's gradients for them (summed over the
microbatches and over the data axis) and never reach ``.grad`` twice.
Every process gets the same eps with a gradient, and a caller writes
``loss.backward()`` on the loss of the whole batch, as JAX's test writes
``jax.grad``.  Only stage 1 reads the output's gradient (*g*'s rule; an
all-reduce there would double it).  The data rows' parts of a stage's
gradient are summed over the data group: every process differentiates the
same loss of the whole batch, and each data row holds its own rows' part.

Over gloo every step runs eagerly (a gloo collective cannot be captured in
a CUDA graph): :func:`make_pp_apply` carries the mesh, and the samplers'
loop asks ``utils/graphs.py::use_graphs`` with it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ldm_tpu_torch.ops.collectives import stage_transfer
from ldm_tpu_torch.utils.logging import global_norm

# the UNet's top-level submodules by stage, in registration order
STAGE_MODULES = (("time_emb", "label_emb", "initial_conv", "encoder", "bottleneck"),
                 ("decoder", "final_conv"))
N_STAGES = len(STAGE_MODULES)


# ------------------------------------------------------------------- split
def split_unet_state_dict(state_dict: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], ...]:
    """The whole UNet's ``state_dict`` as one dict a stage, names kept (each
    loads into its :func:`pp_stage` with ``strict=True``); a name under
    neither stage's submodules raises."""
    parts: Tuple[dict, ...] = tuple({} for _ in STAGE_MODULES)
    for name, value in state_dict.items():
        root = name.split(".", 1)[0]
        k = [k for k, modules in enumerate(STAGE_MODULES) if root in modules]
        if not k:
            raise ValueError(f"{name!r} is in no stage of the UNet's pipeline cut")
        parts[k[0]][name] = value
    return parts


def _check_model_axis(mesh) -> None:
    if mesh.model_size != N_STAGES:
        raise ValueError(f"the UNet's pipeline has {N_STAGES} stages; the mesh's model axis "
                         f"has {mesh.model_size}")


def pp_stage(mesh, model):
    """This process's stage (``mesh.model_rank``) of ``model``, in place: the
    UNet with the other stage's submodules set to None.  Its parameters keep
    the whole UNet's names; ``stage_layout`` records every stage's names,
    shapes and dtypes (what :func:`gather_state_dict` receives into)."""
    _check_model_axis(mesh)
    if model.time_emb is None:
        raise ValueError("the pipeline's payload carries t_emb: it needs the time-conditional "
                         "UNet")
    model.stage_layout = tuple({n: (tuple(v.shape), v.dtype) for n, v in part.items()}
                               for part in split_unet_state_dict(model.state_dict()))
    for name in STAGE_MODULES[1 - mesh.model_rank]:
        setattr(model, name, None)
    return model


def gather_state_dict(stage, mesh) -> Dict[str, torch.Tensor]:
    """The whole UNet's ``state_dict`` on every process of the model group:
    each stage's tensors flat in one fp32 buffer, broadcast from the stage
    that holds them (a collective: every process calls it)."""
    own = stage.state_dict()
    out = {}
    for k, layout in enumerate(stage.stage_layout):
        if k == mesh.model_rank:
            buf = torch.cat([own[n].reshape(-1).float() for n in layout])
        else:
            numel = sum(math.prod(shape) for shape, _ in layout.values())
            buf = torch.empty(numel, dtype=torch.float32, device=mesh.device)
        stage_transfer(buf, mesh.model_group, k)
        off = 0
        for name, (shape, dtype) in layout.items():
            n = math.prod(shape)
            out[name] = buf[off:off + n].view(shape).to(dtype)
            off += n
    return out


def grad_norm(stage, mesh) -> torch.Tensor:
    """The L2 norm of the whole UNet's gradient: each stage's squares,
    summed over the model group (a collective)."""
    grads = [p.grad for p in stage.parameters() if p.grad is not None]
    sq = global_norm(grads).square()
    dist.all_reduce(sq, group=mesh.model_group)
    return sq.sqrt()


# ----------------------------------------------------------------- payload
def payload_shapes(model, b: int, h: int, w: int) -> List[Tuple[int, ...]]:
    """The NHWC shapes of (h_mid, the skips in level order, t_emb) for a
    microbatch of ``b`` items of ``h`` x ``w``, from the architecture alone."""
    skips = []
    for c in model.chs[1:]:
        skips.append((b, h, w, c))
        h, w = h // 2, w // 2
    return [(b, h, w, model.chs[-1])] + skips + [(b, model.time_dim)]


def pack_payload(h_mid: torch.Tensor, skips: Sequence[torch.Tensor],
                 t_emb: torch.Tensor) -> torch.Tensor:
    """``encode``'s output as one flat buffer, each activation through its
    NHWC view (contiguous: the activations are NCHW views of channels_last
    memory)."""
    flat = [a.permute(0, 2, 3, 1).reshape(-1) for a in (h_mid, *skips)]
    return torch.cat(flat + [t_emb.reshape(-1)])


def unpack_payload(buf: torch.Tensor, shapes: Sequence[Tuple[int, ...]]):
    """(h_mid, skips, t_emb) as views of ``buf``, each activation an NCHW
    view of NHWC memory as ``encode`` made it: another memory format would
    change ``decode``'s convolution algorithms, and with them its bits."""
    parts, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        v = buf[off:off + n].view(shape)
        parts.append(v.permute(0, 3, 1, 2) if len(shape) == 4 else v)
        off += n
    return parts[0], parts[1:-1], parts[-1]


# ---------------------------------------------------------------- pipeline
class _Schedule:
    """One call's microbatches of this process's rows and the model group's
    stage-to-stage traffic, forward and backward."""

    def __init__(self, mesh, stage, x, t, y, n_microbatches: int):
        _check_model_axis(mesh)
        m, b = int(n_microbatches), x.shape[0]
        if m < 1 or b % m:
            raise ValueError(f"a batch of {b} does not split into {m} microbatches")
        if (b // m) % mesh.size:
            raise ValueError(f"a microbatch of {b // m} does not split over the mesh's data "
                             f"axis ({mesh.size})")
        self.mesh, self.stage, self.m = mesh, stage, m
        self.rank, self.group = mesh.model_rank, mesh.model_group
        self.xs = mesh.local_rows(x).chunk(m)
        self.ts = mesh.local_rows(t).chunk(m)
        self.ys = (None,) * m if y is None else mesh.local_rows(y).chunk(m)
        self.shapes = payload_shapes(stage, self.xs[0].shape[0], *x.shape[1:3])
        self.numel = sum(math.prod(s) for s in self.shapes)
        self.out_shape = (b // mesh.size,) + tuple(x.shape[1:3]) + (stage.out_channels,)

    def run(self, grad: bool):
        """Every microbatch through this process's stage (its graph kept
        when ``grad``), then the whole batch's eps on every process."""
        stage, dev = self.stage, self.xs[0].device
        stash, eps = [], []
        for i in range(self.m):
            if self.rank == 0:
                with torch.set_grad_enabled(grad):
                    payload = pack_payload(*stage.encode(self.xs[i], self.ts[i], self.ys[i]))
                stage_transfer(payload.detach(), self.group, 0)
                stash.append(payload)
            else:
                buf = torch.empty(self.numel, dtype=stage.dtype, device=dev)
                stage_transfer(buf, self.group, 0)
                with torch.set_grad_enabled(grad):
                    e = stage.decode(*unpack_payload(buf.requires_grad_(grad), self.shapes))
                stash.append((buf, e))
                eps.append(e.detach())
        out = (torch.cat(eps) if eps else
               torch.empty(self.out_shape, dtype=torch.float32, device=dev))
        stage_transfer(out, self.group, 1)
        if self.mesh.size > 1:
            out = self.mesh.gather_rows(out)
        return out, (stash if grad else None)

    def backward(self, stash: list, g_out: torch.Tensor, params: Sequence[torch.Tensor]):
        """The stage parameters' gradients: the microbatches in reverse,
        each payload gradient sent from stage 1 to stage 0 in that order,
        then the data rows' parts summed."""
        g_mb = self.mesh.local_rows(g_out).chunk(self.m)
        total: List[Optional[torch.Tensor]] = [None] * len(params)
        for i in reversed(range(self.m)):
            if self.rank == 1:
                buf, e = stash[i]
                d_buf, *parts = torch.autograd.grad(e, [buf, *params], g_mb[i],
                                                    allow_unused=True)
                stage_transfer(d_buf.contiguous(), self.group, 1)
            else:
                payload = stash[i]
                d_payload = torch.empty_like(payload)
                stage_transfer(d_payload, self.group, 1)
                parts = torch.autograd.grad(payload, params, d_payload, allow_unused=True)
            stash[i] = None
            total = [b if a is None else a if b is None else a + b
                     for a, b in zip(total, parts)]
        have = [g for g in total if g is not None]
        if self.mesh.size > 1 and have:
            flat = torch.cat([g.reshape(-1) for g in have])
            self.mesh.all_reduce_(flat)
            for g, part in zip(have, flat.split([g.numel() for g in have])):
                g.copy_(part.view_as(g))
        return total


class _Pipeline(torch.autograd.Function):
    """The schedule with the stage's parameters as inputs: its backward is
    :meth:`_Schedule.backward`, the transfers made in a fixed order."""

    @staticmethod
    def forward(ctx, sched: _Schedule, *params):
        out, ctx.stash = sched.run(grad=True)
        ctx.sched, ctx.params = sched, params
        return out

    @staticmethod
    def backward(ctx, g_out):
        grads = ctx.sched.backward(ctx.stash, g_out, ctx.params)
        ctx.stash = ctx.params = None
        return (None, *grads)


def pipeline_unet_apply(mesh, stage, x: torch.Tensor, t: torch.Tensor,
                        y: Optional[torch.Tensor], n_microbatches: int) -> torch.Tensor:
    """The pipelined ``model(x, t, y)`` over ``mesh``'s model axis:
    ``stage`` is this process's :func:`pp_stage`, ``x`` / ``t`` / ``y`` the
    whole batch (the same on every process), the result the whole batch's
    eps on every process.  The batch must split into ``n_microbatches``,
    and a microbatch over the data axis.  Under grad mode the stage's
    parameters get their gradients through the reverse pipeline (see the
    module's docstring); ``x`` gets none, and asking for it raises.  Every
    process of a model group takes the same path: grad mode on with the
    parameters of both stages requiring grad, or off."""
    sched = _Schedule(mesh, stage, x, t, y, n_microbatches)
    if x.requires_grad and torch.is_grad_enabled():
        raise ValueError("the pipeline differentiates the stage's parameters, not its input")
    params = [p for p in stage.parameters() if p.requires_grad]
    if not (torch.is_grad_enabled() and params):
        return sched.run(grad=False)[0]
    return _Pipeline.apply(sched, *params)


def make_pp_apply(mesh, stage, n_microbatches: int):
    """The pipeline as the samplers' ``(x, t, y) -> eps``: each sampler step
    streams its fused-CFG 2B batch through it.  The callable carries the
    mesh: over gloo the samplers' loop runs eagerly
    (``utils/graphs.py::use_graphs``)."""
    def apply(x: torch.Tensor, t: torch.Tensor, y: Optional[torch.Tensor] = None):
        return pipeline_unet_apply(mesh, stage, x, t, y, n_microbatches)

    apply.mesh = mesh
    return apply
