"""Collectives over the mesh's model axis, each with its exact transpose.

JAX differentiates ``psum``, ``ppermute`` and ``all_gather`` by their
transposes; here each collective the model axis needs is a
``torch.autograd.Function`` whose backward is the transpose of its forward:

* :func:`copy_to_model` (Megatron's *f*): identity forward, all-reduce
  backward.  It stands before a head-sharded projection: each process's
  heads contribute a part of the input's gradient.
* :func:`reduce_from_model` (Megatron's *g*): all-reduce forward, identity
  backward.  It stands after the head-sharded output projection: the sum of
  the parts is every process's, and its gradient is every part's.
  (``torch.distributed.nn.functional.all_reduce`` is not *g*: its backward
  all-reduces too, which multiplies every gradient before the projection by
  the axis's size.)
* :func:`psum_model`: all-reduce both ways, for sums over positions that
  each process holds a share of (spatial parallelism's GroupNorm sums and
  the linear attention's context).
* :func:`gather_rows_model`: every process's rows along a dimension, in
  rank order; backward, the gradient all-reduced and this process's rows.
* :func:`halo_rows`: a block of rows with its neighbours' border rows above
  and below (zeros at the mesh's edges: a 3x3 convolution's padding);
  backward, each halo row's gradient goes back to the process it came from.
* :func:`max_model`: the elementwise maximum over the axis (no gradient:
  a softmax's shift).
* :func:`stage_transfer`: one pipeline stage's buffer to the others of the
  axis (``parallel/pp.py``: the payload forward, its gradient backward).
  The pipeline makes both directions' calls itself, in a fixed order, so it
  is a plain function and not an autograd one.

``gloo`` offers only ``all_reduce`` and ``broadcast`` for CUDA tensors, so
every gather and exchange here is an all-reduce of a zero-padded buffer
(:func:`place`), each entry one process's value plus zeros (exact).  Sums of
16-bit values are reduced in fp32.  *f* and *g* take a ``group`` of None
(the heads all on this process) as the identity.  The module imports
``torch`` alone, so the model's layers can take *f* and *g* without the
``parallel`` package.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, a new tensor of ``t``'s dtype."""
    if t.dtype in (torch.float16, torch.bfloat16):
        out = t.float()
        dist.all_reduce(out, group=group)
        return out.to(t.dtype)
    out = t.clone()
    dist.all_reduce(out, group=group)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PsumModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def place(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    """Zeros of ``size`` times ``x``'s extent along ``dim`` with ``x`` at
    block ``rank``."""
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * size
    out = x.new_zeros(shape)
    out.narrow(dim, rank * n, n).copy_(x)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.rank, ctx.n = group, dim, rank, x.shape[dim]
        return _all_reduce(place(x, dim, rank, size), group)

    @staticmethod
    def backward(ctx, g):
        whole = _all_reduce(g, ctx.group)
        return whole.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(), None, None


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.rank, ctx.size = group, dim, rank, size
        first, last = x.narrow(dim, 0, 1), x.narrow(dim, x.shape[dim] - 1, 1)
        # every process's first and last row, in rank order: (size, 2, ...)
        borders = torch.stack([first, last])
        buf = _all_reduce(place(borders.unsqueeze(0), 0, rank, size), group)
        zero = torch.zeros_like(first)
        up = buf[rank - 1, 1] if rank > 0 else zero
        down = buf[rank + 1, 0] if rank < size - 1 else zero
        return torch.cat([up, x, down], dim=dim)

    @staticmethod
    def backward(ctx, g):
        dim, rank, size = ctx.dim, ctx.rank, ctx.size
        n = g.shape[dim] - 2
        up, down = g.narrow(dim, 0, 1), g.narrow(dim, n + 1, 1)
        # the halo rows' gradients, each at the border row it came from
        buf = up.new_zeros((size, 2) + tuple(up.shape))
        if rank > 0:
            buf[rank - 1, 1] = up
        if rank < size - 1:
            buf[rank + 1, 0] = down
        buf = _all_reduce(buf, ctx.group)
        dx = g.narrow(dim, 1, n).clone()
        dx.narrow(dim, 0, 1).add_(buf[rank, 0])
        dx.narrow(dim, n - 1, 1).add_(buf[rank, 1])
        return dx, None, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *f*: ``x`` forward; the gradient summed over ``group``."""
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's *g*: ``x`` summed over ``group``; the gradient as it is."""
    return x if group is None else _ReduceFromModel.apply(x, group)


def psum_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``, and its gradient too."""
    return _PsumModel.apply(x, group)


def gather_rows_model(x: torch.Tensor, group, dim: int = 1) -> torch.Tensor:
    """Every process's block of ``x`` along ``dim``, in rank order."""
    return _GatherRows.apply(x, group, dim)


def halo_rows(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``x`` with one row more at each end along ``dim``: the previous
    process's last row above, the next one's first row below, zeros at the
    mesh's edges."""
    return _HaloRows.apply(x, group, dim)


@torch.no_grad()
def max_model(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum of ``x`` over ``group``, without a gradient
    (gloo reduces CUDA tensors by ``MAX`` too, through the host)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def stage_transfer(buf: torch.Tensor, group, src: int) -> torch.Tensor:
    """``buf`` of the process at rank ``src`` of ``group`` (the model axis's
    index, not a global rank), in place on every process of the group: a
    broadcast, exact in any dtype."""
    dist.broadcast(buf, src=dist.get_global_rank(group, src), group=group)
    return buf
