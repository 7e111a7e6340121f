"""Tensor parallelism over the mesh's model axis (port of ldm_tpu/parallel/tp.py).

The UNet's attention sites are the tensor-parallel ones: their hidden width
is heads x dim_head, and nothing crosses heads before the output
projection.  So the Megatron split applies: each process of a data row's
model group computes heads ``[m*h/M, (m+1)*h/M)`` end to end, from their
q, k and v rows of ``to_qkv`` and their columns of ``to_out``, and one
all-reduce after the output projection sums the processes' parts
(``ops/collectives.py``: *f* before the heads, *g* after them).
Everything else (convolutions, norms, embeddings, every bias, a ResNet
block's time projection) is replicated over the model axis.

:func:`tp_leaf_spec` is JAX's ``tp_leaf_sharding`` as a pure function of a
parameter's name and shape, in the port's reference-layout names: a
``to_qkv.weight`` (3H, C, 1, 1) is JAX's ``qkv_kernel`` / ``Attention_0
/Dense_0`` (C, 3H) sharded on its last dimension, so torch's dimension 0;
a ``to_out`` weight (C, H, 1, 1) is ``out_kernel`` / ``Dense_1`` (H, C)
sharded on its first, so torch's dimension 1; a dimension the axis does
not divide, and every leaf at M = 1, stays replicated.
:func:`fsdp_tp_leaf_spec` is ``fsdp_tp_shardings``'s rule: the TP spec
where there is one, else the FSDP rule over the data axis.

The layout differs from JAX's where the spec cannot say it.  JAX's spec
places a contiguous block of the stacked ``[q | k | v]`` columns on each
process (at M = 2 process 0 holds all of q and half of k), which is no head
group, and GSPMD permutes kernel slices to compute per head.  A process
here stores the rows of its own heads, ``[q_m | k_m | v_m]`` (the Megatron
layout): a share of the spec's size, and :func:`gather` puts the rows back
where the whole tensor has them, so a gathered ``state_dict`` is the
one-process ``state_dict`` exactly.

The fused attention kernels end with the output projection, GroupNorm and
the residual, which a head slice cannot compute without a collective inside
the kernel; under a model axis > 1 every attention block takes the
plain path (``LinAttnBlock(impl="torch")``, which computes the heads whose
weights it holds) and launches no kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import torch
import torch.distributed as dist
from torch import nn

from ldm_tpu_torch.ops.collectives import place
from ldm_tpu_torch.parallel import fsdp
from ldm_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Mesh


class TpLeaf(NamedTuple):
    """How a sharded leaf lies: split along ``dim`` into ``parts`` blocks
    (q, k, v: 3; an output projection: 1), each cut into M shares, a
    process holding its share of every block."""

    dim: int
    parts: int


def _leaf(names: Sequence[str], shape: Sequence[int]):
    """(torch dim, parts) of an attention projection's weight, or None."""
    if len(shape) < 2 or not names or names[-1] != "weight":
        return None
    owner = list(names[:-1])
    if owner[-1:] == ["to_qkv"]:
        return TpLeaf(0, 3)
    if owner[-1:] == ["to_out"] or owner[-2:] == ["to_out", "0"]:
        return TpLeaf(1, 1)
    return None


def tp_leaf_spec(names: Sequence[str], shape: Sequence[int], n: int,
                 axis: str = MODEL_AXIS) -> tuple:
    """The rule for the parameter ``names`` (its dotted name split) of
    ``shape`` over a model axis of ``n``, as a JAX ``PartitionSpec`` reads:
    ``()`` replicated, else one entry a dimension, ``axis`` on the sharded
    one and None elsewhere."""
    leaf = _leaf(names, shape)
    if n == 1 or leaf is None or int(shape[leaf.dim]) % n:
        return ()
    return tuple(axis if i == leaf.dim else None for i in range(len(shape)))


def fsdp_tp_leaf_spec(names: Sequence[str], shape: Sequence[int], data: int,
                      model: int) -> tuple:
    """The 2-D rule: an attention projection's TP spec over the model axis,
    else the FSDP rule over the data axis (a TP leaf is not sharded over
    data as well)."""
    return tp_leaf_spec(names, shape, model) or fsdp.fsdp_leaf_spec(shape, data, DATA_AXIS)


def local_slice(whole: torch.Tensor, leaf: TpLeaf, rank: int, size: int) -> torch.Tensor:
    """Process ``rank``'s share of ``whole``: its block of each part, in order."""
    parts = whole.chunk(leaf.parts, dim=leaf.dim)
    return torch.cat([p.chunk(size, dim=leaf.dim)[rank] for p in parts], dim=leaf.dim)


def gather(share: torch.Tensor, leaf: TpLeaf, mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every model process's share (a zero-padded
    all-reduce over the model group: every process calls it)."""
    whole = torch.cat([place(block, leaf.dim, mesh.model_rank, mesh.model_size)
                       for block in share.chunk(leaf.parts, dim=leaf.dim)], dim=leaf.dim)
    dist.all_reduce(whole, group=mesh.model_group)
    return whole


def shard_module(module: nn.Module, mesh: Mesh) -> Dict[str, TpLeaf]:
    """Replace every parameter the rule shards by this process's share (a
    plain parameter) and give its attention module the model axis's group;
    in place.  Returns the sharded parameters' names and layouts (empty at
    M = 1).  A model axis that does not split an attention's heads raises."""
    n = mesh.model_size
    layout: Dict[str, TpLeaf] = {}
    for name, p in list(module.named_parameters()):
        names = name.split(".")
        if not tp_leaf_spec(names, p.shape, n):
            continue
        leaf = _leaf(names, p.shape)
        owner_name = ".".join(names[:names.index("to_qkv" if leaf.parts == 3 else "to_out")])
        attention = module.get_submodule(owner_name)
        if attention.heads % n:
            raise ValueError(f"a model axis of {n} does not split the {attention.heads} "
                             f"heads of {owner_name}")
        holder = module.get_submodule(".".join(names[:-1]))
        share = local_slice(p.detach(), leaf, mesh.model_rank, n).clone()
        holder.weight = nn.Parameter(share, requires_grad=p.requires_grad)
        attention.model_group = mesh.model_group
        layout[name] = leaf
    return layout


def gather_state(sd: dict, layout: Dict[str, TpLeaf], mesh: Mesh) -> dict:
    """A module ``state_dict`` with every TP share gathered whole (a
    collective)."""
    return {k: gather(v, layout[k], mesh) if k in layout else v for k, v in sd.items()}


def local_state(sd: dict, layout: Dict[str, TpLeaf], mesh: Mesh) -> dict:
    """A whole module ``state_dict`` with this process's share of every TP
    leaf (no communication)."""
    return {k: local_slice(v, layout[k], mesh.model_rank, mesh.model_size)
            if k in layout else v for k, v in sd.items()}
