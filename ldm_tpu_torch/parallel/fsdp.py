"""FSDP (ZeRO-3) over the data axis (port of ldm_tpu/parallel/fsdp.py).

The JAX package annotates each state leaf with a sharding and lets GSPMD
insert the all-gathers and reduce-scatters.  Here the same leaf rule,
:func:`fsdp_leaf_spec`, a pure function of a shape, is applied through
FSDP2's ``fully_shard``: every parameter the rule shards becomes a
``DTensor`` sharded on the rule's dimension (``shard_placement_fn``), and
FSDP2 all-gathers the weights before the forward and the backward and
reduce-scatters the gradients (as a mean) after it.  The leaves the rule
replicates (under 4,096 elements, or with no dimension divisible by the
data axis) are passed to ``fully_shard`` as ``ignored_params``: they stay
plain tensors, whole on every process, and the trainer all-reduces their
gradients itself (``TrainState.reduce_grads``).  The EMA model is sharded
by the same rule, so Adam's moments, the parameters and the EMA of a leaf
have one placement and the update needs no communication.

One ``fully_shard`` unit covers the whole model, resharded after the
forward (the backward gathers again): one all-gather and one
reduce-scatter a step for the weights of every layer.

Under ``"fsdp_tp"`` the attention projections are tensor-parallel over
the model axis (``parallel/tp.py``) and FSDP2 ignores them too; its
``DeviceMesh`` is the data axis's group.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import torch
from torch import nn

from ldm_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

# the JAX rule's: leaves under 4,096 elements (16 KiB fp32) stay replicated
MIN_SHARD_SIZE = 2 ** 12
MODES = ("replicated", "fsdp", "tp", "fsdp_tp")
ACTIVATION_MODES = ("batch", "spatial")


def fsdp_shard_dim(shape: Sequence[int], n: int, min_size: int = MIN_SHARD_SIZE
                   ) -> Optional[int]:
    """The dimension the rule shards a leaf of ``shape`` on over ``n``
    processes, or None (replicated): the largest dimension divisible by n,
    the earliest on a tie; small or indivisible leaves stay replicated."""
    size = 1
    for d in shape:
        size *= int(d)
    if n == 1 or size < min_size:
        return None
    best = None  # (dim size, index)
    for i, d in enumerate(shape):
        if int(d) % n == 0 and (best is None or int(d) > best[0]):
            best = (int(d), i)
    return None if best is None else best[1]


def fsdp_leaf_spec(shape: Sequence[int], n: int, axis: str = DATA_AXIS,
                   min_size: int = MIN_SHARD_SIZE) -> tuple:
    """The rule as a JAX ``PartitionSpec`` reads: ``()`` replicated, else
    one entry a dimension, ``axis`` on the sharded one and None elsewhere."""
    dim = fsdp_shard_dim(shape, n, min_size)
    if dim is None:
        return ()
    return tuple(axis if i == dim else None for i in range(len(shape)))


def check_modes(param_sharding: str, activation_sharding: str = "batch") -> None:
    """Raise for a placement that does not exist."""
    if param_sharding not in MODES:
        raise ValueError(f"unknown param_sharding {param_sharding!r} (expected one of {MODES})")
    if activation_sharding not in ACTIVATION_MODES:
        raise ValueError(f"unknown activation_sharding {activation_sharding!r} "
                         f"(expected one of {ACTIVATION_MODES})")


def shard_module(module: nn.Module, mesh: Mesh, ignored: Iterable[nn.Parameter] = ()
                 ) -> nn.Module:
    """``fully_shard`` over the mesh's data axis with the leaf rule: the
    parameters it shards become DTensors, the rest (and ``ignored``: the
    tensor-parallel shares) stay plain, ignored by FSDP2: their gradients
    are the caller's to reduce.  In place."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size
    ignored = set(ignored) | {p for p in module.parameters()
                              if fsdp_shard_dim(p.shape, n) is None}

    def placement(p: nn.Parameter):
        return Shard(fsdp_shard_dim(p.shape, n))

    fully_shard(module, mesh=mesh.device_mesh(), reshard_after_forward=True,
                shard_placement_fn=placement, ignored_params=ignored)
    return module


def is_sharded(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def local(t: torch.Tensor) -> torch.Tensor:
    """This process's part of a tensor: a DTensor's local shard (the same
    storage: an in-place update of it updates the DTensor), else ``t``."""
    return t.to_local() if is_sharded(t) else t


def full(t: torch.Tensor) -> torch.Tensor:
    """A tensor whole: a DTensor all-gathered (a collective: every process
    calls it in the same order), else ``t``."""
    return t.full_tensor() if is_sharded(t) else t


def full_tree(tree):
    """:func:`full` over a state_dict-like tree (dicts, lists, tuples)."""
    if isinstance(tree, torch.Tensor):
        return full(tree)
    if isinstance(tree, dict):
        return {k: full_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tree(v) for v in tree)
    return tree


def shard_like(whole: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``whole`` placed as ``ref`` is: a DTensor of ``whole``'s chunk of this
    process along ``ref``'s shard dimension (no communication: every process
    holds ``whole``), or ``whole`` itself where ``ref`` is plain."""
    if not is_sharded(ref):
        return whole
    from torch.distributed.tensor import DTensor

    (placement,) = ref.placements
    mesh = ref.device_mesh
    chunk = whole.chunk(mesh.size(), dim=placement.dim)[mesh.get_local_rank()]
    return DTensor.from_local(chunk.to(ref.device).contiguous(), mesh, ref.placements,
                              shape=ref.shape, stride=ref.stride())


@torch.no_grad()
def load_full_state_dict(module: nn.Module, sd: dict) -> None:
    """Load a whole (gathered) state_dict into a module whose parameters
    may be sharded: each process copies its chunk; strict on the keys."""
    own = module.state_dict()
    missing, unexpected = set(own) - set(sd), set(sd) - set(own)
    if missing or unexpected:
        raise RuntimeError(f"state_dict keys: missing {sorted(missing)}, "
                           f"unexpected {sorted(unexpected)}")
    for name, t in own.items():
        local(t).copy_(local(shard_like(sd[name].to(t.device), t)))


def sharded_bytes_per_device(tensors: Iterable[torch.Tensor]) -> int:
    """Bytes this process holds of ``tensors`` (a DTensor's local shard, a
    plain tensor whole): the memory observable of FSDP."""
    return sum(local(t).nbytes for t in tensors)


def param_groups(params: List[nn.Parameter]) -> List[dict]:
    """Adam's parameter groups: the sharded parameters and the plain ones
    apart (a multi-tensor kernel takes one kind), or one group."""
    sharded = [p for p in params if is_sharded(p)]
    plain = [p for p in params if not is_sharded(p)]
    return [{"params": g} for g in (sharded, plain) if g]
