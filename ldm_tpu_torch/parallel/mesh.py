"""The ``(data, model)`` mesh (port of ldm_tpu/parallel/mesh.py).

A JAX ``Mesh`` is an array of devices with named axes, and GSPMD inserts the
collectives a sharded program needs.  Here a :class:`Mesh` is a process
group, one process a device, laid out as JAX lays its devices out
(``np.asarray(devices).reshape(data, model)``): process ``r`` of P sits at
``(r // model, r % model)``.  Each axis has its process groups: a data group
joins the processes of one model column (stride ``model``), a model group the
``model`` consecutive processes of one data row.  Both processes of a data
row hold the same rows of every global batch (:meth:`Mesh.local_rows`); the
model axis splits the attention heads (``parallel/tp.py``), the image
rows (``parallel/sp_explicit.py``) or the UNet at its bottleneck into two
pipeline stages (``parallel/pp.py``).

The collectives work with both backends: ``gloo`` offers only
``all_reduce`` and ``broadcast`` for CUDA tensors, so :meth:`gather_rows`
is an all-reduce of zero-padded rows (exact: every entry is one value plus
zeros), and so are the model axis's gathers (``ops/collectives.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ldm_tpu_torch.ops.collectives import place
from ldm_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _axis_groups(group, rank_lists, rank: int):
    """This process's group of the ones ``rank_lists`` name (global ranks):
    ``group`` itself where a list is all of it, else a new group.  Every
    process creates every group, in the same order (torch.distributed
    deadlocks otherwise)."""
    everyone = dist.get_process_group_ranks(group)
    mine = None
    for ranks in rank_lists:
        g = group if ranks == everyone else dist.new_group(ranks)
        if rank in ranks:
            mine = g
    return mine


class Mesh:
    """A process group as a ``(data, model)`` mesh, and this process's place
    in it.

    ``group``: the process group of every process of the mesh (the default
    one by default; barriers and the kernels' build run over it);
    ``device``: this process's device; ``model``: the model axis's size
    (:func:`create_mesh` checks that it divides the processes).
    ``size`` and ``rank`` are the data axis's (how many shares a global
    batch splits into, and this process's share), ``model_size`` and
    ``model_rank`` the model axis's, ``shape`` is ``{"data": D, "model": M}``.
    ``data_group`` / ``model_group`` are this process's groups of each axis
    (``model_group`` is None when the axis has one process)."""

    def __init__(self, group, device, model: int = 1):
        self.group = group
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        self.process_index = dist.get_rank(group)
        self.model_size = int(model)
        self.size = dist.get_world_size(group) // self.model_size
        self.rank, self.model_rank = divmod(self.process_index, self.model_size)
        self.data_rank = self.rank
        self.shape = {DATA_AXIS: self.size, MODEL_AXIS: self.model_size}
        ranks = dist.get_process_group_ranks(group)
        me = ranks[self.process_index]
        m, d = self.model_size, self.size
        self.data_group = _axis_groups(group, [ranks[j::m] for j in range(m)], me)
        self.model_group = (None if m == 1 else
                            _axis_groups(group, [ranks[i * m:(i + 1) * m] for i in range(d)], me))
        self._device_mesh = None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.size}, model={self.model_size}, rank={self.process_index} "
                f"at ({self.rank}, {self.model_rank}), backend={self.backend!r}, "
                f"device={self.device})")

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0

    @property
    def captures_collectives(self) -> bool:
        """Whether a CUDA graph may hold this group's collectives: NCCL's
        can be captured; gloo stages CUDA tensors through the host, so a
        step over a gloo group runs eagerly."""
        return self.backend == "nccl"

    def device_mesh(self):
        """The data axis as a 1-D ``DeviceMesh`` (FSDP2's), made once."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh.from_group(self.data_group, self.device.type,
                                                      mesh_dim_names=(DATA_AXIS,))
        return self._device_mesh

    # ------------------------------------------------------------- rows
    def local_rows(self, x):
        """This process's block ``[r*n, (r+1)*n)`` of a global batch along
        the data axis (a tensor or an array, along dim 0; a 0-d value is
        everyone's): the processes of one data row hold the same block."""
        if getattr(x, "ndim", 0) == 0:
            return x
        b = x.shape[0]
        if b % self.size:
            raise ValueError(f"a global batch of {b} rows does not split over "
                             f"the mesh's data axis ({self.size})")
        n = b // self.size
        return x[self.rank * n: (self.rank + 1) * n]

    def model_rows(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This process's block of ``x`` along ``dim`` over the model axis
        (spatial parallelism's image rows: NHWC's H by default)."""
        n = x.shape[dim]
        if n % self.model_size:
            raise ValueError(f"{n} rows do not split over the mesh's model axis "
                             f"({self.model_size})")
        k = n // self.model_size
        return x.narrow(dim, self.model_rank * k, k)

    def global_shape(self, local_shape) -> tuple:
        """The global batch's shape from one process's rows."""
        return (local_shape[0] * self.size,) + tuple(local_shape[1:])

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every data row's block in rank order, whole on every process: the
        inverse of :meth:`local_rows` (a sample grid, an evaluation)."""
        out = place(x, 0, self.rank, self.size)
        dist.all_reduce(out, group=self.data_group)
        return out

    # ------------------------------------------------------- collectives
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the data axis, in place."""
        dist.all_reduce(t, group=self.data_group)
        return t

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the data axis, in place (the sum, then / D)."""
        dist.all_reduce(t, group=self.data_group)
        return t.div_(self.size)

    def split_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the model axis and the mean over the data axis, in
        place: the reduction of values each of which a data row's model
        processes share out among themselves (spatial parallelism's loss
        terms and gradients, each from its own image rows)."""
        dist.all_reduce(t, group=self.group)
        return t.div_(self.size)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def create_mesh(data: int = -1, model: int = 1, group=None, device="cuda") -> Mesh:
    """A ``(data, model)`` mesh over ``group`` (the default group; without
    one, a group of this process alone, so ``--mesh`` on one card is
    world size 1).  ``data=-1`` takes every process the model axis leaves;
    a layout that does not cover the processes raises, as JAX's does.
    ``device`` is this process's (``cuda``: the card of its local rank)."""
    device = distributed.local_device(device)
    # without a group: this process alone (checked before one is made)
    size = dist.get_world_size(group) if group is not None or dist.is_initialized() else 1
    if model < 1 or size % model:
        raise ValueError(f"{size} processes do not divide over model={model}")
    if data not in (-1, size // model):
        raise ValueError(f"mesh {data}x{model} != {size} processes")
    if group is None:
        distributed.initialize_single(device)
        group = dist.group.WORLD
    return Mesh(group, device, model)


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This process's rows of every entry of a global host batch (the batch
    itself without a mesh)."""
    if mesh is None:
        return batch
    return {k: mesh.local_rows(v) for k, v in batch.items()}


def global_batch_multiple(mesh: Optional[Mesh]) -> int:
    """Global batches split evenly over the data axis."""
    return 1 if mesh is None else mesh.size
