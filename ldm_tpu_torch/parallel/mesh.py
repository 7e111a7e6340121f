"""The data-parallel mesh (port of ldm_tpu/parallel/mesh.py).

A JAX ``Mesh`` is an array of devices with named axes, and GSPMD inserts the
collectives a sharded program needs.  Here a :class:`Mesh` is a process
group, one process a device, with the axes ``("data", "model")``: each
process holds its rows of every global batch (:meth:`Mesh.local_rows`) and
the trainers' collectives run over :attr:`Mesh.group`.  Only the data axis
is ported: ``model > 1`` (tensor, sequence and pipeline parallelism) waits
for ROADMAP item 12b.

The collectives work with both backends: ``gloo`` offers only
``all_reduce`` and ``broadcast`` for CUDA tensors, so :meth:`gather_rows`
is an all-reduce of zero-padded rows (exact: every entry is one value plus
zeros).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ldm_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"
ITEM_12B = ("waits for ROADMAP queue 1, item 12b (tensor, sequence and pipeline "
            "parallelism)")


class Mesh:
    """A process group as a ``(data, model=1)`` mesh, and this process's
    place in it.

    ``group``: the process group (the default one by default); ``device``:
    this process's device.  ``shape`` is ``{"data": P, "model": 1}``."""

    def __init__(self, group, device):
        self.group = group
        self.device = torch.device(device)
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.shape = {DATA_AXIS: self.size, MODEL_AXIS: 1}
        self._device_mesh = None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.size}, model=1, rank={self.rank}, "
                f"backend={self.backend!r}, device={self.device})")

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def captures_collectives(self) -> bool:
        """Whether a CUDA graph may hold this group's collectives: NCCL's
        can be captured; gloo stages CUDA tensors through the host, so a
        step over a gloo group runs eagerly."""
        return self.backend == "nccl"

    def device_mesh(self):
        """The group as a 1-D ``DeviceMesh`` (FSDP2's), made once."""
        if self._device_mesh is None:
            from torch.distributed.device_mesh import DeviceMesh

            self._device_mesh = DeviceMesh.from_group(self.group, self.device.type,
                                                      mesh_dim_names=(DATA_AXIS,))
        return self._device_mesh

    # ------------------------------------------------------------- rows
    def local_rows(self, x):
        """This process's block ``[r*n, (r+1)*n)`` of a global batch (a
        tensor or an array, along dim 0; a 0-d value is everyone's)."""
        if getattr(x, "ndim", 0) == 0:
            return x
        b = x.shape[0]
        if b % self.size:
            raise ValueError(f"a global batch of {b} rows does not split over "
                             f"the mesh's data axis ({self.size})")
        n = b // self.size
        return x[self.rank * n: (self.rank + 1) * n]

    def global_shape(self, local_shape) -> tuple:
        """The global batch's shape from one process's rows."""
        return (local_shape[0] * self.size,) + tuple(local_shape[1:])

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every process's rows in rank order, whole on every process: the
        inverse of :meth:`local_rows` (a sample grid, an evaluation)."""
        out = x.new_zeros(self.global_shape(x.shape))
        n = x.shape[0]
        out[self.rank * n: (self.rank + 1) * n] = x
        dist.all_reduce(out, group=self.group)
        return out

    # ------------------------------------------------------- collectives
    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the processes, in place."""
        dist.all_reduce(t, group=self.group)
        return t

    def all_reduce_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the processes, in place (the sum, then / P)."""
        dist.all_reduce(t, group=self.group)
        return t.div_(self.size)

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def create_mesh(data: int = -1, model: int = 1, group=None, device="cuda") -> Mesh:
    """A ``(data, model)`` mesh over ``group`` (the default group; without
    one, a group of this process alone, so ``--mesh`` on one card is
    world size 1).  ``data=-1`` takes every process; ``model > 1`` raises:
    the model axis waits for item 12b.  ``device`` is this process's
    (``cuda``: the card of its local rank)."""
    if model != 1:
        raise ValueError(f"a model axis of {model} {ITEM_12B}")
    device = distributed.local_device(device)
    if group is None:
        distributed.initialize_single(device)
        group = dist.group.WORLD
    size = dist.get_world_size(group)
    if data not in (-1, size):
        raise ValueError(f"mesh {data}x{model} != {size} processes")
    return Mesh(group, device)


def shard_batch(mesh: Optional[Mesh], batch: dict) -> dict:
    """This process's rows of every entry of a global host batch (the batch
    itself without a mesh)."""
    if mesh is None:
        return batch
    return {k: mesh.local_rows(v) for k, v in batch.items()}


def global_batch_multiple(mesh: Optional[Mesh]) -> int:
    """Global batches split evenly over the data axis."""
    return 1 if mesh is None else mesh.size
