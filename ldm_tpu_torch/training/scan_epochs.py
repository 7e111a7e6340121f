"""The device-resident epoch (the twin of ``ldm_tpu/training/scan_epochs.py``'s
``EpochScan``, ``build_epoch_scan`` and ``PaddedEpochScan``).

The JAX package runs a training epoch as one ``lax.scan`` over a uint8
dataset on the device.  Here the dataset is uploaded once as uint8; each
epoch uploads one permutation (n int64) into a fixed (n_batches, B) index
matrix; each step gathers its row of it on the device, its images and
labels, and scales the uint8 values to [-1, 1] by a 256-entry fp32 table.
The gather reads its row through a counter on the device that it advances
itself, the way a sampler graph reads its timestep table, so a trainer's
replayed train step (``utils/graphs.py::CapturedStep``) takes the gather in
and a replay needs no batch upload.  The draws of a step stay eager, as in
the per-batch loop, so the two loops given the same order run the same steps.

* The table is ``scale_to_minus_one_one(np.arange(256))`` of the port's
  transforms, built on the host: the device batch equals the host loader's
  bit for bit by construction (a division on the card could land one ulp
  away from numpy's).
* The shuffle is seeded from (seed, epoch index) salted with
  ``SHUFFLE_SALT`` and drawn by ``torch.randperm`` with a CPU generator, so
  the CPU tests pin the order the card uses.  The epoch index is
  ``step // n_batches``, so a resumed run continues the stream.  (The port
  cannot replay ``jax.random.permutation`` and need not: the JAX scan's order
  differs from its own per-batch loader's too.)
* A captured step holds the addresses of the dataset, the index matrix, the
  table and the counter: they are made once and written in place.

Under data parallelism (a ``parallel.Mesh``) every process holds the whole
uint8 set and draws the same global permutation from (seed, epoch); its
index matrix holds only its columns of each global batch (the block
``mesh.local_rows`` takes), so each step gathers this process's rows.

:class:`PaddedEpochScan` is one set of buffers for datasets of several sizes
up to a capacity: the classifier's five mixes, each trained through the one
captured train step.  The JAX package compiles one scan of ``capacity // B``
steps and masks the updates of the steps past the data; here the captured
step is replayed ``n // B`` times, which leaves the same state.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ldm_tpu_torch.data.transforms import scale_to_minus_one_one
from ldm_tpu_torch.training.state import step_generator

SHUFFLE_SALT = 0xE70C


def scale_table() -> np.ndarray:
    """The 256 values of ``scale_to_minus_one_one`` by uint8 value, fp32."""
    return scale_to_minus_one_one(np.arange(256, dtype=np.uint8))


class EpochScan:
    """An in-memory dataset on ``device`` and the epoch's order over it.

    ``start_epoch(seed, epoch)`` writes the epoch's order into the index
    matrix and sets the row counter to 0; :meth:`next_batch` gathers the
    counter's row (device work alone, capturable) and advances it.
    :meth:`take` is the host's guard: it counts the rows the trainer takes
    and refuses one past the epoch's end."""

    def __init__(self, images: np.ndarray, labels: np.ndarray, batch_size: int,
                 device, shuffle: bool = True, mesh=None):
        """``batch_size``: the global batch's; with a ``mesh`` each step
        gathers this process's rows of it."""
        device = torch.device(device)
        self.n = len(images)
        self.batch_size = int(batch_size)
        self.n_batches = self.n // self.batch_size
        self.shuffle = shuffle
        self.mesh = mesh
        self.local_batch = self.batch_size if mesh is None else self.batch_size // mesh.size
        if self.local_batch * (1 if mesh is None else mesh.size) != self.batch_size:
            raise ValueError(f"a global batch of {self.batch_size} does not split over "
                             f"the mesh's data axis ({mesh.size})")
        self.image_shape = tuple(images.shape[1:])
        self.images = torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(device)
        self.labels = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
        self.table = torch.from_numpy(scale_table()).to(device)
        self.idx = torch.zeros((self.n_batches, self.local_batch), dtype=torch.int64,
                               device=device)
        self.row = torch.zeros((), dtype=torch.int64, device=device)
        self._taken = self.n_batches  # no epoch started
        # this process's batch: its shape, dtype and device for the step's draws
        self.x_like = torch.empty((self.local_batch,) + self.image_shape, device=device)
        self.y_like = torch.empty((self.local_batch,), dtype=torch.int64, device=device)

    def permutation(self, seed: int, epoch: int) -> np.ndarray:
        """The epoch's order as an (n_batches, B) int64 matrix, on the host."""
        if self.shuffle:
            g = step_generator(seed, epoch, "cpu", SHUFFLE_SALT)
            perm = torch.randperm(self.n, generator=g).numpy()
        else:
            perm = np.arange(self.n, dtype=np.int64)
        return perm[: self.n_batches * self.batch_size].reshape(self.n_batches, self.batch_size)

    def start_epoch(self, seed: int, epoch: int, order: Optional[np.ndarray] = None) -> None:
        """Write the epoch's order into the index matrix (``order``, an
        (n_batches, B) matrix of dataset rows, in place of the drawn one
        where given) and set the row counter to 0."""
        if order is None:
            order = self.permutation(seed, epoch)
        order = np.asarray(order, np.int64)
        if order.shape != (self.n_batches, self.batch_size) or (
                order.size and not 0 <= order.min() <= order.max() < self.n):
            raise ValueError(f"an epoch's order is ({self.n_batches}, {self.batch_size}) rows "
                             f"of the {self.n} samples, got {order.shape}")
        if self.mesh is not None:  # this process's block of every global batch
            order = np.ascontiguousarray(self.mesh.local_rows(order.T).T)
        self.idx[: self.n_batches].copy_(torch.from_numpy(order))
        self.row.zero_()
        self._taken = 0

    def take(self) -> None:
        """Count one row taken; past the epoch's end the gather would read
        outside the index matrix on the device, so raise instead."""
        if self._taken >= self.n_batches:
            raise RuntimeError("the epoch's rows are all taken: call start_epoch")
        self._taken += 1

    def next_batch(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The counter's row: (images fp32 in [-1, 1] NHWC, labels int64);
        the counter advances."""
        ib = self.idx.index_select(0, self.row.reshape(1)).reshape(-1)
        u8 = self.images.index_select(0, ib)
        x = self.table.index_select(0, u8.reshape(-1).to(torch.int64)).reshape(u8.shape)
        y = self.labels.index_select(0, ib)
        self.row += 1
        return x, y


def build_epoch_scan(loader, device, enabled: bool = True, mesh=None) -> Optional[EpochScan]:
    """``loader``'s dataset on ``device`` as an :class:`EpochScan`, or None
    where the JAX package's ``build_epoch_scan`` falls back to per-batch
    stepping: not enabled, no in-memory dataset, a transform other than
    ``scale_to_minus_one_one``, no ``drop_last``, or no full batch."""
    ds = getattr(loader, "dataset", None)
    if (
        not enabled
        or ds is None
        or getattr(loader, "transform", None) is not scale_to_minus_one_one
        or not getattr(loader, "drop_last", False)
    ):
        return None
    if len(ds) // loader.batch_size == 0:
        return None
    return EpochScan(ds.images, ds.labels, loader.batch_size, device,
                     shuffle=bool(getattr(loader, "shuffle", True)), mesh=mesh)


class PaddedEpochScan(EpochScan):
    """An :class:`EpochScan` whose buffers hold up to ``capacity`` samples:
    :meth:`set_data` writes a dataset of any size up to it in place (the
    captured step keeps reading the same addresses: nothing is captured
    again), and an epoch runs its ``n // B`` full batches."""

    def __init__(self, batch_size: int, capacity: int, image_shape, device,
                 shuffle: bool = True, mesh=None):
        if capacity < batch_size:
            raise ValueError(f"capacity {capacity} < batch_size {batch_size}")
        super().__init__(np.zeros((capacity,) + tuple(image_shape), np.uint8),
                         np.zeros((capacity,), np.int64), batch_size, device, shuffle, mesh)
        self.capacity = int(capacity)
        self.n = self.n_batches = self._taken = 0  # no data yet

    def set_data(self, images: np.ndarray, labels: np.ndarray) -> None:
        """Copy a dataset into the buffers; ends any epoch in progress."""
        n = len(images)
        if n > self.capacity:
            raise ValueError(f"dataset size {n} exceeds capacity {self.capacity}")
        if tuple(images.shape[1:]) != self.image_shape:
            raise ValueError(f"images of shape {images.shape[1:]}, the buffers hold "
                             f"{self.image_shape}")
        self.images[:n].copy_(torch.from_numpy(np.ascontiguousarray(images, np.uint8)))
        self.labels[:n].copy_(torch.from_numpy(np.asarray(labels, np.int64)))
        self.n, self.n_batches = n, n // self.batch_size
        self._taken = self.n_batches
