"""The device-resident epoch (the twin of ``ldm_tpu/training/scan_epochs.py``'s
``EpochScan`` and ``build_epoch_scan``).

The JAX package runs a training epoch as one ``lax.scan`` over a uint8
dataset on the device.  Here the dataset is uploaded once as uint8; each
epoch uploads one permutation (n int64) into a fixed (n_batches, B) index
matrix; each step gathers its row of it on the device, its images and
labels, and scales the uint8 values to [-1, 1] by a 256-entry fp32 table.
The gather reads its row through a counter on the device that it advances
itself, the way a sampler graph reads its timestep table, so the trainer's
replayed train step (``diffusion_trainer._TrainGraph``) takes the gather in
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

``PaddedEpochScan`` (one program for datasets of several sizes) serves the
classifier's mixes and waits with the classifier (ROADMAP queue 1, item 8).
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
                 device, shuffle: bool = True):
        device = torch.device(device)
        self.n = len(images)
        self.batch_size = int(batch_size)
        self.n_batches = self.n // self.batch_size
        self.shuffle = shuffle
        self.image_shape = tuple(images.shape[1:])
        self.images = torch.from_numpy(np.ascontiguousarray(images, np.uint8)).to(device)
        self.labels = torch.from_numpy(np.asarray(labels, np.int64)).to(device)
        self.table = torch.from_numpy(scale_table()).to(device)
        self.idx = torch.zeros((self.n_batches, self.batch_size), dtype=torch.int64,
                               device=device)
        self.row = torch.zeros((), dtype=torch.int64, device=device)
        self._taken = self.n_batches  # no epoch started
        # the batch's shape, dtype and device for the step's draws
        self.x_like = torch.empty((self.batch_size,) + self.image_shape, device=device)
        self.y_like = torch.empty((self.batch_size,), dtype=torch.int64, device=device)

    def permutation(self, seed: int, epoch: int) -> np.ndarray:
        """The epoch's order as an (n_batches, B) int64 matrix, on the host."""
        if self.shuffle:
            g = step_generator(seed, epoch, "cpu", SHUFFLE_SALT)
            perm = torch.randperm(self.n, generator=g).numpy()
        else:
            perm = np.arange(self.n, dtype=np.int64)
        return perm[: self.n_batches * self.batch_size].reshape(self.n_batches, self.batch_size)

    def start_epoch(self, seed: int, epoch: int) -> None:
        self.idx.copy_(torch.from_numpy(self.permutation(seed, epoch)))
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


def build_epoch_scan(loader, device, enabled: bool = True) -> Optional[EpochScan]:
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
                     shuffle=bool(getattr(loader, "shuffle", True)))
