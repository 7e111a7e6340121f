"""Host-side batch iterator and train/val split of the port (the twin of
``ldm_tpu/data/loader.py``).

The datasets are small enough to live in host RAM fully decoded, so each
batch is one gather and an affine normalise.  That pass runs through the
port's host C++ batcher when it builds (``ldm_tpu_torch/native``: one fused
gather and normalise, bitwise equal to the numpy expression), with an
optional worker-thread prefetch ring (``prefetch > 0``) that assembles the
next batch while the caller waits on the device; the pure-numpy path is
behaviour-identical (``LDM_TPU_NO_NATIVE=1`` forces it).  The port keeps its
own copy and imports nothing of the JAX package.  The permutation stream is
the same (``np.random.default_rng(seed)``, one permutation an epoch), so the
batches equal the JAX loader's bit for bit.

``split_train_val`` sizes are ``int((1-val_split)*n)`` and the remainder,
split at a seeded random permutation.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from ldm_tpu_torch import native
from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.datasets import Dataset, get_dataset
from ldm_tpu_torch.data.transforms import scale_to_minus_one_one, scale_to_zero_one

# transforms with a native fused-gather equivalent: transform -> (div, mul, add)
# in the exact float32 op order of transforms.py (bitwise parity)
_NATIVE_AFFINE = {
    scale_to_minus_one_one: (255.0, 2.0, -1.0),
    scale_to_zero_one: (255.0, 1.0, 0.0),
}


def split_train_val(
    dataset: Dataset, val_split: float, seed: int = 42
) -> Tuple[Dataset, Dataset]:
    n = len(dataset)
    n_train = int((1.0 - val_split) * n)
    perm = np.random.default_rng(seed).permutation(n)
    return dataset.subset(perm[:n_train]), dataset.subset(perm[n_train:])


class DataLoader:
    """Deterministic shuffling batch iterator over an in-memory Dataset.

    Yields ``{"image": float32 NHWC in [-1,1], "label": int32}`` batches.  With
    ``drop_last=True`` (default for training) every batch has the same shape.
    """

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        transform=scale_to_minus_one_one,
        prefetch: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.transform = transform
        # prefetch > 0: assemble batches on the native worker thread, that
        # many slots deep (0 = synchronous; silently synchronous when the
        # native lib or an affine transform is unavailable)
        self.prefetch = prefetch
        self._prefetcher = None
        self._pf_key = None
        self.seed = seed
        self.restart()
        # build the library once here, at construction, not inside the
        # first epoch; memoized after the first loader
        if os.environ.get("LDM_TPU_NO_NATIVE") != "1":
            native.available()

    def restart(self) -> None:
        """Back to the first pass: the shuffle stream starts again from the seed."""
        self._rng = np.random.default_rng(self.seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _native_affine(self):
        """(div, mul, add) when the fused native gather applies, else None."""
        aff = _NATIVE_AFFINE.get(self.transform)
        if aff is None:
            return None
        imgs = self.dataset.images
        if imgs.dtype != np.uint8 or not imgs.flags.c_contiguous:
            return None
        return aff if native.available() else None

    def _gather(self, idx: np.ndarray, aff) -> dict:
        if aff is not None:
            image = native.gather_affine(self.dataset.images, idx, *aff)
        else:
            image = self.transform(self.dataset.images[idx])
        return {
            "image": image,
            "label": self.dataset.labels[idx].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        self._epoch += 1
        bs = self.batch_size
        end = (n // bs) * bs if self.drop_last else n
        aff = self._native_affine()
        if self.prefetch > 0 and aff is not None and end >= bs:
            yield from self._iter_prefetched(order, end, aff)
            return
        if self._prefetcher is not None:
            # the native path no longer applies (transform/dataset change or
            # prefetch toggled off): don't strand the worker thread
            self._prefetcher.close()
            self._prefetcher = self._pf_key = None
        for i in range(0, end, bs):
            yield self._gather(order[i : i + bs], aff)

    def _iter_prefetched(self, order, end, aff) -> Iterator[dict]:
        """Full batches stream off the C++ prefetch ring; a non-drop_last
        tail batch (another shape: the ring is fixed-size) gathers
        synchronously after."""
        # rebuild the ring when anything baked into it changed underneath
        # (a swapped dataset, a new transform or batch_size): the C++ side
        # holds raw pointers into the arrays, its slot sizes and affine are
        # fixed at creation
        key = (self.dataset.images, self.dataset.labels, self.batch_size, aff)
        if self._prefetcher is not None and not (
            self._pf_key[0] is key[0] and self._pf_key[1] is key[1]
            and self._pf_key[2:] == key[2:]
        ):
            self._prefetcher.close()
            self._prefetcher = None
        if self._prefetcher is None:
            self._prefetcher = native.Prefetcher(
                self.dataset.images, self.dataset.labels, self.batch_size,
                *aff, capacity=self.prefetch,
            )
            self._pf_key = key
        n_full = (end // self.batch_size) * self.batch_size
        # start_epoch is safe mid-epoch (an abandoned iterator): the C++ side
        # waits out the in-flight gather and drops stale slots (batcher.cpp)
        self._prefetcher.start_epoch(order[:n_full])
        while (b := self._prefetcher.next_batch()) is not None:
            yield b
        if n_full < end:
            yield self._gather(order[n_full:end], aff)


def create_dataloaders(
    config: Config, allow_synthetic_fallback: bool = True
) -> Tuple[DataLoader, Optional[DataLoader], DataLoader, list]:
    """Train/val/test loaders and the class list, as
    ``ldm_tpu.data.loader.create_dataloaders`` builds them."""
    d = config.data

    def dataset(train: bool):
        return get_dataset(
            d.dataset, d.data_path, d.image_size, train=train,
            debugging=config.debugging,
            allow_synthetic_fallback=allow_synthetic_fallback,
            synthetic_size=d.synthetic_size,
            synthetic_variant=getattr(d, "synthetic_variant", "easy"),
        )

    trainset, testset = dataset(True), dataset(False)
    pf = getattr(d, "prefetch_batches", 0)
    test_loader = DataLoader(testset, config.batch_size, shuffle=False, drop_last=False,
                             seed=config.seed, prefetch=pf)
    if d.val_split > 0:
        tr, va = split_train_val(trainset, d.val_split, config.seed)
        return (
            DataLoader(tr, config.batch_size, seed=config.seed, prefetch=pf),
            # keep the tail batch: a tiny val set must never yield zero batches
            DataLoader(va, config.batch_size, seed=config.seed + 1, drop_last=False,
                       prefetch=pf),
            test_loader,
            trainset.classes,
        )
    return (DataLoader(trainset, config.batch_size, seed=config.seed, prefetch=pf),
            None, test_loader, trainset.classes)
