"""Host-side batch iterator and train/val split of the port (the twin of
``ldm_tpu/data/loader.py``).

The datasets are small enough to live in host RAM fully decoded, so each
batch is one numpy gather and an affine normalise.  The port keeps its own
copy and imports nothing of the JAX package.  The JAX loader can also gather
through a host C++ batcher with a worker-thread prefetch ring; that library
has no twin here yet, so ``prefetch > 0`` is accepted and runs synchronously,
exactly as the JAX loader does where its library is missing.  The
permutation stream is the same (``np.random.default_rng(seed)``, one
permutation an epoch), so the batches equal the JAX loader's bit for bit.

``split_train_val`` sizes are ``int((1-val_split)*n)`` and the remainder,
split at a seeded random permutation.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.datasets import Dataset, get_dataset
from ldm_tpu_torch.data.transforms import scale_to_minus_one_one


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
        # accepted for the config's sake; batches are assembled synchronously
        self.prefetch = prefetch
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _gather(self, idx: np.ndarray) -> dict:
        return {
            "image": self.transform(self.dataset.images[idx]),
            "label": self.dataset.labels[idx].astype(np.int32),
        }

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        self._epoch += 1
        bs = self.batch_size
        end = (n // bs) * bs if self.drop_last else n
        for i in range(0, end, bs):
            yield self._gather(order[i : i + bs])


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
