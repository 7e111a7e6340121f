"""Loaders of the port (the twin of ``ldm_tpu.data.loader.create_dataloaders``).

``DataLoader`` and ``split_train_val`` are the JAX package's (numpy, with its
native gather), imported as they are; the datasets come from
:func:`ldm_tpu_torch.data.datasets.get_dataset`, whose resize needs no JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ldm_tpu.config import Config
from ldm_tpu.data.loader import DataLoader, split_train_val
from ldm_tpu_torch.data.datasets import get_dataset


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
