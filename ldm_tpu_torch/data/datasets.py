"""Dataset factory of the port (the twin of ``ldm_tpu.data.datasets.get_dataset``).

The readers and the synthetic generators are the JAX package's own, which
need only numpy, imported as they are; only the resize to ``image_size``
differs: it is :func:`ldm_tpu_torch.data.transforms.resize_images`, which
needs no JAX.
"""

from __future__ import annotations

import numpy as np

from ldm_tpu.data.datasets import (
    Dataset,
    load_cifar10,
    load_mnist,
    synthetic_dataset,
    synthetic_dataset_hard,
)
from ldm_tpu_torch.data.transforms import resize_images


def get_dataset(
    name: str,
    data_path: str = "data",
    image_size: int = 32,
    train: bool = True,
    debugging: bool = False,
    allow_synthetic_fallback: bool = True,
    synthetic_size: int = 2048,
    synthetic_variant: str = "easy",
) -> Dataset:
    """Load a dataset by name, resized to ``image_size``; ``debugging``
    truncates to 20 samples.  Same arguments and result as
    ``ldm_tpu.data.datasets.get_dataset``."""
    name_u = name.upper()
    if name_u == "MNIST":
        ds, channels = load_mnist(data_path, train), 1
    elif name_u == "CIFAR10":
        ds, channels = load_cifar10(data_path, train), 3
    elif name_u == "SYNTHETIC":
        ds, channels = None, 1
    elif name_u == "SYNTHETIC_HARD":
        ds, channels, synthetic_variant = None, 1, "hard"
    else:
        raise NotImplementedError(
            f"Dataset {name} is not implemented. Please choose from MNIST or CIFAR10"
        )
    if ds is None:
        if not name_u.startswith("SYNTHETIC") and not allow_synthetic_fallback:
            raise FileNotFoundError(
                f"{name} raw files not found under {data_path!r} "
                "(expected MNIST/raw IDX files or cifar-10-batches-py)"
            )
        gen = synthetic_dataset_hard if synthetic_variant == "hard" else synthetic_dataset
        ds = gen(synthetic_size if train else max(1, synthetic_size // 4),
                 image_size, channels, train=train)
    if ds.images.shape[1] != image_size:
        ds = Dataset(resize_images(ds.images, image_size), ds.labels, ds.classes, ds.name)
    if debugging:
        ds = ds.subset(np.arange(min(20, len(ds))))
    return ds
