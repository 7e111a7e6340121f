"""The port's data path (ldm_tpu_torch/data/) held against the JAX package's.

``ldm_tpu.data.transforms.resize_images`` runs ``jax.image.resize``; the
port's twin computes the same bilinear resize in numpy, so a dataset whose
files are not at the config's ``image_size`` (MNIST: 28 px files, 32 px
config) loads on a machine without JAX.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest

from ldm_tpu.data import datasets as jax_datasets
from ldm_tpu.data.transforms import resize_images as jax_resize_images
from ldm_tpu_torch.data import datasets
from ldm_tpu_torch.data.transforms import resize_images

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("src,dst,channels", [(28, 32, 1), (32, 64, 3), (32, 16, 3)])
def test_resize_matches_jax(src, dst, channels):
    """Same uint8 images through both: at most 1 apart after the uint8 cast
    (the two contract their float32 sums in another order)."""
    images = np.random.default_rng(src + dst).integers(
        0, 256, (6, src, src, channels)).astype(np.uint8)
    want = jax_resize_images(images, dst)
    got = resize_images(images, dst)
    assert got.dtype == np.uint8 and got.shape == want.shape == (6, dst, dst, channels)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_resize_same_size_is_identity():
    images = np.zeros((2, 8, 8, 1), np.uint8)
    assert resize_images(images, 8) is images


def write_mnist_idx(root, n=40, seed=0):
    """A seeded 28x28 MNIST train and test set in IDX format under root/MNIST/raw."""
    raw = os.path.join(root, "MNIST", "raw")
    os.makedirs(raw)
    rng = np.random.default_rng(seed)
    for prefix in ("train", "t10k"):
        images = rng.integers(0, 256, (n, 28, 28)).astype(np.uint8)
        labels = rng.integers(0, 10, n).astype(np.uint8)
        with open(os.path.join(raw, f"{prefix}-images-idx3-ubyte"), "wb") as f:
            f.write(struct.pack(">IIII", 2051, n, 28, 28) + images.tobytes())
        with open(os.path.join(raw, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
            f.write(struct.pack(">II", 2049, n) + labels.tobytes())


def test_get_dataset_matches_jax_package(tmp_path):
    """28 px MNIST files loaded at 32 px: the same labels, and images at most
    1 apart from the JAX package's loader."""
    write_mnist_idx(str(tmp_path))
    for train in (True, False):
        want = jax_datasets.get_dataset("MNIST", str(tmp_path), 32, train=train,
                                        allow_synthetic_fallback=False)
        got = datasets.get_dataset("MNIST", str(tmp_path), 32, train=train,
                                   allow_synthetic_fallback=False)
        assert got.images.shape == want.images.shape == (40, 32, 32, 1)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert np.abs(got.images.astype(int) - want.images.astype(int)).max() <= 1


def test_training_loaders_load_resized_mnist_without_jax(tmp_path):
    """The training entry point's loaders, in a process where ``import jax``
    fails, read 28 px MNIST IDX files for the 32 px MNIST config and build a
    batch."""
    write_mnist_idx(str(tmp_path))
    code = f"""
import dataclasses, sys
sys.modules["jax"] = None  # import jax raises ImportError
from ldm_tpu_torch import train
from ldm_tpu_torch.factory import load_config
cfg = load_config("configs/pixel_diffusion_model_mnist.yaml")
cfg = dataclasses.replace(cfg, batch_size=8,
                          data=dataclasses.replace(cfg.data, data_path={str(tmp_path)!r}))
tr, va, te, classes = train.create_dataloaders(cfg, allow_synthetic_fallback=False)
batch = next(iter(tr))
assert batch["image"].shape == (8, 32, 32, 1), batch["image"].shape
assert batch["image"].dtype.name == "float32"
assert -1 <= batch["image"].min() and batch["image"].max() <= 1
assert (len(tr.dataset), len(va.dataset), len(te.dataset)) == (36, 4, 40)
assert classes == list(range(10))
assert not [k for k in sys.modules if k.split(".")[0] in ("jax", "flax") and sys.modules[k]]
print("ok")
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "ok"
