"""The port stands alone: ``ldm_tpu_torch`` and ``chip_smoke.py`` import
nothing of the JAX package ``ldm_tpu`` (nor jax, jaxlib or flax), and run
where ``ldm_tpu`` cannot be imported at all.  Each module the port keeps a
copy of (config, datasets, loader, transforms, images, the UNet exporter) is
held against its original on the same seeded inputs; only these tests import
``ldm_tpu``, as the oracle.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ldm_tpu.config as jax_config
from ldm_tpu.data import datasets as jax_datasets
from ldm_tpu.data import loader as jax_loader
from ldm_tpu.data import transforms as jax_transforms
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.utils import images as jax_images
from ldm_tpu.utils.torch_export import unet_state_dict_from_params as jax_unet_export
from ldm_tpu_torch import config as port_config
from ldm_tpu_torch.data import datasets, loader, transforms
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.utils import images
from ldm_tpu_torch.utils.flax_import import unet_from_flax, unet_state_dict_from_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"ldm_tpu", "jax", "jaxlib", "flax"}
CONFIGS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, names in os.walk(os.path.join(ROOT, "ldm_tpu_torch")):
        files += [os.path.join(base, n) for n in names if n.endswith(".py")]
    return sorted(files)


def import_roots(path):
    """Root package of every import statement in the file, wherever it
    stands (module level, function level, under ``if``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_are_found():
    names = {os.path.relpath(p, ROOT) for p in port_files()}
    assert len(names) > 30
    for want in ("chip_smoke.py", "ldm_tpu_torch/config.py", "ldm_tpu_torch/utils/images.py",
                 "ldm_tpu_torch/data/loader.py", "ldm_tpu_torch/utils/logging.py",
                 "ldm_tpu_torch/diffusion/flow.py", "ldm_tpu_torch/diffusion/sampling.py",
                 "ldm_tpu_torch/models/resnet.py", "ldm_tpu_torch/ops/metrics.py",
                 "ldm_tpu_torch/ops/fid.py", "ldm_tpu_torch/training/resnet_trainer.py",
                 "ldm_tpu_torch/experiments/augmentation.py", "ldm_tpu_torch/utils/seed.py",
                 "ldm_tpu_torch/utils/cli.py", "ldm_tpu_torch/main.py",
                 "ldm_tpu_torch/diffusion/consistency.py",
                 "ldm_tpu_torch/training/consistency_trainer.py", "ldm_tpu_torch/distill.py",
                 "ldm_tpu_torch/models/autoencoder.py",
                 "ldm_tpu_torch/training/autoencoder_trainer.py",
                 "ldm_tpu_torch/train_autoencoder.py", "ldm_tpu_torch/models/latent.py",
                 "ldm_tpu_torch/training/latent_trainer.py", "ldm_tpu_torch/train_latent.py",
                 "ldm_tpu_torch/parallel/__init__.py", "ldm_tpu_torch/parallel/distributed.py",
                 "ldm_tpu_torch/parallel/mesh.py", "ldm_tpu_torch/parallel/fsdp.py"):
        assert want in names


@pytest.mark.parametrize("rel", [os.path.relpath(p, ROOT) for p in port_files()])
def test_no_import_of_the_jax_package(rel):
    roots = import_roots(os.path.join(ROOT, rel))
    assert not roots & FORBIDDEN, (rel, roots & FORBIDDEN)


def test_port_runs_where_ldm_tpu_cannot_be_imported(tmp_path):
    """A fresh interpreter whose import system raises on ``ldm_tpu`` (and
    jax, jaxlib, flax): every port module imports, the configs load, the
    synthetic loaders yield a batch and ``generate.main`` samples seeded
    weights from a ``.pt`` on the CPU."""
    code = f"""
import importlib, importlib.abc, pkgutil, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {sorted(FORBIDDEN)!r}:
            raise ImportError("refused in this test: " + name)
sys.meta_path.insert(0, Refuse())
import ldm_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(ldm_tpu_torch.__path__, "ldm_tpu_torch.")]
for m in mods + ["chip_smoke"]:
    importlib.import_module(m)
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.data.loader import create_dataloaders
from ldm_tpu_torch import generate
for name in ("pixel_diffusion_model_cifar10.yaml", "pixel_diffusion_model_mnist.yaml"):
    cfg = load_config("configs/" + name)
    assert cfg.model.params["channels"] == 64
cfg = load_config("configs/smoke_synthetic.yaml")
cfg.workdir = {str(tmp_path)!r}
train, val, test, classes = create_dataloaders(cfg)
batch = next(iter(train))
assert batch["image"].shape == (8, 16, 16, 1) and len(classes) == 10
import dataclasses, json, torch
from ldm_tpu_torch.factory import build_model
torch.manual_seed(0)
torch.save(build_model(cfg).state_dict(), {str(tmp_path / "w.pt")!r})
with open({str(tmp_path / "smoke.json")!r}, "w") as f:
    json.dump(dataclasses.asdict(cfg), f)
res = generate.main([{str(tmp_path / "smoke.json")!r}, "--device", "cpu",
                     "--weights", {str(tmp_path / "w.pt")!r},
                     "--out", {str(tmp_path / "s.npy")!r}])
assert res.images.shape == (10, 16, 16, 1) and str(res.images.dtype) == "uint8"
assert not [k for k in sys.modules if k.split(".")[0] in {sorted(FORBIDDEN)!r}]
print("ok", len(mods))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1].startswith("ok")


@pytest.mark.parametrize("name", CONFIGS)
def test_load_config_equals_the_original(name, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # run directories are made relative to the cwd
    path = os.path.join(ROOT, "configs", name)
    got, want = port_config.load_config(path), jax_config.load_config(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dirpath == want.dirpath


def test_config_fields_equal_the_original():
    for cls in ("Config", "DataConfig", "ModelConfig", "DiffusionConfig"):
        a, b = getattr(port_config, cls), getattr(jax_config, cls)
        assert [(f.name, f.type) for f in dataclasses.fields(a)] == \
               [(f.name, f.type) for f in dataclasses.fields(b)]


@pytest.mark.parametrize("fn,kw", [
    ("synthetic_dataset", dict(n=48, image_size=16, channels=1)),
    ("synthetic_dataset", dict(n=20, image_size=32, channels=3, train=False)),
    ("synthetic_dataset_hard", dict(n=48, image_size=16, channels=1)),
    ("synthetic_dataset_hard", dict(n=20, image_size=32, channels=1, train=False)),
])
def test_synthetic_datasets_equal_the_original(fn, kw):
    got, want = getattr(datasets, fn)(**kw), getattr(jax_datasets, fn)(**kw)
    assert got.images.dtype == np.uint8
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.classes == want.classes and got.name == want.name


@pytest.mark.parametrize("name", ["SYNTHETIC", "SYNTHETIC_HARD", "CIFAR10", "MNIST"])
@pytest.mark.parametrize("train", [True, False])
def test_get_dataset_equals_the_original(name, train, tmp_path):
    """No files under data_path: both fall back to the synthetic set at the
    dataset's shape."""
    kw = dict(data_path=str(tmp_path), image_size=16, train=train, synthetic_size=40)
    got, want = datasets.get_dataset(name, **kw), jax_datasets.get_dataset(name, **kw)
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.classes == want.classes


def batches(dl, epochs=2):
    return [b for _ in range(epochs) for b in dl]


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("kw", [
    dict(batch_size=8, seed=3),
    dict(batch_size=7, seed=4, drop_last=False),
    dict(batch_size=8, shuffle=False, drop_last=False, prefetch=2),
    dict(batch_size=8, seed=5, prefetch=2),
])
def test_dataloader_yields_the_original_batches(native, kw, monkeypatch):
    """Two epochs, bit for bit, against the JAX loader through its numpy
    gather (LDM_TPU_NO_NATIVE=1) and through its host library where that
    builds."""
    if native:
        monkeypatch.delenv("LDM_TPU_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("LDM_TPU_NO_NATIVE", "1")
    ds = datasets.synthetic_dataset(45, 16, 3)
    jds = jax_datasets.Dataset(ds.images, ds.labels, ds.classes, ds.name)
    got = batches(loader.DataLoader(ds, **kw))
    want = batches(jax_loader.DataLoader(jds, **kw))
    assert len(got) == len(want) == 2 * len(loader.DataLoader(ds, **kw))
    for g, w in zip(got, want):
        assert g["image"].dtype == np.float32 and g["label"].dtype == np.int32
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])


def test_split_train_val_equals_the_original():
    ds = datasets.synthetic_dataset(50, 16, 1)
    jds = jax_datasets.Dataset(ds.images, ds.labels, ds.classes, ds.name)
    for a, b in zip(loader.split_train_val(ds, 0.2, 7), jax_loader.split_train_val(jds, 0.2, 7)):
        np.testing.assert_array_equal(a.images, b.images)
        np.testing.assert_array_equal(a.labels, b.labels)


def test_create_dataloaders_equals_the_original(tmp_path, monkeypatch):
    monkeypatch.setenv("LDM_TPU_NO_NATIVE", "1")
    monkeypatch.chdir(tmp_path)
    path = os.path.join(ROOT, "configs", "smoke_synthetic.yaml")
    got = loader.create_dataloaders(port_config.load_config(path))
    want = jax_loader.create_dataloaders(jax_config.load_config(path))
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        for a, b in zip(batches(g, 1), batches(w, 1)):
            np.testing.assert_array_equal(a["image"], b["image"])
            np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("fn", ["reverse_transform", "scale_to_minus_one_one",
                                "scale_to_zero_one", "to_grayscale"])
def test_transforms_equal_the_original(fn):
    rng = np.random.default_rng(len(fn))
    if fn == "reverse_transform":
        arg = rng.standard_normal((4, 8, 8, 3)).astype(np.float32) * 1.5
    else:
        arg = rng.integers(0, 256, (4, 8, 8, 3)).astype(np.uint8)
    got, want = getattr(transforms, fn)(arg), getattr(jax_transforms, fn)(arg)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,cols,c", [(10, 0, 3), (7, 3, 1), (4, 4, 3)])
def test_image_grid_equals_the_original(n, cols, c):
    imgs = np.random.default_rng(n).integers(0, 256, (n, 8, 8, c)).astype(np.uint8)
    np.testing.assert_array_equal(images.image_grid(imgs, cols), jax_images.image_grid(imgs, cols))


@pytest.mark.parametrize("multipliers,bottleneck_time_emb",
                         [((1, 2), True), ((1, 2), False), ((1, 2, 4, 8), True)])
def test_unet_export_equals_the_original(multipliers, bottleneck_time_emb):
    """The bridge's own exporter against the JAX package's on a 2-level and a
    4-level flax UNet: the same keys and values, from numpy leaves, and the
    port's UNet loads the result strictly."""
    kw = dict(in_channels=3, out_channels=3, channels=8, num_classes=10,
              bottleneck_time_emb=bottleneck_time_emb)
    flax_model = FlaxUNet(channel_multipliers=multipliers, **kw)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(1), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))
    params = jax.tree_util.tree_map(np.asarray, params)
    want = jax_unet_export(params)
    got = unet_state_dict_from_params(params)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    tensors = unet_from_flax(params)
    assert list(tensors) == list(want)
    for k in want:
        np.testing.assert_array_equal(tensors[k].numpy(), np.asarray(want[k], np.float32))
    model = UNet(channel_multipliers=multipliers, **kw)
    model.load_state_dict(tensors, strict=True)
    assert all(torch.equal(v, tensors[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("multipliers,n_blocks", [((1, 2), 1), ((1, 2, 4), 2)])
def test_autoencoder_export_equals_the_original(multipliers, n_blocks):
    """The bridge's VAE exporter against the JAX package's: the same keys and
    values from numpy leaves, and the port's Autoencoder loads the result
    strictly."""
    from ldm_tpu.models.autoencoder import Autoencoder as FlaxAE
    from ldm_tpu.utils.torch_export import autoencoder_state_dict_from_params as jax_ae_export
    from ldm_tpu_torch.models.autoencoder import Autoencoder
    from ldm_tpu_torch.utils.flax_import import (
        autoencoder_from_flax,
        autoencoder_state_dict_from_params,
    )

    from _flax_params import random_params

    kw = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=multipliers,
              n_resnet_blocks=n_blocks, z_channels=4)
    params = random_params(FlaxAE(**kw), jnp.zeros((1, 16, 16, 3)), jax.random.key(2))
    want = jax_ae_export(params, n_blocks)
    got = autoencoder_state_dict_from_params(params, n_blocks)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    model = Autoencoder(**kw)
    model.load_state_dict(autoencoder_from_flax(params, n_blocks), strict=True)
    with pytest.raises(ValueError, match="n_resnet_blocks"):
        autoencoder_state_dict_from_params(params, n_blocks + 1)
