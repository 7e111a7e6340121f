"""The reference's own workflow on the port, held against the JAX package:
``load_image_folder`` (ldm_tpu_torch/utils/images.py) bit for bit, the
forward-process pictures (utils/viz.py) fed JAX's noise, ``timeit``,
``trace`` and ``train --profile``, ``generate`` from the trained checkpoint
into the PNG tree the JAX entry point writes, and ``python -m
ldm_tpu_torch.train_classifier`` with and without ``--pretrain-dir`` on that
tree; a tiny synthetic config (channels 8, 8px, T=8), on the CPU."""

import glob
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ldm_tpu.data.datasets import Dataset as JaxDataset
from ldm_tpu.data.loader import DataLoader as JaxLoader
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.utils import viz as jax_viz
from ldm_tpu.utils.images import load_image_folder as jax_load_image_folder
from ldm_tpu.utils.timing import timeit as jax_timeit
from ldm_tpu_torch import generate, train, train_classifier
from ldm_tpu_torch.data.loader import DataLoader
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.utils import profiling, timeit, viz
from ldm_tpu_torch.utils.images import load_image_folder, save_images

T_STEPS, SIZE, B, PER_CLASS = 8, 8, 8, 4
TINY_YAML = """\
project_name: workflow
workdir: {workdir}
epochs: 1
batch_size: 8
use_amp: false
seed: 0
sample_every: 0
diffusion:
  cfg_scale: 3.0
  params:
    n_steps: 8
model:
  params:
    in_channels: 3
    out_channels: 3
    channels: 8
    channel_multipliers: [1, 2]
    num_classes: 10
data:
  dataset: {dataset}
  data_path: {workdir}/none
  image_size: 8
  image_channels: {channels}
  synthetic_size: 200
"""
VIZ_ATOL = 1e-6  # q_sample in fp32 on both sides: a few ulps of values near 1


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: test workers share the cores, and the trainers'
    many small CPU ops slow each other down with a full OpenMP team each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_config(dirpath, channels=3) -> str:
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, f"tiny_c{channels}.yaml")
    with open(path, "w") as f:
        f.write(TINY_YAML.format(workdir=dirpath, channels=channels,
                                 dataset="CIFAR10" if channels == 3 else "MNIST"))
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A tiny DDPM trained one epoch through ``train.main --profile``: the
    config's path, the run and the trace directory."""
    d = str(tmp_path_factory.mktemp("wf"))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        path = write_config(d)
        run = train.main([path, "--device", "cpu", "--profile", os.path.join(d, "trace")])
    finally:
        torch.set_num_threads(n)
    return path, run, os.path.join(d, "trace")


# ------------------------------------------------------------ image folder
def write_tree(root, seed=0, n=18, size=32):
    """A PNG tree through the port's ``save_images``: classes named so that
    string order is not number order, flat and noisy images, and a file
    that is no image."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8)
    imgs[:3] = rng.integers(0, 256, (3, 1, 1, 3)).astype(np.uint8)
    classes = ["0", "1", "10", "2", "11", "3"]
    paths = [os.path.join(root, classes[i % len(classes)], f"sample_{i // len(classes)}.png")
             for i in range(n)]
    save_images(list(imgs), paths)
    with open(os.path.join(root, "2", "notes.txt"), "w") as f:
        f.write("not an image")
    return imgs, paths


@pytest.mark.parametrize("grayscale", [False, True])
def test_load_image_folder_is_bit_for_bit_the_jax_one(tmp_path, grayscale):
    """Sorted class directories, sorted image files (the .txt ignored), RGB,
    grayscale when asked, resized 32 -> 16: images, labels, classes and
    name equal the JAX reader's."""
    write_tree(str(tmp_path))
    got = load_image_folder(str(tmp_path), 16, grayscale=grayscale)
    want = jax_load_image_folder(str(tmp_path), 16, grayscale=grayscale)
    assert got.images.shape == (18, 16, 16, 1 if grayscale else 3)
    assert got.images.dtype == np.uint8 and got.labels.dtype == np.int32
    np.testing.assert_array_equal(got.images, want.images)
    np.testing.assert_array_equal(got.labels, want.labels)
    assert got.classes == want.classes == list(range(6)) and got.name == want.name
    # class 2 is "10" in string order: the third directory
    assert (got.labels == 2).sum() == 3


def test_load_image_folder_reads_back_what_was_written(tmp_path):
    """At the written size the images come back as they were, in the
    directories' sorted order."""
    imgs, paths = write_tree(str(tmp_path), seed=1)
    got = load_image_folder(str(tmp_path), 32)
    order = sorted(range(len(paths)), key=lambda i: (os.path.dirname(paths[i]), paths[i]))
    np.testing.assert_array_equal(got.images, imgs[order])


# -------------------------------------------------------------------- viz
def jax_noise(shape):
    return np.asarray(jax.random.normal(jax.random.key(0), shape, jnp.float32))


def assert_uint8_close(got, want, x_float):
    """Equal, except at most one level where the float lies within
    ``VIZ_ATOL`` of a level boundary (the uint8 cast truncates)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    v = (np.clip((x_float + 1.0) / 2.0, 0.0, 1.0) * 255.0)[diff > 0]
    assert np.all(np.abs(v - np.round(v)) <= VIZ_ATOL * 255.0), v


def test_forward_diffusion_at_matches_jax():
    image = np.random.default_rng(3).uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32)
    jd, pd = JaxDiffusion(400), GaussianDiffusion(400)
    for t in (0, 37, 399):
        noise = jax_noise((1, SIZE, SIZE, 3))
        x_port = viz.noised(pd, image[None], [t], noise)
        x_jax = np.asarray(jd.q_sample(jnp.asarray(image[None]), jnp.array([t], jnp.int32),
                                       jnp.asarray(noise)))
        np.testing.assert_allclose(x_port, x_jax, rtol=0, atol=VIZ_ATOL)
        got = viz.forward_diffusion_at(pd, image, t, noise=noise)
        want = jax_viz.forward_diffusion_at(jd, image, t, jax.random.key(0))
        assert got.dtype == np.uint8 and got.shape == (SIZE, SIZE, 3)
        assert_uint8_close(got, want, x_jax[0])
    # without noise: a generator seeded 0, the same draw twice
    np.testing.assert_array_equal(viz.forward_diffusion_at(pd, image, 100),
                                  viz.forward_diffusion_at(pd, image, 100))


def test_forward_process_grid_matches_jax(tmp_path):
    """Every 10th step of T=400 in one batched q_sample, tiled, written."""
    image = np.random.default_rng(4).uniform(-1, 1, (SIZE, SIZE, 3)).astype(np.float32)
    jd, pd = JaxDiffusion(400), GaussianDiffusion(400)
    ts = list(range(0, 400, 10))
    noise = jax_noise((len(ts), SIZE, SIZE, 3))
    out = str(tmp_path / "grid.png")
    got = viz.forward_process_grid(pd, image, out_path=out, noise=noise)
    want = jax_viz.forward_process_grid(jd, image)
    x_jax = np.asarray(jd.q_sample(jnp.broadcast_to(jnp.asarray(image)[None], noise.shape),
                                   jnp.asarray(ts, jnp.int32), jnp.asarray(noise)))
    np.testing.assert_allclose(viz.noised(pd, np.broadcast_to(image, noise.shape), ts, noise),
                               x_jax, rtol=0, atol=VIZ_ATOL)
    assert got.shape == want.shape == (6 * SIZE, 7 * SIZE, 3)  # 40 tiles, 7 a row

    def tiles(grid):
        return np.stack([grid[r * SIZE:(r + 1) * SIZE, c * SIZE:(c + 1) * SIZE]
                         for r, c in (divmod(i, 7) for i in range(len(ts)))])

    assert_uint8_close(tiles(got), tiles(want), x_jax)
    np.testing.assert_array_equal(np.asarray(Image.open(out)), got)


# ------------------------------------------------------- timing, tracing
def test_timeit_prints_the_jax_line(capsys):
    def work(x):
        return x + 1

    assert timeit(work)(1) == 2 and jax_timeit(work)(1) == 2
    got, want = capsys.readouterr().out.splitlines()
    pattern = r"work took \d+\.\d\ds"
    assert re.fullmatch(pattern, got) and re.fullmatch(pattern, want)
    assert timeit(work).__name__ == "work"


def test_trace_writes_a_chrome_trace_and_none_is_a_no_op(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(4, 4).matmul(torch.ones(4, 4))
    (path,) = glob.glob(str(tmp_path / "t" / "trace_*.json"))
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::matmul" in names
    with profiling.trace(None):
        torch.ones(2)
    with profiling.trace(""):
        torch.ones(2)
    assert os.listdir(tmp_path) == ["t"]


def test_train_profile_writes_the_training_trace(trained):
    _, run, trace_dir = trained
    (path,) = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    with open(path) as f:  # tens of MB of CPU events: searched, not parsed
        text = f.read()
    assert text.lstrip().startswith("{") and '"traceEvents"' in text
    assert '"aten::convolution_backward"' in text
    assert run.trainer.state.step == 180 // B


# --------------------------------------------------------------- generate
def weights_of(path, ema=True) -> str:
    name = "diffusion_model_ema.pt" if ema else "diffusion_model.pt"
    return os.path.join(load_config(path).checkpoints, name)


def gen(path, out, *extra):
    return generate.main([path, "--device", "cpu", "--per-class", "2", "--sampler", "ddim",
                          "--ddim-steps", "3", "--out", str(out), *extra])


def test_generate_samples_the_trained_checkpoint(trained, tmp_path):
    """No --weights: the run's diffusion_model_ema.pt; --no-ema its
    diffusion_model.pt; --cfg-scale over the config's."""
    path, _, _ = trained
    default = gen(path, tmp_path / "a.npy")
    np.testing.assert_array_equal(
        default.x0, gen(path, tmp_path / "b.npy", "--weights", weights_of(path)).x0)
    raw = gen(path, tmp_path / "c.npy", "--no-ema")
    np.testing.assert_array_equal(
        raw.x0, gen(path, tmp_path / "d.npy", "--weights", weights_of(path, ema=False)).x0)
    assert not np.array_equal(raw.x0, default.x0)
    np.testing.assert_array_equal(gen(path, tmp_path / "e.npy", "--cfg-scale", "3.0").x0,
                                  default.x0)
    assert not np.array_equal(gen(path, tmp_path / "f.npy", "--cfg-scale", "0").x0, default.x0)
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), default.images)


def test_generate_writes_the_jax_entry_points_png_tree(trained, tmp_path):
    """``<results>/<class>/sample_<i % per_class>.png``, as
    scripts/generate_images.py names them; the files hold the images, and
    ``load_image_folder`` reads the tree back bit for bit."""
    path = write_config(str(tmp_path))  # a run directory of its own
    config = load_config(path)
    res = gen(path, tmp_path / "x.npy", "--weights", weights_of(trained[0]))
    classes = np.repeat(np.arange(10, dtype=np.int32), 2)
    want = [os.path.join(config.results, str(c), f"sample_{i % 2}.png")
            for i, c in enumerate(classes)]
    assert list(res.paths) == want
    for p, img in zip(want, res.images):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    back = load_image_folder(config.results, SIZE)
    np.testing.assert_array_equal(back.images, res.images)
    np.testing.assert_array_equal(back.labels, classes)


def test_generate_without_a_checkpoint_raises(tmp_path):
    """A run directory without weights is an error naming the file, never a
    random init."""
    path = write_config(str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(weights_of(path))):
        gen(path, tmp_path / "x.npy")
    with pytest.raises(FileNotFoundError, match="diffusion_model.pt"):
        gen(path, tmp_path / "x.npy", "--no-ema")
    with pytest.raises(FileNotFoundError, match="consistency_model_ema.pt"):
        generate.main([path, "--device", "cpu", "--sampler", "consistency"])
    assert not os.path.exists(load_config(path).results + "/0")


# -------------------------------------------------------- train_classifier
def test_train_classifier_end_to_end(tmp_path, capsys):
    """Without --pretrain-dir: train, test and the F1 line; ``mse`` taken as
    cross-entropy."""
    path = write_config(str(tmp_path))
    res = train_classifier.main([path, "--device", "cpu"])
    assert res.pretrain is None and res.trainer.state.step == 180 // B
    assert len(res.history["train"]) == 1 and np.isfinite(res.test["loss"])
    assert res.trainer.config.loss_fn == "cross-entropy"
    assert os.path.exists(os.path.join(load_config(path).checkpoints, "resnet.pt"))
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"test F1 \(micro\): \d\.\d{4}  \(macro\): \d\.\d{4}  loss: \d+\.\d{4}",
                        line), line


@pytest.mark.parametrize("channels", [3, 1])
def test_train_classifier_pretrains_on_the_generated_tree(trained, tmp_path, channels):
    """``--pretrain-dir`` the tree ``generate`` wrote: one pass of
    ``len(tree) // batch_size`` steps before the epochs, its batches bit for
    bit the JAX loader's over the JAX reader's dataset (grayscale for a
    one-channel config)."""
    path = write_config(str(tmp_path / "gen"))
    res = generate.main([path, "--device", "cpu", "--per-class", str(PER_CLASS), "--sampler",
                         "ddim", "--ddim-steps", "2", "--out", str(tmp_path / "x.npy"),
                         "--weights", weights_of(trained[0])])
    tree = load_config(path).results
    assert len(res.paths) == 10 * PER_CLASS
    clf = write_config(str(tmp_path), channels=channels)
    gray = channels == 1
    ours = DataLoader(load_image_folder(tree, SIZE, grayscale=gray), B, seed=0)
    j = jax_load_image_folder(tree, SIZE, grayscale=gray)
    theirs = JaxLoader(JaxDataset(j.images, j.labels, j.classes, j.name), B, seed=0)
    batches = list(ours)
    assert len(batches) == 10 * PER_CLASS // B
    for a, b in zip(batches, theirs):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])
        assert a["image"].shape == (B, SIZE, SIZE, channels)
    run = train_classifier.main([clf, "--device", "cpu", "--pretrain-dir", tree])
    pre_steps = 10 * PER_CLASS // B
    assert run.pretrain is not None and np.isfinite(run.pretrain["loss"])
    assert run.trainer.state.step == pre_steps + 180 // B
    assert run.trainer.step_counts == {"graphed": 0, "eager": pre_steps + 180 // B}
    assert np.isfinite(run.test["f1_micro"])
