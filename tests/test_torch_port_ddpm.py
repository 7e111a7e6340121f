"""The port's DDPM process and sampler (ldm_tpu_torch/diffusion/) and its
generation entry point (ldm_tpu_torch/generate.py), held against
ldm_tpu/diffusion/ddpm.py with the same weights, inputs and noise."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.diffusion.schedule import DiffusionSchedule as JaxSchedule
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu_torch import generate
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.schedule import DiffusionSchedule
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.utils.flax_import import unet_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 8, 3)  # tiny NHWC images


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("name,t,b0,b1", [("linear", 400, 1e-4, 0.02),
                                          ("sqrt_linear", 1000, 8.5e-4, 1.2e-2)])
def test_schedule_constants_equal(name, t, b0, b1):
    want = JaxSchedule.make(name, t, b0, b1)
    got = DiffusionSchedule.make(name, t, b0, b1)
    for field in ("betas", "alphas", "alpha_bars", "sigma2"):
        g = getattr(got, field)
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), getattr(want, field), err_msg=field)


def test_q_sample_equal():
    rng = np.random.default_rng(0)
    x0, eps = rand(rng, 4, *SHAPE), rand(rng, 4, *SHAPE)
    t = np.array([0, 10, 25, 49], np.int32)
    want = JaxDiffusion(50).q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))
    got = GaussianDiffusion(50).q_sample(
        torch.from_numpy(x0), torch.from_numpy(t).long(), torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_p_sample_equal_with_t0_mask():
    """One reverse step, fresh noise masked out exactly where t == 0."""
    rng = np.random.default_rng(1)
    xt, eps, noise = (rand(rng, 4, *SHAPE) for _ in range(3))
    t = np.array([0, 3, 0, 9], np.int32)
    want = JaxDiffusion(10).p_sample(*map(jnp.asarray, (xt, t, eps, noise)))
    got = GaussianDiffusion(10).p_sample(
        torch.from_numpy(xt), torch.from_numpy(t).long(), torch.from_numpy(eps),
        torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # at t == 0 the step is the posterior mean alone: zero noise changes nothing
    quiet = GaussianDiffusion(10).p_sample(
        torch.from_numpy(xt), torch.from_numpy(t).long(), torch.from_numpy(eps),
        torch.zeros(4, *SHAPE))
    assert torch.equal(quiet[t == 0], got[t == 0])
    assert not torch.equal(quiet[t > 0], got[t > 0])


def test_ancestral_cfg_trajectory_matches_jax():
    """A whole T=10 CFG trajectory (tiny UNet, B=2, scale 3): x_T and every
    step's noise are the JAX sampler's own key stream, handed to the port."""
    flax_model = FlaxUNet(in_channels=3, out_channels=3, channels=8,
                          channel_multipliers=(1, 2), num_classes=10)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(0), jnp.zeros((1,) + SHAPE), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))
    classes = np.array([3, 7], np.int32)
    key = jax.random.key(5)
    jax_diffusion = JaxDiffusion(10)
    want = jax.jit(lambda p, k, y: jax_diffusion.sample(
        flax_model.apply, p, k, y, SHAPE, cfg_scale=3.0, null_label=10))(
        params, key, jnp.asarray(classes))

    # the JAX sampler's draws (ddpm.py sample): split, then fold_in per step
    key_init, key_loop = jax.random.split(key)
    x_init = np.array(jax.random.normal(key_init, (2,) + SHAPE, jnp.float32))

    def noise(t):
        z = jax.random.normal(jax.random.fold_in(key_loop, t), (2,) + SHAPE, jnp.float32)
        return torch.from_numpy(np.array(z))

    model = UNet(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
                 num_classes=10).eval()
    model.load_state_dict(unet_from_flax(params), strict=True)
    got = GaussianDiffusion(10).sample(
        model, torch.from_numpy(classes).long(), SHAPE, cfg_scale=3.0,
        null_label=model.null_label, x_init=torch.from_numpy(x_init), noise=noise)
    assert got.shape == (2,) + SHAPE and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_sample_needs_a_source_of_randomness():
    model = UNet(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
                 num_classes=10)
    with pytest.raises(ValueError, match="generator"):
        GaussianDiffusion(2).sample(model, torch.tensor([1]), SHAPE, null_label=10)


TINY_YAML = """\
project_name: tiny_torch_port
workdir: {workdir}
use_amp: {amp}
diffusion:
  target: ldm_tpu.diffusion.ddpm.GaussianDiffusion
  cfg_scale: 3
  params:
    n_steps: 4
model:
  target: ldm_tpu.models.unet.UNet
  params:
    in_channels: 3
    out_channels: 3
    channels: 8
    channel_multipliers: [1, 2]
    num_classes: 10
data:
  image_channels: 3
  image_size: 8
"""


@pytest.mark.parametrize("amp", [True, False])
def test_generate_main_end_to_end_on_cpu(tmp_path, amp):
    """config -> model -> diffusion -> sample -> uint8 NHWC .npy, seeded and
    repeatable; a CPU run launches no kernel."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(workdir=tmp_path / "runs", amp=amp))
    before = la.linear_attention_block.launches
    out = tmp_path / "x.npy"
    res = generate.main([str(cfg), "--device", "cpu", "--per-class", "2", "--out", str(out)])
    assert res.images.dtype == np.uint8 and res.images.shape == (20, 8, 8, 3)
    assert np.isfinite(res.x0).all()
    np.testing.assert_array_equal(np.load(out), res.images)
    again = generate.main([str(cfg), "--device", "cpu", "--per-class", "2",
                           "--out", str(tmp_path / "y.npy")])
    np.testing.assert_array_equal(again.x0, res.x0)
    assert la.linear_attention_block.launches == before


def test_generate_main_loads_exported_weights(tmp_path):
    """--weights takes the .pt file scripts/export_torch_checkpoint.py writes
    from a flax msgpack, strictly."""
    from flax import serialization

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(workdir=tmp_path / "runs", amp=False))
    flax_model = FlaxUNet(in_channels=3, out_channels=3, channels=8,
                          channel_multipliers=(1, 2), num_classes=10)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(1), jnp.zeros((1,) + SHAPE), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))
    msgpack = tmp_path / "unet.msgpack"
    msgpack.write_bytes(serialization.msgpack_serialize(params))
    spec = importlib.util.spec_from_file_location(
        "export_torch_checkpoint", os.path.join(ROOT, "scripts", "export_torch_checkpoint.py"))
    export = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(export)
    weights = export.main([str(msgpack), str(cfg), "--kind", "unet",
                           "--out", str(tmp_path / "unet.pt")])

    res = generate.main([str(cfg), "--device", "cpu", "--weights", weights,
                         "--out", str(tmp_path / "x.npy")])
    seeded = generate.main([str(cfg), "--device", "cpu", "--out", str(tmp_path / "y.npy")])
    assert res.images.shape == (10, 8, 8, 3)
    assert not np.array_equal(res.x0, seeded.x0)  # the weights were used


def test_profile_sampler_runs_on_cpu(tmp_path):
    """The sampler profiler's host timings and breakdown, on a tiny config; a
    CPU run has no device kernels and writes its trace where it is told."""
    from ldm_tpu_torch import profile_sampler

    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(workdir=tmp_path / "runs", amp=False))
    res = profile_sampler.main([str(cfg), "--device", "cpu", "--batches", "2", "--steps", "2",
                                "--runs", "2", "--trace-dir", str(tmp_path / "traces")])
    assert len(res[2]["ms_per_step"]) == 2 and res[2]["wall_ms"] > 0
    assert res[2]["kernels"] == 0 and res[2]["busy_ms"] == 0
    assert (tmp_path / "traces" / "sampler_B2.json").is_file()
