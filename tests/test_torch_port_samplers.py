"""The port's DDIM and DPM-Solver++(2M) samplers, and the step that all three
samplers share (ldm_tpu_torch/diffusion/ddpm.py), held against
ldm_tpu/diffusion/ddpm.py with the same weights, inputs and noise; the
samplers through ``DiffusionTrainer.sample(method=...)`` and
``generate.main --sampler`` on the CPU."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu_torch import generate
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.serving.builder import checkpoint_path
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer, run_sampler
from ldm_tpu_torch.utils.flax_import import unet_from_flax
from ldm_tpu_torch.utils.graphs import StepGraph, use_graphs

SHAPE = (8, 8, 3)  # tiny NHWC images
MODEL = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
             num_classes=10)
TRAJ_ATOL = 1e-4  # the ancestral T=10 trajectory check's (test_torch_port_ddpm.py)


def rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("eta", [0.0, 0.5, 1.0])
def test_ddim_step_equal(eta):
    """One DDIM update on numpy inputs made from a seed, 1e-6; the batch mixes
    ordinary steps with ``t_prev = -1`` ("to x_0", alpha_bar_prev = 1)."""
    rng = np.random.default_rng(int(eta * 10))
    xt, eps, noise = (rand(rng, 4, *SHAPE) for _ in range(3))
    t = np.array([49, 30, 7, 0], np.int32)
    t_prev = np.array([40, 12, -1, -1], np.int32)
    want = JaxDiffusion(50).ddim_step(*map(jnp.asarray, (xt, t, t_prev, eps, noise)), eta=eta)
    tt = lambda a: torch.from_numpy(a).long()
    got = GaussianDiffusion(50).ddim_step(torch.from_numpy(xt), tt(t), tt(t_prev),
                                          torch.from_numpy(eps), torch.from_numpy(noise), eta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if eta == 0.0:  # deterministic: the update needs no noise
        quiet = GaussianDiffusion(50).ddim_step(torch.from_numpy(xt), tt(t), tt(t_prev),
                                                torch.from_numpy(eps), None, 0.0)
        assert torch.equal(quiet, got)


@pytest.mark.parametrize("n_steps,n_sample", [(10, 4), (400, 15), (1000, 10), (10, 50)])
def test_dpmpp_coeffs_equal(n_steps, n_sample):
    """The host-side 2M coefficients: the subsequence equal, the float64
    coefficients to 1e-12, e^{-h} exactly 0 at the end (c_x = 0 there) and c2
    zero on the first and last step."""
    want = JaxDiffusion(n_steps)._dpmpp_coeffs(n_sample)
    got = GaussianDiffusion(n_steps)._dpmpp_coeffs(n_sample)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int32 and got[0][0] == n_steps - 1 and got[0][-1] == 0
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)
    assert got[1][-1] == 0.0 and got[3][0] == 0.0 and got[3][-1] == 0.0


@pytest.mark.parametrize("n_steps,n_sample", [(10, 4), (400, 50), (10, 50)])
def test_ddim_timesteps_are_the_jax_subsequence(n_steps, n_sample):
    """Evenly spaced, endpoints included, descending; t_prev = -1 last."""
    n_sub = min(n_sample, n_steps)
    want = np.unique(np.linspace(0, n_steps - 1, n_sub).round().astype(np.int32))[::-1]
    ts, t_prevs = GaussianDiffusion(n_steps).ddim_timesteps(n_sample)
    np.testing.assert_array_equal(ts, want)
    np.testing.assert_array_equal(t_prevs, np.append(want[1:], -1))
    assert ts[0] == n_steps - 1 and ts[-1] == 0


@pytest.fixture(scope="module")
def pair():
    """A tiny flax UNet with initialised params and the port's UNet loaded
    from them through the bridge."""
    flax_model = FlaxUNet(**MODEL)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(0), jnp.zeros((1,) + SHAPE), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))
    model = UNet(**MODEL).eval()
    model.load_state_dict(unet_from_flax(params), strict=True)
    return flax_model, params, model


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_trajectory_matches_jax(pair, eta):
    """A whole DDIM trajectory (T=10, 4 steps, B=2, CFG 3): x_T and the
    per-step noise are the JAX sampler's own key stream
    (``normal(fold_in(key_loop, t))``), handed to the port."""
    flax_model, params, model = pair
    classes = np.array([3, 7], np.int32)
    key = jax.random.key(5)
    jd = JaxDiffusion(10)
    want = jax.jit(lambda p, k, y: jd.sample_ddim(
        flax_model.apply, p, k, y, SHAPE, n_sample_steps=4, eta=eta, cfg_scale=3.0,
        null_label=10))(params, key, jnp.asarray(classes))
    key_init, key_loop = jax.random.split(key)
    x_init = np.array(jax.random.normal(key_init, (2,) + SHAPE, jnp.float32))
    asked = []

    def noise(t):
        asked.append(t)
        z = jax.random.normal(jax.random.fold_in(key_loop, t), (2,) + SHAPE, jnp.float32)
        return torch.from_numpy(np.array(z))

    got = GaussianDiffusion(10).sample_ddim(
        model, torch.from_numpy(classes).long(), SHAPE, n_sample_steps=4, eta=eta,
        cfg_scale=3.0, null_label=model.null_label, x_init=torch.from_numpy(x_init),
        noise=noise)
    assert got.shape == (2,) + SHAPE and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_ATOL)
    # eta = 0 draws nothing after x_T; eta > 0 one draw a step of the subsequence
    assert asked == ([] if eta == 0.0 else [9, 6, 3, 0])


@pytest.mark.parametrize("n_sample,order", [(4, 2), (4, 1), (10, 2)])
def test_dpmpp_trajectory_matches_jax(pair, n_sample, order):
    """A whole DPM-Solver++(2M) trajectory (T=10, B=2, CFG 3) from the JAX
    sampler's x_T; the carry's previous x0 starts from zeros on both sides."""
    flax_model, params, model = pair
    classes = np.array([3, 7], np.int32)
    key = jax.random.key(6)
    jd = JaxDiffusion(10)
    want = jax.jit(lambda p, k, y: jd.sample_dpmpp(
        flax_model.apply, p, k, y, SHAPE, n_sample_steps=n_sample, cfg_scale=3.0,
        null_label=10, order=order))(params, key, jnp.asarray(classes))
    x_init = np.array(jax.random.normal(key, (2,) + SHAPE, jnp.float32))
    got = GaussianDiffusion(10).sample_dpmpp(
        model, torch.from_numpy(classes).long(), SHAPE, n_sample_steps=n_sample,
        cfg_scale=3.0, null_label=model.null_label, x_init=torch.from_numpy(x_init),
        order=order)
    assert got.shape == (2,) + SHAPE and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TRAJ_ATOL)


@pytest.mark.parametrize("cfg_scale", [3.0, 0.0])
def test_step_split_is_bit_identical_to_the_int_loop(pair, cfg_scale):
    """``sample`` now steps through a timestep table on the device; its
    output equals, bit for bit, the loop over Python ints it replaced
    (``torch.full((b,), t)`` a step, the same draws from the generator)."""
    model = pair[2]
    d = GaussianDiffusion(10)
    classes = torch.tensor([3, 7])
    got = d.sample(model, classes, SHAPE, cfg_scale=cfg_scale, null_label=10,
                   generator=torch.Generator().manual_seed(1))

    gen = torch.Generator().manual_seed(1)
    shape = (2,) + SHAPE
    use_cfg = cfg_scale > 0
    with torch.inference_mode():
        xt = torch.randn(shape, generator=gen)
        y_in = torch.cat([classes, torch.full_like(classes, 10)]) if use_cfg else classes
        for t in range(9, -1, -1):
            t_vec = torch.full((2,), t, dtype=torch.int64)
            eps = d._cfg_eps(model, xt, t_vec, y_in, cfg_scale, use_cfg)
            xt = d.p_sample(xt, t_vec, eps, torch.randn(shape, generator=gen))
    assert torch.equal(got, xt)


def test_samplers_need_a_source_of_randomness(pair):
    """x_T, and the per-step noise where the method draws any, come from the
    caller or from the caller's generator; DDIM at eta = 0 and DPM-Solver++
    need x_T alone."""
    model = pair[2]
    d = GaussianDiffusion(4)
    y = torch.tensor([1])
    x_init = torch.zeros((1,) + SHAPE)
    with pytest.raises(ValueError, match="generator"):
        d.sample_ddim(model, y, SHAPE, null_label=10)
    with pytest.raises(ValueError, match="generator"):
        d.sample_ddim(model, y, SHAPE, eta=0.5, null_label=10, x_init=x_init)
    with pytest.raises(ValueError, match="generator"):
        d.sample_dpmpp(model, y, SHAPE, null_label=10)
    with pytest.raises(ValueError, match="null_label"):
        d.sample_dpmpp(model, y, SHAPE, x_init=x_init)
    assert d.sample_ddim(model, y, SHAPE, null_label=10, x_init=x_init).shape == (1,) + SHAPE
    assert d.sample_dpmpp(model, y, SHAPE, null_label=10, x_init=x_init).shape == (1,) + SHAPE


def test_repeated_calls_build_their_tables_once(pair):
    """A sampler's tables reach the device once per (sampler, arguments): a
    repeated call makes no host-to-device copy (on a card such a copy waits
    for the stream, and a service samples at every batch), and gives the
    same images."""
    model = pair[2]
    d = GaussianDiffusion(4)
    made = []
    table = d._table
    d._table = lambda values, dtype: made.append(len(values)) or table(values, dtype)
    y, x_init = torch.tensor([1, 2]), torch.randn((2,) + SHAPE, generator=torch.Generator())
    calls = [lambda: d.sample(model, y, SHAPE, null_label=10, x_init=x_init,
                              generator=torch.Generator().manual_seed(0)),
             lambda: d.sample_ddim(model, y, SHAPE, n_sample_steps=2, null_label=10,
                                   x_init=x_init),
             lambda: d.sample_dpmpp(model, y, SHAPE, n_sample_steps=2, null_label=10,
                                    x_init=x_init)]
    for call, tables in zip(calls, (1, 2, 4)):
        before = len(made)
        first, n = call(), len(made)
        assert n - before == tables
        assert torch.equal(call(), first) and len(made) == n
    d.sample_ddim(model, y, SHAPE, n_sample_steps=3, null_label=10, x_init=x_init)
    assert len(made) == n + 2  # other arguments, other tables


def test_graphs_exist_on_cuda_alone(pair):
    """On the CPU there is only the eager loop: the default takes it, and a
    caller who asks for the graph by name gets an error, not the loop."""
    model = pair[2]
    assert use_graphs("cpu", None) is False and use_graphs("cpu", False) is False
    assert use_graphs("cuda", None) is True and use_graphs("cuda", False) is False
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        use_graphs("cpu", True)
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        StepGraph(lambda: None, "cpu")
    d = GaussianDiffusion(2)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        d.sample(model, torch.tensor([1]), SHAPE, null_label=10, generator=gen, graph=True)
    out = d.sample(model, torch.tensor([1]), SHAPE, null_label=10, generator=gen)
    assert out.shape == (1,) + SHAPE and d.last_capture_seconds == 0.0 and not d._graphs


def tiny_trainer(tmp_path):
    cfg = Config(project_name="tiny", workdir=str(tmp_path), batch_size=4, use_amp=False,
                 model=ModelConfig(params={**MODEL, "channel_multipliers": [1, 2]}),
                 diffusion=DiffusionConfig(n_steps=6),
                 data=DataConfig(dataset="SYNTHETIC", image_size=8, image_channels=3))
    torch.manual_seed(0)
    model = UNet(**MODEL)
    return DiffusionTrainer(cfg, model, GaussianDiffusion(6), None, None, list(range(10)),
                            device="cpu")


@pytest.mark.parametrize("method", ["ddpm", "ddim", "dpmpp"])
def test_trainer_sample_method(tmp_path, method):
    """``DiffusionTrainer.sample(method=...)``: uint8 NHWC, one image a class,
    repeatable (the sampling stream is seeded from the config), and what
    ``run_sampler`` gives from the same generator."""
    tr = tiny_trainer(tmp_path)
    assert tr.graphs is False  # a CPU trainer has only the eager paths
    kw = dict(cfg_scale=3.0, method=method, ddim_steps=3, eta=0.5)
    images = tr.sample([1, 2, 3], **kw)
    assert images.dtype == np.uint8 and images.shape == (3, 8, 8, 3)
    np.testing.assert_array_equal(tr.sample([1, 2, 3], **kw), images)
    steps3 = tr.sample([1, 2, 3], **{**kw, "ddim_steps": 6})
    assert (method == "ddpm") == np.array_equal(steps3, images)  # ddpm ignores ddim_steps
    with pytest.raises(ValueError, match="sampler must be one of"):
        tr.sample([1], method="heun")
    with pytest.raises(ValueError, match="sampler must be one of"):
        run_sampler(tr.diffusion, "heun", tr.model, torch.tensor([1]), SHAPE)


TINY_YAML = """\
project_name: tiny_torch_samplers
workdir: {workdir}
use_amp: False
diffusion:
  target: ldm_tpu.diffusion.ddpm.GaussianDiffusion
  cfg_scale: 3
  params:
    n_steps: 6
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


@pytest.mark.parametrize("sampler", ["ddpm", "ddim", "dpmpp"])
def test_generate_main_sampler_on_cpu(tmp_path, sampler, capsys):
    """``generate.main --sampler``: uint8 images from a finite x0, seeded and
    repeatable; ``--eager`` is the same loop on the CPU; the three samplers
    give different images."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(TINY_YAML.format(workdir=tmp_path / "runs"))
    config = load_config(str(cfg))
    os.makedirs(config.checkpoints)
    torch.manual_seed(config.seed)  # the run directory's weights, from the seed
    torch.save(build_model(config).state_dict(), checkpoint_path(config))
    argv = [str(cfg), "--device", "cpu", "--sampler", sampler, "--ddim-steps", "3",
            "--out", str(tmp_path / "x.npy")]
    res = generate.main(argv)
    assert res.images.dtype == np.uint8 and res.images.shape == (10, 8, 8, 3)
    assert np.isfinite(res.x0).all() and res.capture_seconds == 0.0
    assert f"({sampler}" in capsys.readouterr().out
    np.testing.assert_array_equal(generate.main(argv + ["--eager"]).x0, res.x0)
    other = "ddim" if sampler != "ddim" else "dpmpp"
    res2 = generate.main([str(cfg), "--device", "cpu", "--sampler", other, "--ddim-steps", "3",
                          "--out", str(tmp_path / "y.npy")])
    assert not np.array_equal(res2.x0, res.x0)
