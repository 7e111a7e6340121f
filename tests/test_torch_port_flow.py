"""The port's rectified flow (ldm_tpu_torch/diffusion/flow.py) held against
ldm_tpu/diffusion/flow.py: the noising with injected draws, whole Euler and
Heun trajectories with CFG from carried UNet weights, the negative control,
one train step against the JAX step on the same draws, the registry, and a
flow checkpoint served through the port's service."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldm_tpu.diffusion.flow import RectifiedFlow as JaxFlow
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu.utils.torch_export import unet_state_dict_from_params
from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.factory import build_diffusion, build_model, load_config
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.utils.flax_import import unet_from_flax

SHAPE = (8, 8, 3)
MODEL = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
             num_classes=2)
NULL = 2
TRAJ_ATOL = 1e-4  # the ancestral T=10 trajectory check's (test_torch_port_ddpm.py)
LR, B = 5e-4, 4


@pytest.fixture(scope="module")
def pair():
    """A tiny flax UNet (2 classes + the null label) and the port's UNet
    loaded from its params through the bridge."""
    flax_model = FlaxUNet(**MODEL)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(0), jnp.zeros((1,) + SHAPE), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))
    model = UNet(**MODEL).eval()
    model.load_state_dict(unet_from_flax(params), strict=True)
    return flax_model, params, model


def test_q_sample_and_noise_batch_with_injected_draws():
    """x_t = (1 - t) x0 + t eps, and noise_batch on the JAX key's own draws
    (split into t ~ U(0, 1) and eps): the velocity target, x_t and the fp32
    time input t * (n_steps - 1), 1e-6."""
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (4,) + SHAPE).astype(np.float32)
    jf, pf = JaxFlow(n_steps=400), RectifiedFlow(n_steps=400)
    key = jax.random.key(3)
    want = jf.noise_batch(key, jnp.asarray(x0))
    kt, ke = jax.random.split(key)
    t = np.array(jax.random.uniform(kt, (4,), jnp.float32))
    eps = np.array(jax.random.normal(ke, x0.shape, jnp.float32))
    got = pf.noise_batch(torch.from_numpy(x0), t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        pf.q_sample(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(eps)).numpy(),
        np.asarray(jf.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(eps))),
        rtol=0, atol=1e-6)
    drawn_t, drawn_eps = pf.draw_t_eps(torch.from_numpy(x0),
                                       generator=torch.Generator().manual_seed(0))
    assert drawn_t.dtype == torch.float32 and ((drawn_t >= 0) & (drawn_t < 1)).all()
    assert drawn_eps.shape == x0.shape
    with pytest.raises(ValueError, match="generator"):
        pf.draw_t_eps(torch.from_numpy(x0))


# (port method, its JAX twin, steps, extra arguments)
TRAJECTORIES = [
    ("sample_ddim", 10, {}),                        # Euler-10
    ("sample_dpmpp", 5, {}),                        # Heun-5
    ("sample_dpmpp", 5, {"order": 1}),              # order 1: Euler
    ("sample_ddim", 10, {"ode_direction": -1.0}),   # the negative control, Euler
    ("sample_dpmpp", 5, {"ode_direction": -1.0}),   # and Heun
    ("sample", None, {}),                           # the DDPM slot: Euler over n_steps
]


@pytest.mark.parametrize("method,steps,extra", TRAJECTORIES)
def test_trajectory_matches_jax(pair, method, steps, extra):
    """A whole trajectory (B=2, CFG 3 with the null label) from the same x_T
    through the carried weights, against the JAX solver: 1e-4."""
    flax_model, params, model = pair
    n_steps = 6 if method == "sample" else 400
    classes = np.array([0, 1], np.int32)
    x_init = np.random.default_rng(1).standard_normal((2,) + SHAPE).astype(np.float32)
    kw = dict(extra)
    if steps is not None:
        kw["n_sample_steps"] = steps
    jf = JaxFlow(n_steps=n_steps)
    want = jax.jit(lambda p: getattr(jf, method)(
        flax_model.apply, p, jax.random.key(0), jnp.asarray(classes), SHAPE, cfg_scale=3.0,
        null_label=NULL, x_init=jnp.asarray(x_init), **kw))(params)
    got = getattr(RectifiedFlow(n_steps=n_steps), method)(
        model, torch.from_numpy(classes).long(), SHAPE, cfg_scale=3.0, null_label=NULL,
        x_init=torch.from_numpy(x_init), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TRAJ_ATOL)
    assert float(np.abs(np.asarray(want) - x_init).max()) > 1e-2  # it moved


def test_eta_raises_and_direction_keys_the_method(pair):
    """``eta != 0`` has no meaning for an ODE; ``ode_direction`` is part of
    the method, so of the captured graph's key."""
    model = pair[2]
    flow = RectifiedFlow(n_steps=10)
    y, x = torch.tensor([0]), torch.zeros((1,) + SHAPE)
    with pytest.raises(ValueError, match="eta"):
        flow.sample_ddim(model, y, SHAPE, n_sample_steps=2, eta=0.5, null_label=NULL, x_init=x)
    for direction in (1.0, -1.0):
        flow.sample_dpmpp(model, y, SHAPE, n_sample_steps=2, null_label=NULL, x_init=x,
                          ode_direction=direction)
    keys = {m.key for m in flow._methods.values()}
    assert keys == {("heun", 2, 1.0), ("heun", 2, -1.0)}
    assert sorted(m.dt for m in flow._methods.values()) == [-0.5, 0.5]


def test_time_tables_are_the_jax_fp32_grid():
    """The Heun tables: ``arange(n, 0, -1, float32) / n`` and ``t - 1/n`` in
    fp32, times n_steps - 1, as the JAX scan computes them."""
    flow, n = RectifiedFlow(n_steps=400), 25
    flow.sample_dpmpp(lambda x, t, y: torch.zeros_like(x), torch.tensor([0]), (2, 2, 1),
                      n_sample_steps=n, cfg_scale=0.0, x_init=torch.zeros((1, 2, 2, 1)))
    tables = next(iter(flow._methods.values())).tables
    ts = jnp.arange(n, 0, -1, jnp.float32) / n
    want1 = np.asarray(jax.vmap(lambda t: jnp.full((1,), t, jnp.float32) * 399)(ts))[:, 0]
    want2 = np.asarray(jax.vmap(
        lambda t: jnp.full((1,), t - 1.0 / n, jnp.float32) * 399)(ts))[:, 0]
    np.testing.assert_array_equal(tables[0].numpy(), want1)
    np.testing.assert_array_equal(tables[1].numpy(), want2)


# ------------------------------------------------------------- train step
def config(tmp, **kw):
    return Config(
        project_name="flow", workdir=str(tmp), batch_size=B, use_amp=False, lr=LR,
        model=ModelConfig(params=dict(MODEL, channel_multipliers=[1, 2])),
        diffusion=DiffusionConfig(target="ldm_tpu.diffusion.flow.RectifiedFlow", n_steps=400,
                                  label_drop_prob=0.5),
        data=DataConfig(dataset="SYNTHETIC", image_size=8, image_channels=3), **kw)


def grad_scales(grads):
    """Each leaf's largest gradient, but at least 1e-2 of the model's largest
    (a leaf whose exact gradient vanishes carries rounding noise alone)."""
    floor = 1e-2 * max(float(np.abs(g).max()) for g in grads.values())
    return {k: max(float(np.abs(g).max()), floor) for k, g in grads.items()}


def test_one_flow_train_step_matches_the_jax_step(pair, tmp_path):
    """The JAX step body for a flow (``_step_body``'s parts: the step key
    split into noise / drop keys, ``RectifiedFlow.noise_batch``, the batch
    label drop, the MSE against the velocity, Adam) and the port's trainer
    step fed the same t, eps and drop: loss 1e-5, every gradient 1e-4 of its
    leaf's scale."""
    flax_model, params, _ = pair
    jf = JaxFlow(n_steps=400)
    rng = np.random.default_rng(2)
    image = rng.uniform(-1, 1, (B,) + SHAPE).astype(np.float32)
    label = rng.integers(0, 2, B).astype(np.int32)
    state = JaxState.create(params, make_optimizer(LR), jax.random.key(7))

    @jax.jit
    def step(state, image, label):
        k_noise, k_drop, _ = jax.random.split(state.step_key(), 3)
        v, xt, t_in = jf.noise_batch(k_noise, image)
        drop = jax.random.bernoulli(k_drop, 0.5)
        y = jnp.where(drop, NULL, label)

        def loss_fn(p):
            return jnp.mean((v - flax_model.apply(p, xt, t_in, y)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        kt, ke = jax.random.split(k_noise)
        t = jax.random.uniform(kt, (B,), jnp.float32)
        eps = jax.random.normal(ke, image.shape, image.dtype)
        return loss, grads, t, eps, drop, optax.global_norm(grads)

    loss, grads, t, eps, drop, gnorm = step(state, jnp.asarray(image), jnp.asarray(label))
    model = UNet(**MODEL)
    model.load_state_dict(unet_from_flax(params), strict=True)
    trainer = DiffusionTrainer(config(tmp_path), model, RectifiedFlow(n_steps=400), None,
                               None, [0, 1], device="cpu")
    m = trainer.train_step({"image": image, "label": label},
                           t=torch.from_numpy(np.array(t)), eps=torch.from_numpy(np.array(eps)),
                           drop=torch.tensor(bool(drop)))
    np.testing.assert_allclose(m["loss"].item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(gnorm), rtol=1e-4)
    want = {k: np.asarray(v, np.float32) for k, v in
            unet_state_dict_from_params(jax.device_get(grads)).items()}
    scales = grad_scales(want)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=1e-4 * scales[name], err_msg=name)


def test_trainer_samples_a_flow_with_its_negative_control(tmp_path):
    """``DiffusionTrainer.sample`` drives a flow's three slots and passes
    ``ode_direction`` only when it is not 1 (a DDPM process refuses it)."""
    torch.manual_seed(0)
    model = UNet(**MODEL)
    kw = dict(cfg_scale=3.0, generator=torch.Generator().manual_seed(0))
    for process in (RectifiedFlow(n_steps=6), GaussianDiffusion(6)):
        trainer = DiffusionTrainer(config(tmp_path), model, process, None, None, [0, 1],
                                   device="cpu")
        for method in ("ddpm", "ddim", "dpmpp"):
            out = trainer.sample([0, 1], method=method, ddim_steps=2, **kw)
            assert out.shape == (2,) + SHAPE and out.dtype == np.uint8
        if isinstance(process, RectifiedFlow):
            broken = trainer.sample([0, 1], method="dpmpp", ddim_steps=2,
                                    ode_direction=-1.0, **kw)
            assert broken.shape == (2,) + SHAPE
        else:
            with pytest.raises(TypeError):
                trainer.sample([0, 1], method="ddim", ddim_steps=2, ode_direction=-1.0, **kw)


@pytest.mark.parametrize("path,kind", [("configs/protocol_flow_hard.yaml", RectifiedFlow),
                                       ("configs/protocol_r5_flow_heun25.yaml", RectifiedFlow),
                                       ("configs/pixel_diffusion_model_cifar10.yaml",
                                        GaussianDiffusion)])
def test_registry_builds_each_family(path, kind):
    cfg = load_config(path)
    process = build_diffusion(cfg)
    assert type(process) is kind and process.n_steps == cfg.diffusion.n_steps
    assert isinstance(build_model(dataclasses.replace(cfg, use_amp=False)), UNet)


def test_service_serves_a_flow_checkpoint(tmp_path):
    """A tiny flow UNet through ``build_generation_service`` (``ddim`` is
    Euler): a 4-image request in one batch of 4 equals ``sample_ddim`` on the
    same x_T in the same slots, bit for bit."""
    from ldm_tpu_torch.serving.builder import build_generation_service, checkpoint_path
    from ldm_tpu_torch.serving.service import slot_x_init

    cfg = dataclasses.replace(config(tmp_path), seed=0)
    cfg.create_dirs()
    torch.manual_seed(0)
    torch.save(build_model(cfg).state_dict(), checkpoint_path(cfg))
    svc = build_generation_service(cfg, sampler="ddim", ddim_steps=3, batch_size=4,
                                   max_delay_s=0.01, device="cpu")
    with svc:
        got = svc.submit(1, n=4, seed=9).result(timeout=120)
    model = build_model(cfg)
    model.load_state_dict(torch.load(checkpoint_path(cfg), weights_only=True))
    x_init, _ = slot_x_init(np.full(4, 9, np.int32), np.arange(4, dtype=np.int32), SHAPE)
    x0 = build_diffusion(cfg).sample_ddim(model.eval(), torch.ones(4, dtype=torch.int64),
                                          SHAPE, n_sample_steps=3, cfg_scale=3.0,
                                          null_label=NULL, x_init=x_init)
    np.testing.assert_array_equal(got, reverse_transform(x0.numpy()))
    assert len(np.unique(got)) > 10
