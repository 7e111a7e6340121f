"""Consistency distillation in the port (ldm_tpu_torch/diffusion/consistency.py,
training/consistency_trainer.py, ``python -m ldm_tpu_torch.distill``, the
``consistency`` sampler of generate and serving) held against the JAX
package's (ldm_tpu/diffusion/consistency.py, training/consistency_trainer.py)
with the same weights (through the bridge), inputs and draws; fp32, a tiny
UNet (channels 8, multipliers [1, 2], 16px)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldm_tpu.diffusion import consistency as jc
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.training.consistency_trainer import sampling_timesteps as jax_sampling_timesteps
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu.utils.torch_export import unet_state_dict_from_params
from ldm_tpu_torch import distill, generate
from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.diffusion import consistency as pc
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.serving.builder import build_generation_service, checkpoint_path
from ldm_tpu_torch.serving.service import slot_generator, slot_x_init
from ldm_tpu_torch.training.consistency_trainer import (
    ConsistencyDistillTrainer,
    sampling_timesteps,
)
from ldm_tpu_torch.utils.flax_import import unet_from_flax

from _flax_params import random_params

T_STEPS, SKIP, B, SIZE, LR, CFG = 40, 10, 4, 16, 5e-4, 3.0
SHAPE = (SIZE, SIZE, 3)
MODEL = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
             num_classes=10)
MODULE_ATOL = 2e-5   # the JAX suite's tolerances: a module's output,
LOSS_RTOL = 1e-5     # a step's loss,
GRAD_TOL = 1e-4      # a gradient (x its leaf's max), a trajectory
TRAJ_ATOL = 1e-4
LOSSES = (("huber", 0.03), ("mse", 0.0))  # the pseudo-Huber constant of each step checked


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the trainers run many small CPU ops, and test
    workers sharing the cores each with a full OpenMP team slow each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """A tiny flax UNet, its params (numpy draws), a jitted apply and the
    port's UNet loaded from the same params."""
    flax_model = FlaxUNet(**MODEL)
    params = random_params(flax_model, jnp.zeros((1,) + SHAPE), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1,), jnp.int32))
    model = UNet(**MODEL).eval()
    model.load_state_dict(unet_from_flax(params), strict=True)
    return flax_model, params, jax.jit(flax_model.apply), model


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------- the functions
def test_boundary_scalings_match_jax():
    """c_skip exactly; c_out to two ulp (XLA's CPU rsqrt is an
    approximation, torch's 1/sqrt; they differ by an ulp, and the product by
    c_out's factor by one more); exact at t=0: f(x, 0) == x."""
    t = np.arange(0, 1000, dtype=np.int32)
    want = [np.asarray(v) for v in jc.boundary_scalings(jnp.asarray(t))]
    got = [v.numpy() for v in pc.boundary_scalings(torch.from_numpy(t).long())]
    assert got[0].shape == (1000, 1, 1, 1) and got[0].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_max_ulp(got[1], want[1], maxulp=2)
    assert got[0][0].item() == 1.0 and got[1][0].item() == 0.0


@pytest.mark.parametrize("n_steps,skip", [(400, 20), (1000, 20), (40, 10), (40, 7), (10, 1)])
def test_boundary_timesteps_match_jax(n_steps, skip):
    got, want = pc.boundary_timesteps(n_steps, skip), jc.boundary_timesteps(n_steps, skip)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("skip", [0, 400])
def test_boundary_timesteps_reject_a_bad_skip(skip):
    with pytest.raises(ValueError):
        pc.boundary_timesteps(400, skip)


@pytest.mark.parametrize("n_steps,k", [(400, 1), (400, 2), (400, 4), (1000, 3), (40, 4), (4, 4)])
def test_sampling_timesteps_match_jax(n_steps, k):
    assert sampling_timesteps(n_steps, k) == jax_sampling_timesteps(n_steps, k)


def test_sampling_timesteps_reject_zero_steps():
    with pytest.raises(ValueError):
        sampling_timesteps(400, 0)


def test_consistency_fn_matches_jax(pair):
    flax_model, params, apply, model = pair
    x = rand(1, B, *SHAPE)
    t = np.array([0, 3, 17, 39], np.int32)
    y = np.array([1, 5, 9, 10], np.int32)  # 10: the null label
    want = jc.consistency_fn(JaxDiffusion(T_STEPS), apply, params, jnp.asarray(x),
                             jnp.asarray(t), jnp.asarray(y))
    with torch.no_grad():
        got = pc.consistency_fn(GaussianDiffusion(T_STEPS), model, torch.from_numpy(x),
                                torch.from_numpy(t).long(), torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=MODULE_ATOL)
    np.testing.assert_array_equal(got[0].numpy(), x[0])  # the boundary: f(x, 0) == x


@pytest.mark.parametrize("k", [1, 2, 4])
def test_sample_consistency_matches_jax(pair, k):
    """A whole k-step trajectory (T=40, B=2) from JAX's x_T and re-noise
    draws ``normal(fold_in(key, t))``; the port asks for every step's draw
    and ignores the first."""
    flax_model, params, apply, model = pair
    classes = np.array([3, 7], np.int32)
    ts = sampling_timesteps(T_STEPS, k)
    key = jax.random.key(5)
    x_init = np.array(jax.random.normal(jax.random.key(6), (2,) + SHAPE, jnp.float32))
    want = jc.sample_consistency(JaxDiffusion(T_STEPS), apply, params, key,
                                 jnp.asarray(classes), SHAPE, ts=ts, x_init=jnp.asarray(x_init))
    asked = []

    def noise(t):
        asked.append(t)
        return torch.from_numpy(np.array(jax.random.normal(jax.random.fold_in(key, t),
                                                           (2,) + SHAPE, jnp.float32)))

    got = pc.sample_consistency(GaussianDiffusion(T_STEPS), model,
                                torch.from_numpy(classes).long(), SHAPE, ts=ts,
                                x_init=torch.from_numpy(x_init), noise=noise)
    assert got.shape == (2,) + SHAPE and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TRAJ_ATOL)
    assert asked == (list(ts) if k > 1 else [])


def test_slot_generators_make_a_slot_independent_of_its_batch():
    """Per-slot re-noise draws: permuting the batch (its x_T, classes and
    generators) permutes the output, bit for bit."""
    diffusion = GaussianDiffusion(20)

    def toy(x, t, y):
        return 0.3 * x + 0.01 * y.to(torch.float32).reshape(-1, 1, 1, 1)

    classes = torch.tensor([0, 1, 2])
    x_init = torch.from_numpy(rand(9, 3, 4, 4, 1))
    seeds = [(11, 0), (22, 1), (33, 0)]
    kw = dict(ts=(19, 9, 4))
    a = pc.sample_consistency(diffusion, toy, classes, (4, 4, 1), x_init=x_init,
                              slot_generators=[slot_generator(*s) for s in seeds], **kw)
    perm = [2, 0, 1]
    b = pc.sample_consistency(diffusion, toy, classes[perm], (4, 4, 1), x_init=x_init[perm],
                              slot_generators=[slot_generator(*seeds[i]) for i in perm], **kw)
    assert torch.equal(a[perm], b)
    c = pc.sample_consistency(diffusion, toy, classes, (4, 4, 1), x_init=x_init,
                              slot_generators=[slot_generator(*s) for s in seeds[::-1]], **kw)
    assert not torch.equal(a, c)  # the draws come from the generators
    with pytest.raises(ValueError, match="slot generators"):
        pc.sample_consistency(diffusion, toy, classes, (4, 4, 1), x_init=x_init,
                              slot_generators=[slot_generator(1, 0)], **kw)


def test_the_sampler_needs_a_gaussian_diffusion(pair):
    from ldm_tpu_torch.diffusion.flow import RectifiedFlow
    from ldm_tpu_torch.training.diffusion_trainer import run_sampler

    model = pair[3]
    with pytest.raises(ValueError, match="GaussianDiffusion"):
        run_sampler(RectifiedFlow(10), "consistency", model, torch.tensor([1]), SHAPE,
                    ddim_steps=2, generator=torch.Generator())


# ------------------------------------------------------------ one step
def config(tmp, **kw):
    return Config(
        project_name="cd", workdir=str(tmp), batch_size=B, use_amp=False, lr=LR, epochs=1,
        model=ModelConfig(params={**MODEL, "channel_multipliers": [1, 2]}),
        diffusion=DiffusionConfig(n_steps=T_STEPS, cfg_scale=CFG),
        data=DataConfig(dataset="SYNTHETIC", image_size=SIZE, image_channels=3), **kw)


class Oracle:
    """The JAX distillation step from the JAX package's own parts (the body
    of ``ConsistencyDistillTrainer._step_body``), jitted once for both
    losses: each returns its loss, grads and the state after Adam and the
    EMA, beside the step's draws."""

    def __init__(self, flax_model, params, ema_decay=0.95):
        diffusion = JaxDiffusion(T_STEPS)
        sub = jnp.asarray(jc.boundary_timesteps(T_STEPS, SKIP))
        self.state0 = JaxState.create(jax.tree.map(jnp.copy, params), make_optimizer(LR),
                                      jax.random.key(7), ema_decay=ema_decay)
        teacher = params
        apply = flax_model.apply

        def step(state, image, label):
            k_n, k_eps = jax.random.split(state.step_key())
            b = image.shape[0]
            n = jax.random.randint(k_n, (b,), 0, len(sub) - 1, jnp.int32)
            t0, t1 = sub[n], sub[n + 1]
            eps = jax.random.normal(k_eps, image.shape, jnp.float32)
            x_t1 = diffusion.q_sample(image, t1, eps)
            null = jnp.full((b,), 10, label.dtype)
            teach = diffusion._cfg_eps(apply, teacher, x_t1, t1,
                                       jnp.concatenate([label, null]), CFG, True)
            x_t0 = diffusion.ddim_step(x_t1, t1, t0, teach, jnp.zeros_like(x_t1), eta=0.0)
            target = jax.lax.stop_gradient(
                jc.consistency_fn(diffusion, apply, state.ema_params, x_t0, t0, label))
            out = {"n": n, "eps": eps}
            for name, c in LOSSES:
                def loss_fn(p, c=c):
                    d2 = (jc.consistency_fn(diffusion, apply, p, x_t1, t1, label)
                          - target) ** 2
                    return jnp.mean(jnp.sqrt(d2 + c * c) - c) if c > 0 else jnp.mean(d2)

                loss, grads = jax.value_and_grad(loss_fn)(state.params)
                out[name] = (loss, grads, optax.global_norm(grads),
                             state.apply_gradients(grads))
            return out

        self.step = jax.jit(step)


@pytest.fixture(scope="module")
def oracle(pair):
    flax_model, params, _, _ = pair
    orc = Oracle(flax_model, params)
    rng = np.random.default_rng(3)
    image = rng.uniform(-1, 1, (B,) + SHAPE).astype(np.float32)
    label = rng.integers(0, 10, B).astype(np.int32)
    return orc, {"image": image, "label": label}, orc.step(orc.state0, jnp.asarray(image),
                                                            jnp.asarray(label))


def leaves(tree):
    return {k: np.asarray(v, np.float32)
            for k, v in unet_state_dict_from_params(jax.device_get(tree)).items()}


@pytest.mark.parametrize("name,huber_c", LOSSES)
def test_one_distill_step_matches_jax(pair, oracle, tmp_path, name, huber_c):
    """The port's step fed JAX's n and eps: the loss, the grad norm, every
    grad (1e-4 of its leaf's max, floored at 1e-2 of the largest) and the
    EMA after the step; the teacher is untouched."""
    _, params, _, _ = pair
    _, batch, out = oracle
    want_loss, want_grads, want_gnorm, new_state = out[name]
    teacher = UNet(**MODEL)
    teacher.load_state_dict(unet_from_flax(params), strict=True)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    trainer = ConsistencyDistillTrainer(
        config(tmp_path), teacher, GaussianDiffusion(T_STEPS), None, list(range(10)),
        device="cpu", skip_steps=SKIP, huber_c=huber_c, lr=LR)
    m = trainer.train_step(batch, n=torch.from_numpy(np.array(out["n"])),
                           eps=torch.from_numpy(np.array(out["eps"])))
    np.testing.assert_allclose(m["loss"].item(), float(want_loss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["grad_norm"].item(), float(want_gnorm), rtol=GRAD_TOL)
    grads = leaves(want_grads)
    floor = 1e-2 * max(float(np.abs(g).max()) for g in grads.values())
    for key, p in trainer.model.named_parameters():
        scale = max(float(np.abs(grads[key]).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), grads[key], rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=key)
    # the EMA after one step: d = min(0.95, 1/10) of the old (the teacher) and
    # 0.9 of the new weights, which Adam moved by about lr * sign(g)
    want_ema = leaves(new_state.ema_params)
    for key, e in trainer.state.ema.named_parameters():
        np.testing.assert_allclose(e.detach().numpy(), want_ema[key], rtol=0,
                                   atol=2 * 0.9 * LR * (1 + 1e-6), err_msg=key)
        clear = np.abs(grads[key]) > 1e-3 * max(float(np.abs(grads[key]).max()), floor)
        assert (np.abs(e.detach().numpy() - want_ema[key])[clear] <= 1e-6).all(), key
    assert all(torch.equal(v, before[k]) for k, v in teacher.state_dict().items())
    assert not teacher.training and not any(p.requires_grad for p in teacher.parameters())
    assert trainer.state.step == 1


def test_the_student_starts_as_the_teacher_without_its_cache(pair, tmp_path):
    """The student and the EMA are copies of the teacher (equal weights,
    other tensors) whose cached kernel weight copies were dropped."""
    teacher = pair[3]
    block = teacher.lin_attn_blocks()[0]
    block._kernel_w_key, block._kernel_w = ("stale",), object()
    trainer = ConsistencyDistillTrainer(config(tmp_path), teacher, GaussianDiffusion(T_STEPS),
                                        None, list(range(10)), device="cpu", skip_steps=SKIP)
    for m in (trainer.state.model, trainer.state.ema):
        for (k, v), w in zip(m.state_dict().items(), teacher.state_dict().values()):
            assert torch.equal(v, w) and v.data_ptr() != w.data_ptr(), k
        assert all(b._kernel_w is None for b in m.lin_attn_blocks())
    assert trainer.state.ema_decay == 0.95 and trainer.huber_c == 0.03
    np.testing.assert_array_equal(trainer.sub_t.numpy(), jc.boundary_timesteps(T_STEPS, SKIP))
    block._kernel_w_key, block._kernel_w = None, None


# ------------------------------------------------------------ end to end
def test_distill_generate_and_serve_end_to_end(pair, tmp_path, capsys):
    """``distill.main`` on a seeded teacher (2 epochs), then the student
    through ``generate.main --sampler consistency`` at 1, 2 and 4 steps and
    through the builder: a request alone and again packed with others gives
    the same images (per-slot re-noise), and equals ``sample_consistency`` on
    the slots' generators."""
    import yaml

    raw = {"project_name": "cd_e2e", "workdir": str(tmp_path), "batch_size": 8,
           "epochs": 1, "use_amp": False, "seed": 0, "sample_every": 0,
           "diffusion": {"cfg_scale": CFG, "params": {"n_steps": T_STEPS}},
           "model": {"params": {**MODEL, "channel_multipliers": [1, 2]}},
           "data": {"dataset": "CIFAR10", "data_path": str(tmp_path / "none"),
                    "image_size": SIZE, "image_channels": 3, "synthetic_size": 60}}
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    teacher = tmp_path / "teacher.pt"
    torch.save(pair[3].state_dict(), teacher)
    res = distill.main([str(path), "--device", "cpu", "--epochs", "2", "--skip", str(SKIP),
                        "--teacher-checkpoint", str(teacher), "--sample-steps", "2"])
    tr = res.trainer
    assert len(res.result["history"]) == 2 and np.isfinite(res.result["history"]).all()
    assert tr.state.ema_decay == 0.99 and tr.state.lr == 2e-4 and tr.step_counts["graphed"] == 0
    cfg = tr.config
    for name in ("consistency_model.pt", "consistency_model_ema.pt"):
        assert os.path.exists(os.path.join(cfg.checkpoints, name))
    assert np.load(res.grid).dtype == np.uint8
    weights = checkpoint_path(cfg, True, "consistency_model")
    for k in (1, 2, 4):
        g = generate.main([str(path), "--device", "cpu", "--sampler", "consistency",
                           "--ddim-steps", str(k), "--weights", weights,
                           "--out", str(tmp_path / "x.npy")])
        assert g.images.shape == (10,) + SHAPE and np.isfinite(g.x0).all()
    assert "no guidance pass" in capsys.readouterr().out

    svc = build_generation_service(cfg, sampler="consistency", ddim_steps=2, batch_size=8,
                                   max_delay_s=0.2, device="cpu")
    with svc:
        alone = svc.submit([1, 2, 3], n=3, seed=5).result(timeout=120)
        futures = [svc.submit(4, n=2, seed=9), svc.submit([1, 2, 3], n=3, seed=5),
                   svc.submit(6, n=3, seed=1)]
        packed = futures[1].result(timeout=120)
        [f.result(timeout=120) for f in futures]
    # other batch contents may move a CPU convolution's last bit: a pixel may
    # land one level away, rarely; a batch-wide re-noise draw would move all
    diff = np.abs(alone.astype(np.int32) - packed.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, ((diff > 0).mean(), diff.max())
    # the request alone: slots 0-2, then the padding (seed 0, index 0, class 0)
    seeds = np.array([5, 5, 5] + [0] * 5, np.int32)
    idxs = np.array([0, 1, 2] + [0] * 5, np.int32)
    x_init, gens = slot_x_init(seeds, idxs, SHAPE)
    student = UNet(**MODEL).eval()
    student.load_state_dict(torch.load(weights), strict=True)
    x0 = pc.sample_consistency(GaussianDiffusion(T_STEPS), student,
                               torch.tensor([1, 2, 3] + [0] * 5), SHAPE,
                               ts=sampling_timesteps(T_STEPS, 2), x_init=x_init,
                               slot_generators=gens)
    np.testing.assert_array_equal(alone, reverse_transform(x0.numpy())[:3])
