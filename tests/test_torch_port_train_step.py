"""One training step of the port (ldm_tpu_torch/training/) held against the
JAX step (ldm_tpu/training/), from equal state, batch and draws.

The oracle is built from the JAX step's own parts, jitted once: the key of
step s is ``fold_in(key, s)`` split into noise / drop / encode keys, then
``GaussianDiffusion.noise_batch``, ``DiffusionTrainer._dropped_labels``,
``jax.value_and_grad`` of the eps-MSE, and ``TrainState.apply_gradients``
(Adam + EMA) -- the body of ``DiffusionTrainer._step_body`` without building
a whole JAX trainer.  The port gets the same weights (through the bridge) and
the JAX draws of t, eps and the drop mask.  fp32, a tiny UNet.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ldm_tpu.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.training.diffusion_trainer import DiffusionTrainer as JaxTrainer
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu.utils.torch_export import unet_state_dict_from_params
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.training.state import TrainState, ema_decay_at
from ldm_tpu_torch.utils.flax_import import unet_from_flax

LR, T_STEPS, B, SIZE = 5e-4, 10, 4, 16
MODEL = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=[1, 2],
             num_classes=10)
NULL = 10


def config(tmp, mode="batch", p=0.1):
    return Config(
        project_name="step", workdir=str(tmp), batch_size=B, use_amp=False, lr=LR,
        model=ModelConfig(params=MODEL),
        diffusion=DiffusionConfig(n_steps=T_STEPS, label_drop_mode=mode, label_drop_prob=p),
        data=DataConfig(dataset="SYNTHETIC", image_size=SIZE, image_channels=3),
    )


def batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32),
            "label": rng.integers(0, 10, B).astype(np.int32)}


def jax_drop(cfg, key, y):
    """The JAX trainer's label drop, called without building the trainer."""
    fake = types.SimpleNamespace(config=cfg, model=types.SimpleNamespace(num_classes=NULL))
    return JaxTrainer._dropped_labels(fake, key, y)


class Oracle:
    """The JAX step, jitted once, returning the step's draws beside its result."""

    def __init__(self, cfg):
        self.model = FlaxUNet(**{**MODEL, "channel_multipliers": (1, 2)})
        key = jax.random.key(cfg.seed)
        k_init, k_state = jax.random.split(key)
        params = jax.jit(self.model.init)(
            k_init, jnp.zeros((1, SIZE, SIZE, 3)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1,), jnp.int32))
        self.state0 = JaxState.create(params, make_optimizer(LR), k_state,
                                      ema_decay=cfg.ema_decay)
        diffusion = JaxDiffusion(T_STEPS)

        def step(state, image, label):
            k_noise, k_drop, _ = jax.random.split(state.step_key(), 3)
            eps, xt, t = diffusion.noise_batch(k_noise, image)
            y = jax_drop(cfg, k_drop, label)

            def loss_fn(p):
                return jnp.mean((eps - self.model.apply(p, xt, t, y)) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(state.params)
            new = state.apply_gradients(grads)
            return new, {"loss": loss, "grads": grads, "eps": eps, "t": t, "y": y,
                         "grad_norm": optax.global_norm(grads)}

        self.step = jax.jit(step)


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    cfg = config(tmp_path_factory.mktemp("oracle"))
    return cfg, Oracle(cfg)


def port_trainer(cfg, params):
    model = UNet(**MODEL)
    model.load_state_dict(unet_from_flax(jax.device_get(params)), strict=True)
    return DiffusionTrainer(cfg, model, GaussianDiffusion(T_STEPS), None, None,
                            list(range(10)), device="cpu")


def draws(out, label):
    """The JAX step's draws as the port takes them."""
    drop = np.asarray(out["y"]) == NULL
    assert not (np.asarray(label) == NULL).any()
    return dict(t=torch.from_numpy(np.array(out["t"])),
                eps=torch.from_numpy(np.array(out["eps"])),
                drop=torch.from_numpy(drop))


def grad_scales(grads):
    """Each leaf's gradient scale: its largest entry, but at least 1e-2 of the
    model's largest gradient.  A leaf whose exact gradient vanishes (a conv
    bias before a GroupNorm with one channel a group, at channels=8) carries
    rounding noise alone, which sums in another order change freely."""
    floor = 1e-2 * max(float(np.abs(g).max()) for g in grads.values())
    return {k: max(float(np.abs(g).max()), floor) for k, g in grads.items()}


def leaves(tree):
    return {k: np.asarray(v, np.float32) for k, v in unet_state_dict_from_params(
        jax.device_get(tree)).items()}


def test_one_step_from_equal_state(oracle, tmp_path):
    cfg, orc = oracle
    b = batch(0)
    new, out = orc.step(orc.state0, jnp.asarray(b["image"]), jnp.asarray(b["label"]))
    trainer = port_trainer(config(tmp_path), orc.state0.params)
    m = trainer.train_step(b, **draws(out, b["label"]))
    assert trainer.state.step == 1

    np.testing.assert_allclose(m["loss"].item(), float(out["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), float(out["grad_norm"]), rtol=1e-4)
    grads = leaves(out["grads"])
    scales = grad_scales(grads)
    for name, p in trainer.model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name], rtol=0,
                                   atol=1e-4 * scales[name], err_msg=name)

    # Adam's first step is about lr * sign(g): an entry whose gradient is
    # within fp32 noise of 0 may land up to 2 lr away; every other entry
    # agrees to 1e-6
    want_p, want_e = leaves(new.params), leaves(new.ema_params)
    ema = dict(trainer.state.ema.named_parameters())
    for name, p in trainer.model.named_parameters():
        clear = np.abs(grads[name]) > 1e-3 * scales[name]
        for got, want in ((p, want_p[name]), (ema[name], want_e[name])):
            diff = np.abs(got.detach().numpy() - want)
            assert diff.max() <= 2 * LR * (1 + 1e-6), name
            assert (diff[clear] <= 1e-6).all(), name


def test_optimizer_fed_the_jax_grads_matches_optax(oracle):
    """The port's Adam + EMA, given the JAX grads, against optax: params and
    moments to 1e-7; the EMA, (1-d) = 0.9 times the params plus its own
    rounding (an ulp is 3e-8 at 0.3), to 2e-7."""
    cfg, orc = oracle
    b = batch(1)
    new, out = orc.step(orc.state0, jnp.asarray(b["image"]), jnp.asarray(b["label"]))
    model = UNet(**MODEL)
    model.load_state_dict(unet_from_flax(jax.device_get(orc.state0.params)))
    state = TrainState(model, LR, cfg.ema_decay)
    grads = leaves(out["grads"])
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads[name].copy())
    state.apply_gradients()
    adam = new.opt_state[0]
    want = {"param": leaves(new.params), "ema": leaves(new.ema_params),
            "exp_avg": leaves(adam.mu), "exp_avg_sq": leaves(adam.nu)}
    ema = dict(state.ema.named_parameters())
    for name, p in model.named_parameters():
        got = {"param": p, "ema": ema[name], **state.optimizer.state[p]}
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w[name], rtol=0,
                                       atol=2e-7 if k == "ema" else 1e-7,
                                       err_msg=f"{name} {k}")
    assert int(adam.count) == 1 and state.step == 1


@pytest.mark.parametrize("step", [0, 1])
def test_ema_warmup_weight(step):
    """d = min(decay, (1+s)/(10+s)) at the step before the increment."""
    want = jnp.minimum(0.9999, (1.0 + jnp.int32(step)) / (10.0 + jnp.int32(step)))
    assert ema_decay_at(0.9999, step) == float(want)
    assert ema_decay_at(0.9999, step) == pytest.approx((1 + step) / (10 + step), rel=1e-7)


def test_three_steps_give_the_jax_loss_curve(oracle, tmp_path):
    cfg, orc = oracle
    trainer = port_trainer(config(tmp_path), orc.state0.params)
    state, want, got = orc.state0, [], []
    for s in range(3):
        b = batch(10 + s)
        state, out = orc.step(state, jnp.asarray(b["image"]), jnp.asarray(b["label"]))
        want.append(float(out["loss"]))
        got.append(trainer.train_step(b, **draws(out, b["label"]))["loss"].item())
    assert trainer.state.step == int(state.step) == 3
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("mode", ["batch", "sample"])
def test_label_drop_modes_follow_the_jax_mask(mode, tmp_path):
    """With the JAX mask handed over, the port drops the same labels; left to
    its own draw, it drops the whole batch or per sample as the mode says."""
    cfg = config(tmp_path, mode=mode, p=0.5)
    trainer = DiffusionTrainer(cfg, UNet(**MODEL), GaussianDiffusion(T_STEPS), None, None,
                               list(range(10)), device="cpu")
    y = np.arange(8, dtype=np.int32)
    seen = set()
    for s in range(8):
        want = np.asarray(jax_drop(cfg, jax.random.key(s), jnp.asarray(y)))
        mask = want == NULL
        assert mask.shape == y.shape
        got = trainer.dropped_labels(torch.from_numpy(y).long(),
                                     drop=torch.from_numpy(mask if mode == "sample"
                                                           else np.array(mask.all())))
        np.testing.assert_array_equal(got.numpy(), want)
        g = torch.Generator().manual_seed(s)
        own = trainer.dropped_labels(torch.from_numpy(y).long(), generator=g).numpy() == NULL
        seen.add(tuple(own))
        if mode == "batch":
            assert own.all() or not own.any()
    if mode == "sample":
        assert any(0 < sum(m) < len(y) for m in seen)


def test_eval_step_cfg_lerp_loss(oracle, tmp_path):
    """The validation loss with the CFG lerp, against the JAX eval step's
    formula on the same weights and draws."""
    cfg, orc = oracle
    b = batch(2)
    rng = np.random.default_rng(3)
    t = rng.integers(0, T_STEPS, B).astype(np.int32)
    eps = rng.standard_normal((B, SIZE, SIZE, 3)).astype(np.float32)
    diffusion = JaxDiffusion(T_STEPS)
    x0 = jnp.asarray(b["image"])
    xt = diffusion.q_sample(x0, jnp.asarray(t), jnp.asarray(eps))

    @jax.jit
    def jax_eval(params):
        y = jnp.asarray(b["label"])
        cond = orc.model.apply(params, xt, jnp.asarray(t), y)
        uncond = orc.model.apply(params, xt, jnp.asarray(t), jnp.full_like(y, NULL))
        return jnp.mean((jnp.asarray(eps) - (uncond + cfg.diffusion.cfg_scale * (cond - uncond))) ** 2)

    trainer = port_trainer(config(tmp_path), orc.state0.params)
    got = trainer.eval_step(b, 0, t=torch.from_numpy(t), eps=torch.from_numpy(eps))
    np.testing.assert_allclose(got.item(), float(jax_eval(orc.state0.params)), rtol=1e-5)
