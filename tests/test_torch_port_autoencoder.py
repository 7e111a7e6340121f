"""The port's VAE (ldm_tpu_torch/models/autoencoder.py), its losses and
trainer (training/autoencoder_trainer.py) and ``python -m
ldm_tpu_torch.train_autoencoder``, held against the JAX package's
(ldm_tpu/models/autoencoder.py, training/autoencoder_trainer.py) with the
same weights (``autoencoder_from_flax``), inputs and draws; fp32, a tiny VAE
(channels 8, multipliers [1, 2], 16px)."""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.config import Config as JaxConfig
from ldm_tpu.models import autoencoder as fa
from ldm_tpu.training import autoencoder_trainer as jt
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu.utils.torch_export import autoencoder_state_dict_from_params
from ldm_tpu_torch import train_autoencoder
from ldm_tpu_torch.config import Config, DataConfig, ModelConfig
from ldm_tpu_torch.models import autoencoder as pa
from ldm_tpu_torch.training import autoencoder_trainer as pt
from ldm_tpu_torch.utils.flax_import import _put_vae_attn, autoencoder_from_flax

from _flax_params import random_params

SIZE, B, LR = 16, 4, 5e-4
VAE = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
           n_resnet_blocks=1, z_channels=4)
MODULE_ATOL = 2e-5   # the JAX suite's tolerances: a module's output (x its scale),
LOSS_RTOL = 1e-5     # a step's loss,
GRAD_TOL = 1e-4      # a gradient (x its leaf's max)
FN_RTOL = 1e-6       # the loss functions on the same inputs


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(seed, *shape, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def vae():
    """The flax VAE, its params (numpy draws) and the port's VAE loaded
    from them."""
    flax_model = fa.Autoencoder(**VAE)
    params = random_params(flax_model, jnp.zeros((1, SIZE, SIZE, 3)), jax.random.key(1))
    model = pa.Autoencoder(**VAE).eval()
    model.load_state_dict(autoencoder_from_flax(params, VAE["n_resnet_blocks"]), strict=True)
    return flax_model, params, model


@pytest.fixture(scope="module")
def jax_step(vae):
    """The JAX trainer's loss (``AutoencoderTrainer._loss``) and its grads
    for both ELBOs at one state, batch and key, in one jitted program; and
    the state after Adam."""
    flax_model, params, _ = vae
    image = np.random.default_rng(8).uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    state = JaxState.create(params, make_optimizer(LR), jax.random.key(9))
    key = state.step_key()

    def both(state, image):
        out = {}
        for loss_fn in ("elbo_mse", "elbo"):
            fake = types.SimpleNamespace(model=flax_model, config=JaxConfig(loss_fn=loss_fn))
            (_, metrics), grads = jax.value_and_grad(
                lambda p: jt.AutoencoderTrainer._loss(fake, p, key, image), has_aux=True,
            )(state.params)
            out[loss_fn] = (metrics, grads, state.apply_gradients(grads).params)
        return out

    out = jax.jit(both)(state, jnp.asarray(image))
    eps = np.array(jax.random.normal(key, (B, 8, 8, 4), jnp.float32))
    return image, eps, jax.device_get(out)


def close(got, want, atol=MODULE_ATOL):
    """|got - want| <= atol x max|want|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol * max(np.abs(want).max(), 1.0))


def test_forward_matches_jax(vae):
    """``forward(img, eps)`` with JAX's latent draw: recon, mu, log_var."""
    flax_model, params, model = vae
    x = np.random.default_rng(1).uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    key = jax.random.key(2)
    want = jax.jit(flax_model.apply)(params, jnp.asarray(x), key)
    eps = np.array(jax.random.normal(key, want[1].shape, jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(eps))
    assert got[0].shape == (B, SIZE, SIZE, 3) and got[1].shape == (B, 8, 8, 4)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        close(g.numpy(), w)


def test_encode_moments_and_decode_match_jax(vae):
    flax_model, params, model = vae
    x = rand(3, B, SIZE, SIZE, 3)
    z = rand(4, B, 8, 8, 4)
    with torch.no_grad():
        moments = model.encode_moments(torch.from_numpy(x))
        decoded = model.decode(torch.from_numpy(z))
    for got, arg, method in ((moments, x, "encode_moments"), (decoded, z, "decode")):
        fn = jax.jit(lambda p, a, method=method: flax_model.apply(p, a, method=method))
        close(got.numpy(), fn(params, jnp.asarray(arg)))
    mu, log_var = pa.Autoencoder.moments_split(moments)
    want_mu, want_lv = fa.Autoencoder.moments_split(jnp.asarray(moments.numpy()))
    np.testing.assert_array_equal(mu.numpy(), np.asarray(want_mu))
    np.testing.assert_array_equal(log_var.numpy(), np.asarray(want_lv))


def test_sample_latent_is_the_reparameterisation():
    moments = torch.cat([torch.ones(1, 2, 2, 3), torch.full((1, 2, 2, 3), -20.0)], dim=-1)
    z = pa.Autoencoder.sample_latent(moments, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(z.numpy(), 1.0, atol=1e-3)
    # with JAX's draw, the JAX function's z
    moments = rand(6, 1, 2, 2, 6)
    key = jax.random.key(3)
    want = fa.Autoencoder.sample_latent(jnp.asarray(moments), key)
    eps = np.array(jax.random.normal(key, (1, 2, 2, 3), jnp.float32))
    got = pa.Autoencoder.sample_latent(torch.from_numpy(moments), torch.from_numpy(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FN_RTOL)


@pytest.mark.parametrize("side,c", [(8, 8), (5, 16), (16, 3)])
def test_downsample_matches_flax(side, c):
    """The (0, 1, 0, 1) pad and the stride-2 conv, on even and odd sides."""
    mod = fa.DownSample(c)
    x = rand(side, 2, side, side, c)
    params = jax.device_get(mod.init(jax.random.key(side), jnp.asarray(x)))
    port = pa.DownSample(c)
    port.conv.weight.data = torch.from_numpy(np.transpose(
        np.asarray(params["params"]["Conv_0"]["kernel"]), (3, 2, 0, 1)).copy())
    port.conv.bias.data = torch.from_numpy(np.array(params["params"]["Conv_0"]["bias"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = mod.apply(params, jnp.asarray(x))
    assert got.shape == want.shape
    close(got.numpy(), want)


@pytest.mark.parametrize("side,c", [(4, 8), (3, 16)])
def test_upsample_matches_flax(side, c):
    """Nearest 2x (``jax.image.resize`` "nearest") and the conv."""
    mod = fa.UpSample(c)
    x = rand(side + c, 2, side, side, c)
    params = jax.device_get(mod.init(jax.random.key(side), jnp.asarray(x)))
    port = pa.UpSample(c)
    port.conv.weight.data = torch.from_numpy(np.transpose(
        np.asarray(params["params"]["Conv_0"]["kernel"]), (3, 2, 0, 1)).copy())
    port.conv.bias.data = torch.from_numpy(np.array(params["params"]["Conv_0"]["bias"]))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got.numpy(), mod.apply(params, jnp.asarray(x)))
    # the resize alone, exactly
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    up = torch.nn.functional.interpolate(xt, scale_factor=2.0, mode="nearest")
    want = jax.image.resize(jnp.asarray(x), (2, 2 * side, 2 * side, c), method="nearest")
    np.testing.assert_array_equal(up.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_attn_block_matches_flax():
    """The single-head attention over a 4x4 grid at C=32 (GroupNorm of 32)."""
    mod = fa.AttnBlock()
    x = rand(7, 2, 4, 4, 32)
    params = jax.device_get(mod.init(jax.random.key(7), jnp.asarray(x)))
    port = pa.AttnBlock(32)
    sd = {}
    _put_vae_attn(sd, "a", params["params"])
    port.load_state_dict({k[2:]: torch.from_numpy(np.array(v, np.float32))
                          for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got.numpy(), mod.apply(params, jnp.asarray(x)))


# ----------------------------------------------------------------- losses
def loss_inputs(seed, b, side):
    rng = np.random.default_rng(seed)
    recon = rng.standard_normal((b, side, side, 3)).astype(np.float32)
    target = rng.uniform(-1, 1, (b, side, side, 3)).astype(np.float32)
    mu = rng.standard_normal((b, side // 8, side // 8, 8)).astype(np.float32)
    lv = (0.5 * rng.standard_normal((b, side // 8, side // 8, 8))).astype(np.float32)
    return recon, target, mu, lv


def port_losses(recon, target, mu, lv):
    t = torch.from_numpy
    return [pt.kl_divergence(t(mu), t(lv)), pt.elbo_mse(t(recon), t(target), t(mu), t(lv)),
            pt.elbo_bce(t(recon), t((target + 1) / 2), t(mu), t(lv))]


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_match_jax(seed):
    """The KLD and both ELBOs on a B=4 16x16x3 batch against the JAX
    functions, fp32, rel 1e-6."""
    recon, target, mu, lv = loss_inputs(seed, 4, 16)
    j = jnp.asarray
    want = [jt.kl_divergence(j(mu), j(lv)), jt.elbo_mse(j(recon), j(target), j(mu), j(lv)),
            jt.elbo_bce(j(recon), j((target + 1) / 2), j(mu), j(lv))]
    for got, w in zip(port_losses(recon, target, mu, lv), want):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.item(), float(w), rtol=FN_RTOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_losses_at_the_flagship_batch_hold_the_float64_sums(seed):
    """At B=64 32x32x3 (196,608 terms, sums about 3e5) the fp32 sums within
    1e-6 of the float64 ones; the JAX CPU reduction itself lands up to 3.2e-6
    away, so against it the bound is 1e-5."""
    recon, target, mu, lv = loss_inputs(seed, 64, 32)
    x, m, v = recon.astype(np.float64), mu.astype(np.float64), lv.astype(np.float64)
    kld = -0.5 * np.sum(1 + v - m ** 2 - np.exp(v))
    t01 = (target.astype(np.float64) + 1) / 2
    exact = [kld, np.sum((x - target) ** 2) + kld,
             np.sum(np.maximum(x, 0) - x * t01 + np.log1p(np.exp(-np.abs(x)))) + kld]
    got = port_losses(recon, target, mu, lv)
    for g, e in zip(got, exact):
        np.testing.assert_allclose(g.item(), e, rtol=FN_RTOL)
    assert got[1].item() > 1e5
    j = jnp.asarray
    np.testing.assert_allclose(got[1].item(), float(jt.elbo_mse(j(recon), j(target), j(mu),
                                                                 j(lv))), rtol=1e-5)


def test_losses_reduce_in_fp32():
    """bf16 inputs are summed in fp32: the sum of 196,608 squared errors of
    1 is exact."""
    recon = torch.ones(64, 32, 32, 3, dtype=torch.bfloat16)
    zero = torch.zeros(64, 32, 32, 3, dtype=torch.bfloat16)
    mu = lv = torch.zeros(1, 1, 1, 1, dtype=torch.bfloat16)
    assert pt.elbo_mse(recon, zero, mu, lv).item() == 64 * 32 * 32 * 3


# ------------------------------------------------------------- the trainer
def config(tmp, loss_fn="elbo_mse", **kw):
    return Config(project_name="ae", workdir=str(tmp), type="autoencoder", batch_size=B,
                  use_amp=False, lr=LR, loss_fn=loss_fn, epochs=1,
                  model=ModelConfig(target="ldm_tpu.models.autoencoder.Autoencoder",
                                    params={**VAE, "channel_multipliers": [1, 2]}),
                  data=DataConfig(dataset="SYNTHETIC", image_size=SIZE, image_channels=3), **kw)


@pytest.mark.parametrize("loss_fn", ["elbo_mse", "elbo"])
def test_one_train_step_matches_jax(vae, jax_step, tmp_path, loss_fn):
    """One step from equal weights with JAX's latent draw: the loss (per
    sample), the KLD, every grad (1e-4 of its leaf's max) and the weights
    after Adam (about lr * sign(g): an entry whose grad is within noise of 0
    may land 2 lr away, every other one within 1e-6)."""
    _, params, _ = vae
    image, eps, out = jax_step
    metrics, grads, new_params = out[loss_fn]

    model = pa.Autoencoder(**VAE)
    model.load_state_dict(autoencoder_from_flax(params, 1), strict=True)
    trainer = pt.AutoencoderTrainer(config(tmp_path, loss_fn), model, None, None, device="cpu")
    m = trainer.train_step({"image": image, "label": np.zeros(B, np.int64)},
                           eps=torch.from_numpy(eps))
    np.testing.assert_allclose(m["loss"].item(), float(metrics["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(m["kld"].item(), float(metrics["kld"]), rtol=LOSS_RTOL)
    want_g = autoencoder_state_dict_from_params(grads, 1)
    want_p = autoencoder_state_dict_from_params(new_params, 1)
    floor = 1e-2 * max(float(np.abs(g).max()) for g in want_g.values())
    for name, p in trainer.model.named_parameters():
        g = np.asarray(want_g[name], np.float32)
        scale = max(float(np.abs(g).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), g, rtol=0, atol=GRAD_TOL * scale,
                                   err_msg=name)
        diff = np.abs(p.detach().numpy() - np.asarray(want_p[name], np.float32))
        assert diff.max() <= 2 * LR * (1 + 1e-6), name
        assert (diff[np.abs(g) > 1e-3 * scale] <= 1e-6).all(), name
    assert trainer.state.step == 1 and trainer.state.ema is None


def test_eval_step_and_reconstruct(vae, tmp_path):
    _, params, _ = vae
    model = pa.Autoencoder(**VAE)
    model.load_state_dict(autoencoder_from_flax(params, 1), strict=True)
    trainer = pt.AutoencoderTrainer(config(tmp_path), model, None, None, device="cpu")
    batch = {"image": np.random.default_rng(1).uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(
        np.float32), "label": np.zeros(B, np.int64)}
    a, b = trainer.eval_step(batch, 3), trainer.eval_step(batch, 3)
    assert a["loss"].item() == b["loss"].item() != trainer.eval_step(batch, 4)["loss"].item()
    recon = trainer.reconstruct(batch["image"])
    assert recon.shape == (B, SIZE, SIZE, 3) and recon.dtype == np.uint8
    assert trainer.latent_shape == (8, 8, 4)
    with pytest.raises(ValueError, match="elbo"):
        pt.AutoencoderTrainer(config(tmp_path, "mse"), model, None, None, device="cpu")


def test_train_autoencoder_main_end_to_end(tmp_path):
    """``python -m ldm_tpu_torch.train_autoencoder`` on the CPU: 2 epochs of
    the device-resident epoch path's CPU twin, finite falling losses, the
    weights (loadable strictly), the full state and a reconstruction grid."""
    import yaml

    raw = {"project_name": "ae_e2e", "workdir": str(tmp_path), "type": "autoencoder",
           "batch_size": 8, "epochs": 2, "use_amp": False, "lr": 1e-3, "seed": 0,
           "loss_fn": "elbo_mse", "checkpoint_every": 1,
           "model": {"target": "ldm_tpu.models.autoencoder.Autoencoder",
                     "params": {**VAE, "channel_multipliers": [1, 2]}},
           "data": {"dataset": "CIFAR10", "data_path": str(tmp_path / "none"),
                    "image_size": SIZE, "image_channels": 3, "synthetic_size": 100}}
    path = tmp_path / "ae.yaml"
    path.write_text(yaml.safe_dump(raw))
    res = train_autoencoder.main([str(path), "--device", "cpu"])
    hist = res.history
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    assert hist["train_loss"][1] < hist["train_loss"][0]
    assert res.trainer.epoch_scan is not None  # the loader allows the device-resident epoch
    d = res.trainer.config.checkpoints
    sd = torch.load(os.path.join(d, "autoencoder.pt"))
    pa.Autoencoder(**VAE).load_state_dict(sd, strict=True)
    assert os.path.exists(os.path.join(d, "autoencoder_state.pt"))
    assert os.path.exists(os.path.join(res.trainer.config.results, "reconstruction_step0.npy"))


def test_decoder_convs_probe_their_bf16_algorithm_outside_autograd():
    """Outside autograd a bf16 decoder convolution probes, once a shape,
    whether its algorithm gives an image the same output at another batch
    position; where it does not, it computes in fp32 on the bf16 input,
    weight and bias and rounds once; inside autograd, at B=1 and in fp32 it
    is the plain convolution.  The encoder's are plain."""
    torch.manual_seed(0)
    conv = pa.DecoderConv2d(16, 8, 3, padding=1)
    x = torch.randn(4, 16, 6, 6).to(torch.bfloat16)
    with torch.no_grad():
        plain = torch.nn.functional.conv2d(x, conv.weight.to(torch.bfloat16),
                                           conv.bias.to(torch.bfloat16), padding=1)
        fp32 = torch.nn.functional.conv2d(x.float(), conv.weight.to(torch.bfloat16).float(),
                                          conv.bias.to(torch.bfloat16).float(),
                                          padding=1).to(torch.bfloat16)
        got = conv(x)
        (key, verdict), = conv.position_independent.items()
        assert key == ((4, 16, 6, 6), False)
        assert torch.equal(got, plain if verdict else fp32)
        conv.position_independent[key] = False  # as the card's 8x8 512 -> 512 algorithm
        assert torch.equal(conv(x), fp32)
        conv.position_independent[key] = True
        assert torch.equal(conv(x), plain)
        assert torch.equal(conv(x[:1]), plain[:1]) and len(conv.position_independent) == 1
    tracked = conv(x)
    assert tracked.requires_grad and torch.equal(tracked.detach(), plain)
    np.testing.assert_allclose(fp32.float().numpy(), plain.float().numpy(), rtol=0,
                               atol=2 ** -7 * float(plain.float().abs().max()))
    ae = pa.Autoencoder(**VAE)
    assert all(type(m) is pa.DecoderConv2d for m in ae.decoder.modules()
               if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3))
    assert type(ae.post_quant_conv) is pa.DecoderConv2d
    assert not any(isinstance(m, pa.DecoderConv2d) for m in ae.encoder.modules())


def test_decoder_convs_pin_cudnn_flags_whatever_the_caller_set():
    """The probe and both convolutions run with no autotuning, cuDNN's
    deterministic algorithms and no TF32, whatever flags the caller set (a
    server keeps PyTorch's defaults, TF32 on; a trainer sets deterministic
    algorithms), and the caller's flags are back after each call."""
    torch.manual_seed(0)
    conv = pa.DecoderConv2d(8, 8, 3, padding=1)
    cudnn = torch.backends.cudnn

    def flags():
        return cudnn.enabled, cudnn.benchmark, cudnn.deterministic, cudnn.allow_tf32

    seen, inner = [], conv._conv_forward

    def spy(*args):
        seen.append(flags())
        return inner(*args)

    conv._conv_forward = spy
    x = torch.randn(4, 8, 5, 5).to(torch.bfloat16)
    for caller in ((False, True, False, True), (True, False, True, False)):
        seen.clear()
        conv.position_independent.clear()
        with cudnn.flags(*caller[:2], deterministic=caller[2], allow_tf32=caller[3]), \
                torch.no_grad():
            conv(x)  # the probe's two convolutions, then the verdict's
            (key,) = conv.position_independent
            conv.position_independent[key] = False
            conv(x)  # fp32 on the bf16 values
            assert flags() == caller
        assert seen == [(True, False, True, False)] * 4
        conv(x)  # inside autograd: the caller's flags
        assert seen[-1] == flags()
