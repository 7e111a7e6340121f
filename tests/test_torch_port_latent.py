"""Latent diffusion in the port (ldm_tpu_torch/models/latent.py,
training/latent_trainer.py, the latent hooks of the diffusion trainer,
``python -m ldm_tpu_torch.train_latent``, ``type: latent`` in generate and
serving, and the protocol's ``--generator-config``) held against the JAX
package's (ldm_tpu/models/latent.py, training/latent_trainer.py) with the
same weights (``unet_from_flax`` / ``autoencoder_from_flax``), inputs and
draws; fp32, a tiny VAE (channels 8, multipliers [1, 2]) under a one-level
latent UNet (channels 16) at 16px."""

import dataclasses
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ldm_tpu.config import Config as JaxConfig, DiffusionConfig as JaxDiffusionConfig
from ldm_tpu.models.autoencoder import Autoencoder as FlaxAE
from ldm_tpu.models.latent import (
    LatentDiffusionModel as JaxLDM,
    calibrate_latent_scaling as jax_calibrate,
)
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.training.diffusion_trainer import DiffusionTrainer as JaxTrainer
from ldm_tpu.training.latent_trainer import latent_shape_of as jax_latent_shape_of
from ldm_tpu.utils.torch_export import unet_state_dict_from_params
from ldm_tpu_torch import generate, main as port_main, train_autoencoder, train_latent
from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.autoencoder import Autoencoder
from ldm_tpu_torch.models.latent import LatentDiffusionModel, calibrate_latent_scaling
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.registry import instantiate_from_config
from ldm_tpu_torch.serving.builder import build_generation_service
from ldm_tpu_torch.training import latent_trainer as lt
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.utils.flax_import import autoencoder_from_flax, unet_from_flax

from _flax_params import random_params

SIZE, B, LR, T_STEPS, CFG = 16, 4, 5e-4, 10, 3.0
VAE = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
           n_resnet_blocks=1, z_channels=4)
LATENT = (8, 8, 4)
UNET = dict(in_channels=4, out_channels=4, channels=16, channel_multipliers=(1,),
            num_classes=10)
BETAS = (8.5e-4, 1.2e-2)
LOSS_RTOL, GRAD_TOL, TRAJ_ATOL, FN_RTOL = 1e-5, 1e-4, 1e-4, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    """The flax VAE and latent UNet with their params (numpy draws), and the
    port's twins loaded from them."""
    fae, funet = FlaxAE(**VAE), FlaxUNet(**UNET)
    ae_params = random_params(fae, jnp.zeros((1, SIZE, SIZE, 3)), jax.random.key(1))
    params = random_params(funet, jnp.zeros((1,) + LATENT), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1,), jnp.int32), seed=2)
    ae = Autoencoder(**VAE)
    ae.load_state_dict(autoencoder_from_flax(ae_params, 1), strict=True)
    unet = UNet(**UNET)
    unet.load_state_dict(unet_from_flax(params), strict=True)
    return fae, ae_params, funet, params, ae, unet


def images(seed, n=B):
    return np.random.default_rng(seed).uniform(-1, 1, (n, SIZE, SIZE, 3)).astype(np.float32)


# ------------------------------------------------------------ the pieces
def test_sqrt_linear_schedule_at_t1000_is_the_jax_one():
    want = JaxLDM(None, None, 1.0, 1000, *BETAS).diffusion.schedule
    got = LatentDiffusionModel(UNet(**UNET), Autoencoder(**VAE), 1.0, 1000, *BETAS).diffusion
    for name in ("betas", "alphas", "alpha_bars", "sigma2"):
        np.testing.assert_array_equal(getattr(got.schedule, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    expected = np.linspace(BETAS[0] ** 0.5, BETAS[1] ** 0.5, 1000, dtype=np.float64) ** 2
    np.testing.assert_array_equal(got.schedule.betas.numpy(), expected.astype(np.float32))


@pytest.mark.parametrize("mults,z,size", [((1, 2), 4, 16), ((1, 2, 4, 8), 8, 32), ((1,), 3, 8)])
def test_latent_shape_of_is_the_jax_one(mults, z, size):
    kw = dict(channels=8, channel_multipliers=mults, z_channels=z)
    assert lt.latent_shape_of(Autoencoder(**kw), size) == jax_latent_shape_of(FlaxAE(**kw), size)


def test_calibrate_latent_scaling_matches_jax(models):
    """1 / the population std of the sampled latents, with JAX's draw, rel
    1e-6; torch's default (unbiased) std would be off by far more at B=4."""
    fae, ae_params, _, _, ae, _ = models
    x = images(1)
    key = jax.random.key(42)
    want = jax_calibrate(fae, ae_params, jnp.asarray(x), key)
    eps = np.array(jax.random.normal(key, (B,) + LATENT, jnp.float32))
    got = calibrate_latent_scaling(ae, torch.from_numpy(x), torch.from_numpy(eps))
    np.testing.assert_allclose(got, want, rtol=FN_RTOL)
    with torch.no_grad():
        z = ae.sample_latent(ae.encode_moments(torch.from_numpy(x)), torch.from_numpy(eps))
    unbiased = float(1.0 / z.std())
    assert abs(unbiased - want) > 100 * FN_RTOL * want


def test_resolve_persist_and_load_the_scaling(models, tmp_path):
    """A number passes through; ``auto`` calibrates on the first 512
    transformed training images with the seed's CPU draw, the trainer
    writes it, and ``load_latent_scaling`` reads it back."""
    from ldm_tpu_torch.data.datasets import synthetic_dataset
    from ldm_tpu_torch.data.loader import DataLoader

    ae = models[4]
    loader = DataLoader(synthetic_dataset(40, SIZE, 3), 8, seed=0)
    cfg = latent_config(tmp_path, latent_scaling_factor=0.5)
    assert lt.resolve_latent_scaling(cfg, ae, loader) == 0.5 == lt.load_latent_scaling(cfg)
    cfg = latent_config(tmp_path, latent_scaling_factor="auto")
    a = lt.resolve_latent_scaling(cfg, ae, loader)
    imgs = torch.from_numpy(loader.transform(loader.dataset.images[:512]))
    eps = torch.randn((40,) + LATENT, generator=torch.Generator().manual_seed(cfg.seed))
    assert a == calibrate_latent_scaling(ae, imgs, eps) == lt.resolve_latent_scaling(cfg, ae,
                                                                                     loader)
    with pytest.raises(FileNotFoundError, match="latent_scaling.json"):
        lt.load_latent_scaling(cfg)
    lt._persist_latent_scaling(cfg, a)
    assert lt.load_latent_scaling(cfg) == a
    with open(os.path.join(cfg.checkpoints, "latent_scaling.json")) as f:
        assert json.load(f) == {"latent_scaling_factor": a}


def test_first_stage_path_and_registry():
    assert lt.first_stage_path("runs/a/autoencoder.msgpack") == "runs/a/autoencoder.pt"
    assert lt.first_stage_path("runs/a/ae.pt") == "runs/a/ae.pt"
    for target in ("ldm_tpu.models.autoencoder.Autoencoder", "src.Autoencoder.Autoencoder"):
        ae = instantiate_from_config({"target": target, "params": VAE})
        assert isinstance(ae, Autoencoder)
    ldm = instantiate_from_config({"target": "src.LatentDiffusionModel.LatentDiffusionModel",
                                   "params": dict(eps_model=UNet(**UNET),
                                                  autoencoder=Autoencoder(**VAE),
                                                  latent_scaling_factor=1.0, n_steps=10,
                                                  linear_start=BETAS[0],
                                                  linear_end=BETAS[1])})
    assert isinstance(ldm, LatentDiffusionModel)


# ------------------------------------------------------------ the trainer
def latent_config(tmp, **diffusion):
    return Config(
        project_name="ldm", workdir=str(tmp), type="latent", batch_size=B, use_amp=False,
        lr=LR, epochs=1,
        model=ModelConfig(params={**UNET, "channel_multipliers": [1]}),
        autoencoder=ModelConfig(target="ldm_tpu.models.autoencoder.Autoencoder",
                                params={**VAE, "channel_multipliers": [1, 2]}),
        diffusion=DiffusionConfig(n_steps=T_STEPS, cfg_scale=CFG, schedule="sqrt_linear",
                                  beta_start=BETAS[0], beta_end=BETAS[1], **diffusion),
        data=DataConfig(dataset="SYNTHETIC", image_size=SIZE, image_channels=3))


def port_trainer(models, tmp, scale=0.7):
    _, _, _, params, ae, _ = models
    unet = UNet(**UNET)
    unet.load_state_dict(unet_from_flax(params), strict=True)
    cfg = latent_config(tmp, latent_scaling_factor=scale)
    ldm = lt.build_ldm(cfg, unet, ae, scale)
    return lt.LatentDiffusionTrainer(cfg, ldm, None, None, list(range(10)), device="cpu")


def test_one_latent_train_step_matches_jax(models, tmp_path):
    """The JAX step's parts (keys split into noise / drop / encode, the
    frozen encode, ``noise_batch``, the label drop, the eps-MSE's
    value_and_grad) against the port's step fed the same draws: the loss and
    every grad; the VAE is frozen and unchanged."""
    fae, ae_params, funet, params, ae, _ = models
    scale = 0.7
    ldm = JaxLDM(funet, fae, scale, T_STEPS, *BETAS)
    jcfg = JaxConfig(diffusion=JaxDiffusionConfig(label_drop_prob=0.5,
                                                  label_drop_mode="sample"))
    fake = types.SimpleNamespace(config=jcfg, model=types.SimpleNamespace(num_classes=10))
    image = images(3)
    label = np.array([1, 4, 7, 9], np.int32)
    key = jax.random.key(11)

    def step(p, image, label):
        k_noise, k_drop, k_enc = jax.random.split(key, 3)
        x0 = ldm.autoencoder_encode(ae_params, k_enc, image)
        eps, xt, t = ldm.diffusion.noise_batch(k_noise, x0)
        y = JaxTrainer._dropped_labels(fake, k_drop, label)
        loss, grads = jax.value_and_grad(
            lambda q: jnp.mean((eps - funet.apply(q, xt, t, y)) ** 2))(p)
        return loss, grads, eps, t, y, x0

    loss, grads, eps, t, y, x0 = jax.jit(step)(params, jnp.asarray(image), jnp.asarray(label))
    enc = np.array(jax.random.normal(jax.random.split(key, 3)[2], (B,) + LATENT, jnp.float32))

    trainer = port_trainer(models, tmp_path, scale)
    trainer.config = dataclasses.replace(
        trainer.config, diffusion=dataclasses.replace(trainer.config.diffusion,
                                                      label_drop_prob=0.5,
                                                      label_drop_mode="sample"))
    ae_before = {k: v.clone() for k, v in ae.state_dict().items()}
    with torch.no_grad():
        z = trainer._encode(torch.from_numpy(image), torch.from_numpy(enc))
    np.testing.assert_allclose(z.numpy(), np.asarray(x0), rtol=0,
                               atol=2e-5 * np.abs(np.asarray(x0)).max())
    m = trainer.train_step({"image": image, "label": label},
                           t=torch.from_numpy(np.array(t)).long(),
                           eps=torch.from_numpy(np.array(eps)),
                           drop=torch.from_numpy(np.asarray(y) == 10),
                           enc=torch.from_numpy(enc))
    np.testing.assert_allclose(m["loss"].item(), float(loss), rtol=LOSS_RTOL)
    want = {k: np.asarray(v, np.float32)
            for k, v in unet_state_dict_from_params(jax.device_get(grads)).items()}
    floor = 1e-2 * max(float(np.abs(g).max()) for g in want.values())
    for name, p in trainer.model.named_parameters():
        scale_ = max(float(np.abs(want[name]).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=GRAD_TOL * scale_,
                                   err_msg=name)
    assert all(torch.equal(v, ae_before[k]) for k, v in ae.state_dict().items())
    assert not any(p.requires_grad for p in ae.parameters())
    assert trainer.image_shape == LATENT and trainer.output_image_shape == (SIZE, SIZE, 3)


def test_latent_sample_and_decode_match_jax(models):
    """``sample_images``: the ancestral CFG trajectory (T=10, B=2) over the
    latents from JAX's x_T and per-step noise, then the decode."""
    fae, ae_params, funet, params, ae, unet = models
    scale = 0.7
    jldm = JaxLDM(funet, fae, scale, T_STEPS, *BETAS)
    classes = np.array([3, 8], np.int32)
    key = jax.random.key(4)
    want = jax.jit(lambda p, ap, k, y: jldm.sample_images(p, ap, k, y, LATENT, CFG))(
        params, ae_params, key, jnp.asarray(classes))
    k_lat, _ = jax.random.split(key)
    key_init, key_loop = jax.random.split(k_lat)
    x_init = np.array(jax.random.normal(key_init, (2,) + LATENT, jnp.float32))

    def noise(t):
        return torch.from_numpy(np.array(
            jax.random.normal(jax.random.fold_in(key_loop, t), (2,) + LATENT, jnp.float32)))

    ldm = LatentDiffusionModel(unet.eval(), ae, scale, T_STEPS, *BETAS)
    got = ldm.sample_images(torch.from_numpy(classes).long(), LATENT, CFG,
                            x_init=torch.from_numpy(x_init), noise=noise)
    assert got.shape == (2, SIZE, SIZE, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TRAJ_ATOL)


def test_decode_scale_override_is_the_negative_control(models, tmp_path):
    """``sample(decode_scale_override=s)`` decodes z0 / s: at the model's own
    scale bit-identical to the plain path, at another scale other images;
    the pixel trainer ignores it."""
    trainer = port_trainer(models, tmp_path)
    gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
    normal = trainer.sample([0, 1], cfg_scale=CFG, generator=gen())
    assert normal.shape == (2, SIZE, SIZE, 3) and normal.dtype == np.uint8
    same = trainer.sample([0, 1], cfg_scale=CFG, generator=gen(), decode_scale_override=0.7)
    np.testing.assert_array_equal(normal, same)
    broken = trainer.sample([0, 1], cfg_scale=CFG, generator=gen(),
                            decode_scale_override=0.18215)
    assert not np.array_equal(normal, broken)
    ddim = trainer.sample([0, 1], cfg_scale=CFG, generator=gen(), method="ddim", ddim_steps=3)
    assert ddim.shape == (2, SIZE, SIZE, 3)

    pix_cfg = Config(project_name="pix", workdir=str(tmp_path), batch_size=B, use_amp=False,
                     model=ModelConfig(params=dict(in_channels=3, out_channels=3, channels=8,
                                                   channel_multipliers=[1, 2],
                                                   num_classes=10)),
                     diffusion=DiffusionConfig(n_steps=T_STEPS),
                     data=DataConfig(dataset="SYNTHETIC", image_size=8, image_channels=3))
    pix = DiffusionTrainer(pix_cfg, UNet(3, 3, 8, (1, 2), num_classes=10),
                           GaussianDiffusion(T_STEPS), None, None, list(range(10)), device="cpu")
    a = pix.sample([0, 1], cfg_scale=CFG, generator=gen())
    b = pix.sample([0, 1], cfg_scale=CFG, generator=gen(), decode_scale_override=0.18215)
    np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ end to end
def write(path, raw):
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_autoencoder_then_latent_then_generate_and_serve(tmp_path):
    """``train_autoencoder`` -> ``train_latent`` (its ``ae_checkpoint`` names
    the ``.msgpack`` of the JAX run; the ``.pt`` of the same stem is read)
    -> ``generate`` and a ``type: latent`` service, on the CPU."""
    data = {"dataset": "CIFAR10", "data_path": str(tmp_path / "none"), "image_size": SIZE,
            "image_channels": 3, "synthetic_size": 100}
    ae_block = {"target": "ldm_tpu.models.autoencoder.Autoencoder",
                "params": {**VAE, "channel_multipliers": [1, 2]}}
    ae_path = write(tmp_path / "ae.yaml", {
        "project_name": "ae", "workdir": str(tmp_path), "type": "autoencoder",
        "batch_size": 8, "epochs": 1, "use_amp": False, "loss_fn": "elbo_mse",
        "model": ae_block, "data": data})
    ae_run = train_autoencoder.main([ae_path, "--device", "cpu"])
    ae_ckpt = os.path.join(ae_run.trainer.config.checkpoints, "autoencoder.msgpack")
    ldm_path = write(tmp_path / "ldm.yaml", {
        "project_name": "ldm", "workdir": str(tmp_path), "type": "latent", "batch_size": 8,
        "epochs": 2, "use_amp": False, "sample_every": 1, "ae_checkpoint": ae_ckpt,
        "diffusion": {"type": "latent", "cfg_scale": CFG, "schedule": "sqrt_linear",
                      "beta_start": BETAS[0], "beta_end": BETAS[1],
                      "latent_scaling_factor": "auto", "params": {"n_steps": T_STEPS}},
        "autoencoder": ae_block, "model": {"params": {**UNET, "channel_multipliers": [1]}},
        "data": data})
    run = train_latent.main([ldm_path, "--device", "cpu"])
    tr = run.trainer
    assert np.isfinite(run.history["train_loss"]).all() and tr.state.step == 2 * 11
    assert tr.epoch_scan is not None and tr.image_shape == LATENT
    trained_ae = Autoencoder(**VAE)
    trained_ae.load_state_dict(torch.load(lt.first_stage_path(ae_ckpt)), strict=True)
    assert all(torch.equal(v, trained_ae.state_dict()[k])
               for k, v in tr.ldm.autoencoder.state_dict().items())
    factor = lt.load_latent_scaling(tr.config)
    assert factor == tr.ldm.latent_scaling_factor and factor > 0
    grid = np.load(os.path.join(tr.config.results, "sample_step1.npy"))
    assert grid.dtype == np.uint8 and grid.shape[-1] == 3

    weights = os.path.join(tr.config.checkpoints, "diffusion_model_ema.pt")
    g = generate.main([ldm_path, "--device", "cpu", "--weights", weights, "--sampler", "ddim",
                       "--ddim-steps", "4", "--out", str(tmp_path / "x.npy")])
    assert g.images.shape == (10, SIZE, SIZE, 3) and np.isfinite(g.x0).all()
    cfg = tr.config
    svc = build_generation_service(cfg, sampler="ddim", ddim_steps=4, batch_size=8,
                                   max_delay_s=0.05, device="cpu")
    assert svc.image_shape == LATENT and svc.out_shape == (SIZE, SIZE, 3)
    with svc:
        a = svc.submit([1, 2, 3], n=3, seed=5).result(timeout=120)
        b = svc.submit([1, 2, 3], n=3, seed=5).result(timeout=120)
    assert a.shape == (3, SIZE, SIZE, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    bad = dataclasses.replace(cfg, ae_checkpoint=str(tmp_path / "missing.msgpack"))
    with pytest.raises(FileNotFoundError, match="missing.pt"):
        build_generation_service(bad, device="cpu")


def test_protocol_with_the_latent_generator(tmp_path, monkeypatch):
    """The protocol with ``generator_config`` on the CPU (the tiny
    classifier): the latent family takes Phases A and C (a random frozen
    first stage: no ae_checkpoint), the negative control decodes at 0.18215,
    every F1 and FID is finite; ``main --generator-config`` hands the config
    over, and a config of another type raises."""
    from ldm_tpu_torch.config import config_from_dict
    from ldm_tpu_torch.experiments import augmentation as aug

    data = {"dataset": "SYNTHETIC", "image_size": 8, "image_channels": 1,
            "synthetic_size": 320}
    raw = {"project_name": "tiny_latent_proto", "workdir": str(tmp_path), "batch_size": 16,
           "epochs": 1, "use_amp": False, "seed": 0, "sample_every": 0,
           "diffusion": {"cfg_scale": CFG, "params": {"n_steps": T_STEPS}},
           "model": {"params": {"in_channels": 1, "out_channels": 1, "channels": 8,
                                "channel_multipliers": [1, 2], "num_classes": 10}},
           "data": data}
    proto = write(tmp_path / "p.yaml", raw)
    gen = write(tmp_path / "g.yaml", {
        "project_name": "tiny_latent_gen", "workdir": str(tmp_path), "type": "latent",
        "batch_size": 16, "epochs": 1, "use_amp": False, "seed": 0, "sample_every": 0,
        "diffusion": {"type": "latent", "cfg_scale": CFG, "schedule": "sqrt_linear",
                      "beta_start": BETAS[0], "beta_end": BETAS[1],
                      "latent_scaling_factor": "auto", "params": {"n_steps": T_STEPS}},
        "autoencoder": {"target": "ldm_tpu.models.autoencoder.Autoencoder",
                        "params": {**VAE, "in_channels": 1, "out_channels": 1,
                                   "channel_multipliers": [1, 2]}},
        "model": {"params": {**UNET, "channel_multipliers": [1]}}, "data": data})
    res = aug.run_augmentation_experiment(
        config_from_dict(raw), n_per_class=3, sample_batch=16, classifier_epochs=1,
        classifier_arch=dict(n_blocks=(1, 1), n_channels=(8, 16)), negative_control=True,
        generator_config=gen, device="cpu")
    dt = res.diffusion_trainer
    assert isinstance(dt, lt.LatentDiffusionTrainer) and dt.image_shape == (4, 4, 4)
    assert aug.negative_control_break(dt, CFG, "ddpm", 50)["decode_scale_override"] == 0.18215
    assert res.synthetic.images.shape == (30, 8, 8, 1)
    for v in (res.fid_pixel, res.fid_classifier, res.fid_pixel_broken,
              res.fid_classifier_broken, *res.test_f1.values()):
        assert v is not None and np.isfinite(v)
    assert set(res.test_f1) == {"exp1", "exp2", "exp3", "exp4", "exp5", "exp2_broken"}
    assert os.path.exists(os.path.join(dt.config.checkpoints, "latent_scaling.json"))
    assert res.launches["A"] == {"linear_attention_fwd": 0, "linear_attention_bwd": 0,
                                 "resnet_block_fwd": 0, "fused_adam_ema": 0,
                                 "group_norm_silu": 0}  # the CPU runs the plain versions
    with pytest.raises(ValueError, match="latent config"):
        port_main.main([proto, "--generator-config", proto, "--device", "cpu"])
    seen = {}
    monkeypatch.setattr(port_main, "run_augmentation_experiment",
                        lambda config, **kw: seen.update(kw) or res)
    port_main.main([proto, "--generator-config", gen, "--device", "cpu", "--negative-control"])
    assert seen["generator_config"] == gen and seen["negative_control"]
