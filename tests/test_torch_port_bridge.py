"""The checkpoint bridge both ways, held against the JAX package:
``python -m ldm_tpu_torch.import_torch_checkpoint`` on reference ``.pt``
files made by ``ldm_tpu.utils.torch_export`` from flax weights, and
``python -m ldm_tpu_torch.export_torch_checkpoint`` read back by
``ldm_tpu.utils.torch_import``; each side's forward against the other's at
the JAX suite's module tolerance, for the UNet, the VAE and the classifier;
the CLI cases of tests/test_torch_import.py on the port's entry points."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ldm_tpu.models import autoencoder as fa
from ldm_tpu.models.resnet import ResNetBase as FlaxResNet
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.utils import torch_export as te
from ldm_tpu.utils import torch_import as ti
from ldm_tpu_torch import export_torch_checkpoint, generate, import_torch_checkpoint
from ldm_tpu_torch.factory import build_classifier, build_model, load_config
from ldm_tpu_torch.models.autoencoder import Autoencoder
from ldm_tpu_torch.models.resnet import ResNetBase
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.training.checkpoint import save_state
from ldm_tpu_torch.training.state import TrainState

from _flax_params import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 2e-5  # the JAX suite's module tolerance (x the output's scale)
SIZE = 8
UNET = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=[1, 2],
            num_classes=10)
VAE = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=[1, 2],
           n_resnet_blocks=1, z_channels=4)
SMALL_RESNET = dict(img_channels=3, out_channels=10, n_blocks=(1, 1), n_channels=(8, 16))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_config(tmp_path, name="cfg", model=None, target=None, image_size=SIZE) -> str:
    raw = {"project_name": name, "workdir": str(tmp_path / name), "use_amp": False, "seed": 0,
           "diffusion": {"params": {"n_steps": 8}},
           "model": {"params": dict(model or UNET)},
           "data": {"dataset": "CIFAR10", "image_size": image_size, "image_channels": 3}}
    if target:
        raw["model"]["target"] = target
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=ATOL * max(np.abs(want).max(), 1.0))


def save_pt(sd, path) -> str:
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, str(path))
    return str(path)


def unet_inputs(seed=0, b=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, SIZE, SIZE, 3)).astype(np.float32),
            rng.integers(0, 8, b).astype(np.int32), rng.integers(0, 11, b).astype(np.int32))


def unet_forward(model, x, t, y):
    with torch.no_grad():
        return model.eval()(torch.from_numpy(x), torch.from_numpy(t).long(),
                            torch.from_numpy(y).long()).numpy()


def flax_unet(bte=True):
    m = FlaxUNet(bottleneck_time_emb=bte, **{**UNET, "channel_multipliers": (1, 2)})
    x = jnp.zeros((1, SIZE, SIZE, 3))
    return m, random_params(m, x, jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))


def flax_resnet(**kw):
    """A flax ResNet's variables with positive running variances."""
    m = FlaxResNet(**kw)
    v = random_params(m, jnp.zeros((1, SIZE, SIZE, kw.get("img_channels", 3))), seed=2)
    rng = np.random.default_rng(5)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda p, a: (rng.uniform(0.5, 1.5, a.shape) if str(p[-1].key) == "var"
                      else 0.2 * rng.standard_normal(a.shape)).astype(np.float32),
        v["batch_stats"])
    return m, v


# ------------------------------------------------- reference .pt -> the port
@pytest.mark.parametrize("bte", [True, False])
def test_import_reference_unet_matches_flax(tmp_path, bte):
    """A reference ``.pt`` from the JAX exporter, through the port's import
    CLI into the trainer-standard files: the port's forward equals flax's
    (with the bottleneck time-MLPs, or, without, the JAX import without
    them), and ``generate`` samples it with no further step."""
    m, params = flax_unet(bte=True)
    sd = te.unet_state_dict_from_params(params)
    pt = save_pt(sd, tmp_path / "ref.pt")
    cfg = write_config(tmp_path)
    out = import_torch_checkpoint.main([pt, cfg, "--device", "cpu",
                                        "--bottleneck-time-emb" if bte else
                                        "--no-bottleneck-time-emb"])
    config = load_config(cfg)
    assert out == os.path.join(config.checkpoints, "diffusion_model.pt")
    model = build_model(config)
    model.load_state_dict(torch.load(out, weights_only=True), strict=True)
    ema = torch.load(os.path.join(config.checkpoints, "diffusion_model_ema.pt"),
                     weights_only=True)
    assert all(torch.equal(ema[k], v) for k, v in model.state_dict().items())
    want_m, want_p = m, params
    if not bte:
        want_m = FlaxUNet(bottleneck_time_emb=False, **{**UNET, "channel_multipliers": (1, 2)})
        want_p = ti.unet_params_from_state_dict(sd, bottleneck_time_emb=False)
        assert not model.state_dict()["bottleneck.res1.mlp_t.1.weight"].any()
    x, t, y = unet_inputs()
    close(unet_forward(model, x, t, y), want_m.apply(want_p, x, t, y))
    g = generate.main([cfg, "--device", "cpu", "--sampler", "ddim", "--ddim-steps", "2",
                       "--out", str(tmp_path / "x.npy")])
    assert g.images.shape == (10, SIZE, SIZE, 3)


def test_import_reference_autoencoder_and_classifier_match_flax(tmp_path):
    """The VAE's encoder moments and decoder, and ResNet-18 (the
    classifier the config builds) in eval mode with its running
    statistics."""
    vm = fa.Autoencoder(**{**VAE, "channel_multipliers": (1, 2)})
    vp = random_params(vm, jnp.zeros((1, 16, 16, 3)), jax.random.key(1))
    pt = save_pt(te.autoencoder_state_dict_from_params(vp, 1), tmp_path / "vae.pt")
    cfg = write_config(tmp_path, "vae", VAE, "ldm_tpu.models.autoencoder.Autoencoder", 16)
    out = import_torch_checkpoint.main([pt, cfg, "--device", "cpu"])
    assert out.endswith("autoencoder.pt")
    vae = Autoencoder(**VAE).eval()
    vae.load_state_dict(torch.load(out, weights_only=True), strict=True)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    z = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(np.float32)
    with torch.no_grad():
        close(vae.encode_moments(torch.from_numpy(x)).numpy(),
              vm.apply(vp, jnp.asarray(x), method="encode_moments"))
        close(vae.decode(torch.from_numpy(z)).numpy(), vm.apply(vp, jnp.asarray(z),
                                                                 method="decode"))

    rm, rv = flax_resnet(img_channels=3, out_channels=10)
    pt = save_pt(te.resnet_state_dict_from_params(rv), tmp_path / "clf.pt")
    cfg = write_config(tmp_path, "clf")
    out = import_torch_checkpoint.main([pt, cfg, "--device", "cpu"])
    assert out == os.path.join(load_config(cfg).checkpoints, "classifier.pt")
    clf = build_classifier(load_config(cfg), 3, 10)
    clf.load_state_dict(torch.load(out, weights_only=True), strict=True)
    x = np.random.default_rng(3).uniform(-1, 1, (4, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        close(clf.eval()(torch.from_numpy(x)).numpy(),
              rm.apply(rv, jnp.asarray(x), train=False))


# ------------------------------------------------------ the port -> JAX
def test_export_unet_read_by_the_jax_importer(tmp_path):
    """The port's trainer-standard file and a full training state (``model``,
    or ``ema`` with ``--ema``), exported: the JAX importer's flax UNet
    computes what the port's does."""
    torch.manual_seed(0)
    model = UNet(**UNET).eval()
    state = TrainState(model, 1e-3, 0.99)
    with torch.no_grad():
        for p in state.ema.parameters():
            p.mul_(0.5)
    cfg = write_config(tmp_path)
    ck = load_config(cfg).checkpoints
    os.makedirs(ck)
    torch.save(model.state_dict(), os.path.join(ck, "diffusion_model.pt"))
    save_state(os.path.join(ck, "state.pt"), state.state_dict(), 1.0)
    m = FlaxUNet(**{**UNET, "channel_multipliers": (1, 2)})
    x, t, y = unet_inputs(seed=4)
    for args, source in (([cfg], model), ([os.path.join(ck, "state.pt"), cfg], model),
                         ([os.path.join(ck, "state.pt"), cfg, "--ema"], state.ema)):
        out = export_torch_checkpoint.main(args + ["--device", "cpu", "--out",
                                                   str(tmp_path / "out.pt")])
        sd = torch.load(out, weights_only=True)
        assert all(v.device.type == "cpu" and v.dtype == torch.float32 for v in sd.values())
        params = ti.unet_params_from_state_dict(sd, bottleneck_time_emb=True)
        close(unet_forward(source, x, t, y), m.apply(params, x, t, y))
    assert not np.allclose(unet_forward(model, x, t, y), unet_forward(state.ema, x, t, y))


def test_export_autoencoder_and_classifier_read_by_the_jax_importers(tmp_path):
    torch.manual_seed(1)
    vae = Autoencoder(**VAE).eval()
    cfg = write_config(tmp_path, "vae", VAE, "ldm_tpu.models.autoencoder.Autoencoder", 16)
    ck = load_config(cfg).checkpoints
    os.makedirs(ck)
    torch.save(vae.state_dict(), os.path.join(ck, "autoencoder.pt"))
    out = export_torch_checkpoint.main([cfg, "--device", "cpu"])
    assert out == os.path.join(ck, "autoencoder_reference.pt")
    vp = ti.autoencoder_params_from_state_dict(torch.load(out, weights_only=True))
    vm = fa.Autoencoder(**{**VAE, "channel_multipliers": (1, 2)})
    z = np.random.default_rng(2).standard_normal((2, 8, 8, 4)).astype(np.float32)
    x = np.random.default_rng(1).uniform(-1, 1, (2, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        close(vae.decode(torch.from_numpy(z)).numpy(), vm.apply(vp, jnp.asarray(z),
                                                                 method="decode"))
        close(vae.encode_moments(torch.from_numpy(x)).numpy(),
              vm.apply(vp, jnp.asarray(x), method="encode_moments"))

    clf = ResNetBase(**SMALL_RESNET)
    x = np.random.default_rng(3).uniform(-1, 1, (8, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        clf.train()(torch.from_numpy(x))  # running statistics moved off their init
    torch.save(clf.state_dict(), tmp_path / "resnet.pt")
    out = export_torch_checkpoint.main([str(tmp_path / "resnet.pt"), cfg, "--device", "cpu"])
    sd = torch.load(out, weights_only=True)
    assert sd["bn.num_batches_tracked"].dtype == torch.int64
    ResNetBase(**SMALL_RESNET).load_state_dict(sd, strict=True)
    variables = ti.resnet_params_from_state_dict(sd)
    with torch.no_grad():
        close(clf.eval()(torch.from_numpy(x)).numpy(),
              FlaxResNet(**SMALL_RESNET).apply(variables, jnp.asarray(x), train=False))


# ---------------------------------------- tests/test_torch_import.py's CLI cases
def test_cli_import_default_follows_model(tmp_path, capsys):
    """No --bottleneck-time-emb: the import follows the config's model (the
    fixed bottleneck, so the reference's untrained MLPs come along, with
    the JAX CLI's note)."""
    torch.manual_seed(0)
    ref = UNet(in_channels=1, out_channels=1, channels=8, channel_multipliers=[1, 2],
               num_classes=10)
    torch.save(ref.state_dict(), tmp_path / "ref.pt")
    out = tmp_path / "imported.pt"
    import_torch_checkpoint.main([str(tmp_path / "ref.pt"),
                                  os.path.join(ROOT, "configs/smoke_synthetic.yaml"),
                                  "--out", str(out), "--device", "cpu"])
    assert os.path.exists(out) and "never trains its bottleneck" in capsys.readouterr().out
    back = torch.load(out, weights_only=True)
    assert all(torch.equal(back[k], v) for k, v in ref.state_dict().items())


def test_cli_import_latent_space_unet(tmp_path):
    """A latent-space UNet's in_channels is the VAE's z_channels, which the
    config's model block carries."""
    torch.manual_seed(0)
    ref = UNet(in_channels=8, out_channels=8, channels=64, channel_multipliers=[1],
               num_classes=10)
    torch.save(ref.state_dict(), tmp_path / "latent_unet.pt")
    out = tmp_path / "imported.pt"
    import_torch_checkpoint.main([str(tmp_path / "latent_unet.pt"),
                                  os.path.join(ROOT, "configs/latent_diffusion_cifar10.yaml"),
                                  "--out", str(out), "--device", "cpu"])
    assert os.path.exists(out)


def test_cli_export_autodetects_classifier(tmp_path):
    """--kind auto reads the file's keys, whatever model the config builds."""
    rm, rv = flax_resnet(img_channels=1, out_channels=10, n_blocks=(1, 1),
                         n_channels=(8, 512))
    sd = te.resnet_state_dict_from_params(rv)
    pt = save_pt(sd, tmp_path / "classifier.pt")
    out = export_torch_checkpoint.main([pt, os.path.join(ROOT, "configs/smoke_synthetic.yaml"),
                                        "--out", str(tmp_path / "exported.pt"),
                                        "--device", "cpu"])
    back = {k: v.numpy() for k, v in torch.load(out, weights_only=True).items()}
    te.roundtrip_check(back, sd)


def test_bridge_errors_are_loud(tmp_path):
    torch.manual_seed(0)
    vae = Autoencoder(**VAE)
    torch.save(vae.state_dict(), tmp_path / "vae.pt")
    two = write_config(tmp_path, "vae2", {**VAE, "n_resnet_blocks": 2},
                       "ldm_tpu.models.autoencoder.Autoencoder", 16)
    with pytest.raises(ValueError, match="n_resnet_blocks"):
        export_torch_checkpoint.main([str(tmp_path / "vae.pt"), two, "--device", "cpu"])
    with pytest.raises(ValueError, match="not a unet"):
        export_torch_checkpoint.main([str(tmp_path / "vae.pt"), two, "--kind", "unet",
                                      "--device", "cpu"])
    save_state(str(tmp_path / "vae_state.pt"), TrainState(vae, 1e-3, ema=False).state_dict(), 1.0)
    with pytest.raises(ValueError, match="no EMA"):
        export_torch_checkpoint.main([str(tmp_path / "vae_state.pt"), two, "--ema",
                                      "--device", "cpu"])
    # the config's VAE has two blocks a level: every missing and extra key named
    with pytest.raises(ValueError, match=r"missing=\['decoder\.up\.0\.block\.2"):
        import_torch_checkpoint.main([str(tmp_path / "vae.pt"), two, "--device", "cpu"])
    wide = write_config(tmp_path, "wide", {**UNET, "channels": 16})
    torch.save(UNet(**UNET).state_dict(), tmp_path / "unet.pt")
    with pytest.raises(ValueError, match="shape mismatches"):
        import_torch_checkpoint.main([str(tmp_path / "unet.pt"), wide, "--device", "cpu"])
    torch.save({"foo.weight": torch.zeros(2)}, tmp_path / "odd.pt")
    with pytest.raises(ValueError, match="cannot detect checkpoint kind"):
        import_torch_checkpoint.main([str(tmp_path / "odd.pt"), wide, "--device", "cpu"])
    torch.save([torch.zeros(2)], tmp_path / "list.pt")
    with pytest.raises(SystemExit, match="not a state_dict"):
        import_torch_checkpoint.main([str(tmp_path / "list.pt"), wide, "--device", "cpu"])
    assert not os.path.exists(load_config(wide).checkpoints)


def test_cli_export_roundtrip(tmp_path):
    """Import, then export: the original reference tensors come back."""
    m, params = flax_unet(bte=True)
    sd = te.unet_state_dict_from_params(params)
    pt = save_pt(sd, tmp_path / "ref.pt")
    cfg = write_config(tmp_path)
    imported = import_torch_checkpoint.main([pt, cfg, "--out", str(tmp_path / "imp.pt"),
                                             "--bottleneck-time-emb", "--device", "cpu"])
    out = export_torch_checkpoint.main([imported, cfg, "--out", str(tmp_path / "exp.pt"),
                                        "--device", "cpu"])
    back = {k: v.numpy() for k, v in torch.load(out, weights_only=True).items()}
    te.roundtrip_check(back, sd)


@pytest.mark.parametrize("entry", ["import", "export"])
def test_cuda_without_a_card_raises(tmp_path, entry):
    """``--device cuda`` (the default) on a machine without a card fails; it
    never falls back to the CPU."""
    torch.save(UNet(**UNET).state_dict(), tmp_path / "unet.pt")
    cfg = write_config(tmp_path)
    main = {"import": import_torch_checkpoint.main, "export": export_torch_checkpoint.main}
    with pytest.raises((RuntimeError, AssertionError)):
        main[entry]([str(tmp_path / "unet.pt"), cfg])
