"""The port's last public names held against the JAX package's:
``RectifiedFlow.sample_euler`` / ``sample_heun`` (ldm_tpu/diffusion/flow.py),
``LatentDiffusionModel.apply_eps`` (ldm_tpu/models/latent.py), ``--cpu`` and
``--wandb`` on every entry point as the JAX scripts take them
(ldm_tpu/utils/cli.py, scripts/*.py), and ``python -m ldm_tpu_torch.train
--cpu --wandb`` handing its losses to a recording wandb module."""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ldm_tpu.diffusion.flow import RectifiedFlow as JaxFlow
from ldm_tpu.models.latent import LatentDiffusionModel as JaxLDM
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu_torch import (
    distill,
    export_torch_checkpoint,
    generate,
    import_torch_checkpoint,
    main as port_main,
    serve,
    train,
    train_autoencoder,
    train_classifier,
    train_latent,
)
from ldm_tpu_torch.config import config_from_dict
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.models.autoencoder import Autoencoder
from ldm_tpu_torch.models.latent import LatentDiffusionModel
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.utils import cli
from ldm_tpu_torch.utils.flax_import import unet_from_flax
from ldm_tpu_torch.utils.logging import MetricsLogger

from _flax_params import random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (16, 16, 3)
MODEL = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
             num_classes=10)
NULL = 10
TOL = 2e-5  # of max|x0|: the module tolerance, tests/test_torch_parity.py:31
STEPS = 4


@pytest.fixture(scope="module")
def pair():
    """A flax UNet at channels 8 with numpy-drawn params and the port's
    UNet loaded from them."""
    flax_model = FlaxUNet(**MODEL)
    params = random_params(flax_model, jnp.zeros((1,) + SHAPE), jnp.zeros((1,), jnp.int32),
                           jnp.zeros((1,), jnp.int32), seed=3)
    model = UNet(**MODEL).eval()
    model.load_state_dict(unet_from_flax(params), strict=True)
    return flax_model, params, model


@pytest.mark.parametrize("method", ["sample_euler", "sample_heun"])
def test_flow_sampler_aliases_match_jax(pair, method):
    """4 steps at 16 px, CFG 3, fp32, from one injected x_T: the port's
    alias against the JAX alias, and bit for bit the port's own slot."""
    flax_model, params, model = pair
    classes = np.array([2, 7], np.int32)
    x_init = np.random.default_rng(4).standard_normal((2,) + SHAPE).astype(np.float32)
    want = np.asarray(jax.jit(lambda p: getattr(JaxFlow(n_steps=400), method)(
        flax_model.apply, p, jax.random.key(0), jnp.asarray(classes), SHAPE,
        n_sample_steps=STEPS, cfg_scale=3.0, null_label=NULL,
        x_init=jnp.asarray(x_init)))(params))
    flow = RectifiedFlow(n_steps=400)
    kw = dict(n_sample_steps=STEPS, cfg_scale=3.0, null_label=NULL,
              x_init=torch.from_numpy(x_init))
    y = torch.from_numpy(classes).long()
    got = getattr(flow, method)(model, y, SHAPE, **kw)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= TOL * float(np.abs(want).max()), err
    assert float(np.abs(want - x_init).max()) > 1e-2  # it moved
    slot = flow.sample_ddim if method == "sample_euler" else flow.sample_dpmpp
    assert torch.equal(got, slot(model, y, SHAPE, **kw))


def test_apply_eps_matches_jax(pair):
    """The latent eps model's forward on carried weights, fp32: 2e-5."""
    flax_model, params, model = pair
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3,) + SHAPE).astype(np.float32)
    t = np.array([0, 17, 399], np.int32)
    y = np.array([1, NULL, 4], np.int32)
    jax_ldm = JaxLDM(flax_model, None, 0.5, 400, 8.5e-4, 1.2e-2)
    want = np.asarray(jax.jit(jax_ldm.apply_eps)(params, jnp.asarray(x), jnp.asarray(t),
                                                 jnp.asarray(y)))
    ae = Autoencoder(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1,),
                     n_resnet_blocks=1, z_channels=3)
    ldm = LatentDiffusionModel(model, ae, 0.5, 400, 8.5e-4, 1.2e-2)
    with torch.no_grad():
        got = ldm.apply_eps(torch.from_numpy(x), torch.from_numpy(t).long(),
                            torch.from_numpy(y).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def tiny_raw(workdir):
    return {"project_name": "tiny", "workdir": str(workdir), "batch_size": 16, "epochs": 1,
            "use_amp": False, "seed": 0, "sample_every": 0,
            "diffusion": {"n_steps": 10},
            "model": {"params": {"in_channels": 1, "out_channels": 1, "channels": 8,
                                 "channel_multipliers": [1, 2], "num_classes": 10}},
            "data": {"dataset": "SYNTHETIC", "image_channels": 1, "image_size": 16,
                     "synthetic_size": 320}}


# each entry point and its positional arguments; the first six take the
# runtime flags (``--wandb`` with them), the last four ``--cpu`` alone, as
# their JAX twins do (scripts/{generate_images,serve,export_torch_checkpoint,
# import_torch_checkpoint}.py)
ENTRY_POINTS = [(train, ["c.yaml"]), (train_classifier, ["c.yaml"]),
                (train_autoencoder, ["c.yaml"]), (train_latent, ["c.yaml"]),
                (distill, ["c.yaml"]), (port_main, ["c.yaml"]),
                (generate, ["c.yaml"]), (serve, ["c.yaml"]),
                (export_torch_checkpoint, ["c.yaml"]),
                (import_torch_checkpoint, ["ref.pt", "c.yaml"])]
RUNTIME = {train, train_classifier, train_autoencoder, train_latent, distill, port_main}


@pytest.mark.parametrize("module,positional", ENTRY_POINTS,
                         ids=[m.__name__.rsplit(".", 1)[1] for m, _ in ENTRY_POINTS])
def test_entry_point_takes_cpu_and_wandb(module, positional, tmp_path, monkeypatch):
    """``--cpu`` is ``--device cpu``, the default stays the card, ``--cpu``
    with ``--device`` is an argparse error; under ``--wandb`` the runtime
    hands a logger that mirrors to wandb, of the config's run directory and
    project."""
    assert module.parse_args(positional).device == "cuda"
    args = module.parse_args(positional + ["--cpu"])
    assert torch.device(args.device) == torch.device("cpu")
    with pytest.raises(SystemExit):
        module.parse_args(positional + ["--cpu", "--device", "cuda"])
    if module not in RUNTIME:
        with pytest.raises(SystemExit):
            module.parse_args(positional + ["--wandb"])
        return
    stub = types.ModuleType("wandb")
    stub.run, stub.init_calls = None, []
    stub.init = lambda **kw: stub.init_calls.append(kw) or object()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    config = config_from_dict(tiny_raw(tmp_path))
    assert cli.runtime_setup(args, config) == (torch.device("cpu"), None, None)
    rt = cli.runtime_setup(module.parse_args(positional + ["--cpu", "--wandb"]), config)
    assert rt.device == torch.device("cpu") and rt.mesh is None
    assert isinstance(rt.logger, MetricsLogger) and rt.logger._wandb is stub
    assert stub.init_calls == [{"project": "tiny", "mode": "offline"}]
    assert rt.logger._path == os.path.join(config.dirpath, "metrics.jsonl")


WANDB_STUB = '''"""A recording stand-in for wandb: each call one JSON line in $WANDB_STUB_OUT."""
import json
import os

run = None


def _record(**kw):
    with open(os.environ["WANDB_STUB_OUT"], "a") as f:
        f.write(json.dumps(kw) + "\\n")


def init(**kw):
    global run
    run = object()
    _record(call="init", **kw)
    return run


def log(metrics, step=None):
    _record(call="log", metrics={k: v for k, v in metrics.items()
                                 if isinstance(v, (int, float, str))}, step=step)


def define_metric(key, summary=None):
    _record(call="define_metric", key=key, summary=summary)
'''


def test_train_module_hands_its_losses_to_wandb(tmp_path):
    """``python -m ldm_tpu_torch.train <tiny.yaml> --cpu --wandb`` for one
    epoch with a recording ``wandb`` module on the path: one offline
    ``init`` with the config's project, the summary rules, and each epoch's
    losses at its step, equal to the run's ``metrics.jsonl``."""
    stubs = tmp_path / "stubs"
    stubs.mkdir()
    (stubs / "wandb.py").write_text(WANDB_STUB)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(tiny_raw(tmp_path / "runs")))
    out = tmp_path / "wandb_calls.jsonl"
    env = dict(os.environ, OMP_NUM_THREADS="1", WANDB_STUB_OUT=str(out),
               PYTHONPATH=os.pathsep.join([str(stubs), ROOT]))
    env.pop("WANDB_MODE", None)
    r = subprocess.run([sys.executable, "-m", "ldm_tpu_torch.train", str(path), "--cpu",
                        "--wandb"], cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    calls = [json.loads(line) for line in out.read_text().splitlines()]
    assert [c for c in calls if c["call"] == "init"] == [
        {"call": "init", "project": "tiny", "mode": "offline"}]
    assert {(c["key"], c["summary"]) for c in calls if c["call"] == "define_metric"} == {
        ("diffusion_model train_loss", "min"), ("diffusion_model val_loss", "min")}
    logged = [(c["step"], c["metrics"]) for c in calls if c["call"] == "log"]
    run_dir = tmp_path / "runs" / "pixel" / "tiny"
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    want = [(rec["step"], {k: v for k, v in rec.items() if k not in ("step", "ts")})
            for rec in recs]
    assert logged == want
    losses = [(s, m["diffusion_model train_loss"]) for s, m in logged
              if "diffusion_model train_loss" in m]
    assert [s for s, _ in losses] == [0] and np.isfinite(losses[0][1])


def test_wandb_is_imported_only_by_a_logger_that_asks(tmp_path):
    """Every module of the port and ``chip_smoke.py`` imported with an
    importable ``wandb`` on the path leave it unimported; a logger without
    ``use_wandb`` too; one with it imports it."""
    (tmp_path / "wandb.py").write_text("run = None\n"
                                       "def init(**kw):\n    global run\n    run = kw\n")
    code = (
        "import importlib, pkgutil, sys\n"
        "import ldm_tpu_torch\n"
        "for m in pkgutil.walk_packages(ldm_tpu_torch.__path__, 'ldm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert 'wandb' not in sys.modules\n"
        "from ldm_tpu_torch.utils.logging import MetricsLogger\n"
        "MetricsLogger(None, 'p')\n"
        "assert 'wandb' not in sys.modules\n"
        "MetricsLogger(None, 'p', use_wandb=True)\n"
        "print(sys.modules['wandb'].run)\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), ROOT]),
               OMP_NUM_THREADS="1")
    env.pop("WANDB_MODE", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "{'project': 'p', 'mode': 'offline'}"
