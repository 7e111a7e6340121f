"""Explicit spatial parallelism of the port (``parallel/sp_explicit.py``)
across real processes on the CPU, held against the JAX package's
``make_unet_sp_apply`` and against one process of the port.

* The explicit forward and gradients over a (data=1, model=2) gloo group,
  from flax weights through ``utils/flax_import.py``, against JAX's explicit
  SP on the (4, 2) CPU mesh at JAX's own bars (``tests/test_sp_explicit.py``:
  forward rtol 1e-4 / atol 2e-6, gradients rtol 2e-4 / atol 1e-6); the
  UNet is ``test_sp_explicit.py::_setup``'s (B=8, 8 px, channels 8,
  multipliers (1, 2)).
* ``activation_sharding: spatial`` through ``DiffusionTrainer.train()`` over
  (1, 2) and (2, 2) against one process (losses rtol 1e-5, parameters atol
  5e-3: the JAX bars; each step's gradient norm rtol 1e-5), and the trainer's sampler (each process's rows of
  x_T and of each step's noise, gathered) against one process at 1e-4.
* The guard and the refusal: heights that do not split into even rows at
  every pooled level.
"""

import copy
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp_worker as w
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ldm_tpu.parallel.sp_explicit import make_unet_sp_apply
from ldm_tpu_torch.parallel.sp_explicit import supports_spatial_training
from ldm_tpu_torch.utils.flax_import import unet_from_flax
from test_torch_port_multiprocess import assert_states_close, spawn

SETUP = dict(in_channels=1, out_channels=1, channels=8, channel_multipliers=[1, 2],
             num_classes=10)


def jax_sp(tmp_path):
    """JAX's explicit SP on the (4, 2) mesh: the forward and the gradients
    of the mean squared error against a target, and the inputs the port's
    processes read (``spjax_in.pt``)."""
    model = FlaxUNet(**SETUP)
    x = jax.random.normal(jax.random.key(1), (8, 8, 8, 1), jnp.float32)
    t = jax.random.randint(jax.random.key(2), (8,), 0, 100)
    y = (jnp.arange(8, dtype=jnp.int32) * 3) % 11  # includes null labels
    target = jax.random.normal(jax.random.key(7), x.shape, jnp.float32)
    params = jax.jit(model.init)(jax.random.key(0), x[:1], t[:1], y[:1])
    sp_apply = make_unet_sp_apply(jax_create_mesh(model=2), model)
    out = jax.jit(sp_apply)(params, x, t, y)
    grads = jax.jit(jax.grad(lambda p: jnp.mean((sp_apply(p, x, t, y) - target) ** 2)))(params)
    torch.save({"model": SETUP, "state_dict": unet_from_flax(jax.device_get(params)),
                "x": torch.from_numpy(np.array(x)), "t": torch.from_numpy(np.array(t)),
                "y": torch.from_numpy(np.array(y)).long(),
                "target": torch.from_numpy(np.array(target))},
               tmp_path / "spjax_in.pt")
    return np.asarray(out), unet_from_flax(jax.device_get(grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size spawned once for the module: 2 processes run the
    trainer and the JAX comparison, 4 the trainer."""
    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"sp{world}")
            want = jax_sp(out) if world == 2 else None
            cache[world] = (spawn("sp+spjax" if world == 2 else "sp", world, out), want)
        return cache[world]
    return get


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One process of the port: the trainer's run, each step's gradient
    norm, the final parameters' norm, its state and trainer."""
    torch.set_num_threads(1)
    tr = w.tiny_trainer(w.tiny_config(tmp_path_factory.mktemp("ref")))
    grad_norms = w.record_grad_norms(tr)
    hist = tr.train()
    return {"history": hist, "grad_norms": grad_norms,
            "param_norm": float(tr.state.norm(tr.state.params())),
            "state": copy.deepcopy(tr.state.state_dict()), "trainer": tr}


def test_explicit_sp_forward_matches_jax(runs):
    outs, (want, _) = runs(2)
    for o in outs:
        np.testing.assert_allclose(o["spjax"]["out"].numpy(), want, rtol=1e-4, atol=2e-6)


def test_explicit_sp_grads_match_jax(runs):
    """Every leaf's gradient, summed over the model axis, is JAX's."""
    outs, (_, want) = runs(2)
    for o in outs:
        got = o["spjax"]["grads"]
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=2e-4, atol=1e-6,
                                       err_msg=k)


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_sp_training_matches_one_process(runs, reference, world):
    outs, _ = runs(world)
    want = reference["history"]
    for r, o in enumerate(outs):
        sp = o["sp"]
        assert sp["step"] == 6 and o["primary"] == (r == 0) and sp["impls"] == {"torch"}
        np.testing.assert_allclose(sp["history"]["train_loss"], want["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(sp["history"]["val_loss"], want["val_loss"], rtol=1e-5)
        assert_states_close(sp["state"], reference["state"], atol=5e-3)
        for k, v in outs[0]["sp"]["state"]["model"].items():
            assert torch.equal(sp["state"]["model"][k], v), k


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_sp_norms_match_one_process(runs, reference, world):
    """Each step's gradient norm (the gradients summed over the model axis
    and averaged over the data axis) and the final parameters' norm are
    one process's."""
    outs, _ = runs(world)
    for o in outs:
        sp = o["sp"]
        assert len(sp["grad_norms"]) == 6
        np.testing.assert_allclose(sp["grad_norms"], reference["grad_norms"], rtol=1e-5)
        np.testing.assert_allclose(sp["param_norm"], reference["param_norm"], rtol=1e-5)


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_sp_sampler_matches_one_process(runs, reference, world):
    """DDPM (each step's noise drawn whole, this process's rows kept) and
    DDIM from the EMA weights, gathered: one process's draws from the same
    EMA at 1e-4."""
    outs, _ = runs(world)
    tr = reference["trainer"]
    tr.state.ema.load_state_dict(outs[0]["sp"]["state"]["ema"])
    for method in ("ddpm", "ddim"):
        want = tr.sample_x0([1, 2, 3], cfg_scale=3.0, method=method, ddim_steps=2)
        for o in outs:
            np.testing.assert_allclose(o["sp"]["x0"][method].numpy(), want.numpy(), atol=1e-4,
                                       err_msg=method)


def fake_mesh(model_size: int):
    """A mesh's place without a process group: what the guard and the
    trainer's checks before any collective read."""
    return types.SimpleNamespace(device=torch.device("cpu"), group=None, size=1, rank=0,
                                 model_size=model_size, model_rank=0)


def test_supports_spatial_training_guard():
    """JAX's guard (tests/test_sp_explicit.py): H % (model * 2^levels)."""
    mesh = fake_mesh(2)
    assert supports_spatial_training(mesh, 8, 2)       # 8 % (2*4) == 0
    assert not supports_spatial_training(mesh, 12, 2)  # 12 % 8 != 0
    assert not supports_spatial_training(None, 8, 2)
    assert not supports_spatial_training(fake_mesh(1), 8, 2)  # model=1


def test_sp_training_refuses_indivisible_heights(tmp_path):
    """A height the rows cannot split evenly at every pooled level fails
    fast, as JAX's trainer does."""
    cfg = w.tiny_config(tmp_path, activation_sharding="spatial")
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, image_size=6))
    with pytest.raises(ValueError, match="spatial"):
        w.tiny_trainer(cfg, mesh=fake_mesh(2))
