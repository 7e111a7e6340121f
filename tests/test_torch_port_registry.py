"""The port's registry and factory surface (ldm_tpu_torch/registry.py,
ldm_tpu_torch/factory.py) held against ldm_tpu/registry.py and
ldm_tpu/factory.py: one raw ``{"target", "params"}`` dict through both
``instantiate_from_config`` (the reference's torch-era ``device: cuda`` and a
repeated ``dtype`` in its params), ``resolve`` of every reference alias,
``register``, and the config twins through ``config_from_dict`` and
``config_summary``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ldm_tpu import factory as jax_factory
from ldm_tpu import registry as jax_registry
from ldm_tpu.config import config_from_dict as jax_config_from_dict
from ldm_tpu.config import load_config as jax_load_config
from ldm_tpu_torch import factory, registry
from ldm_tpu_torch.config import config_from_dict
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.utils.flax_import import unet_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 8, 1)
UNET_TOL = 2e-5  # tests/test_torch_parity.py:31, the JAX suite's module tolerance
# a model block as the reference's YAMLs carry it: the torch-era device and
# a dtype that the factory's own keyword repeats
RAW_UNET = {"target": "src.UNet.UNet",
            "params": {"in_channels": 1, "out_channels": 1, "channels": 8,
                       "channel_multipliers": [1, 2], "num_classes": 10,
                       "device": "cuda", "dtype": "bfloat16"}}


def test_raw_reference_dict_builds_the_same_unet_in_both_packages():
    """Fault 11: ``device: cuda`` in the params is dropped and the caller's
    ``dtype`` / ``device`` win, as in the JAX registry; the two forwards on
    carried weights agree at the module tolerance."""
    flax_model = jax_registry.instantiate_from_config(RAW_UNET, dtype=jnp.float32)
    model = registry.instantiate_from_config(RAW_UNET, dtype=torch.float32,
                                             device=torch.device("cpu"))
    assert isinstance(model, UNet) and model.dtype == torch.float32
    assert all(p.device.type == "cpu" for p in model.parameters())
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2,) + SHAPE).astype(np.float32)
    t = np.array([3, 250], np.int32)
    y = np.array([1, 7], np.int32)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    model.load_state_dict(unet_from_flax(params), strict=True)
    want = np.asarray(flax_model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t).long(),
                           torch.from_numpy(y).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=UNET_TOL)


def test_build_model_keeps_its_device_and_dtype_over_the_yaml(tmp_path):
    """``factory.build_model`` on a config whose model params carry the
    reference's ``device: cuda``: the factory's CPU device and compute dtype
    win, as ``ldm_tpu/factory.py::build_model``'s do."""
    raw = {"use_amp": False, "model": {"target": RAW_UNET["target"],
                                       "params": dict(RAW_UNET["params"])}}
    model = factory.build_model(config_from_dict(raw), torch.device("cpu"))
    assert model.dtype == torch.float32
    assert {p.device.type for p in model.parameters()} == {"cpu"}
    assert jax_factory.build_model(jax_config_from_dict(raw)).dtype == jnp.float32


def test_a_config_without_target_raises_key_error():
    with pytest.raises(KeyError, match="no 'target'"):
        registry.instantiate_from_config({"params": {}})


@pytest.mark.parametrize("alias", sorted(jax_registry.TARGET_ALIASES))
def test_every_reference_alias_resolves_to_the_jax_class_name(alias):
    assert registry.TARGET_ALIASES == jax_registry.TARGET_ALIASES
    port, jax_cls = registry.resolve(alias), jax_registry.resolve(alias)
    assert port is registry.resolve(jax_registry.TARGET_ALIASES[alias])
    assert port.__name__ == jax_cls.__name__


@pytest.mark.parametrize("target", ["src.UNet.Missing", "ldm_tpu.models.unet.Nothing"])
def test_an_unknown_target_raises_key_error_naming_the_known(target):
    with pytest.raises(KeyError, match="ldm_tpu.models.unet.UNet"):
        registry.resolve(target)
    with pytest.raises(KeyError):
        registry.instantiate_from_config({"target": target})


def test_register_adds_a_target_that_instantiate_builds(monkeypatch):
    monkeypatch.setattr(registry, "TARGETS", dict(registry.TARGETS))

    @registry.register("tests.Component")
    class Component:
        def __init__(self, width: int, dtype=None):
            self.width, self.dtype = width, dtype

    assert registry.resolve("tests.Component") is Component
    built = registry.instantiate_from_config(
        {"target": "tests.Component", "params": {"width": 3, "device": "cuda",
                                                 "dtype": "float16"}},
        dtype=torch.float32)
    assert isinstance(built, Component) and built.width == 3 and built.dtype == torch.float32


def test_nested_param_flattening_gives_equal_configs():
    """tests/test_config.py::test_nested_param_flattening's dict through
    both packages' ``config_from_dict``."""
    raw = yaml.safe_load("""
diffusion:
  type: pixel
  cfg_scale: 2
  params:
    n_steps: 123
    n_samples: 7
    device: cuda
batch_size: 32
""")
    port, jax_cfg = config_from_dict(raw), jax_config_from_dict(raw)
    assert (port.diffusion.n_steps, port.diffusion.n_samples, port.diffusion.cfg_scale,
            port.batch_size) == (123, 7, 2, 32)
    assert factory.config_summary(port) == jax_factory.config_summary(jax_cfg)


@pytest.mark.parametrize("name", ["pixel_diffusion_model_mnist.yaml",
                                  "pixel_diffusion_model_cifar10.yaml"])
def test_config_summary_matches_jax(name):
    path = os.path.join(ROOT, "configs", name)
    summary = factory.config_summary(factory.load_config(path))
    assert summary == jax_factory.config_summary(jax_load_config(path))
    assert summary["model"]["params"]["channels"] == 64
