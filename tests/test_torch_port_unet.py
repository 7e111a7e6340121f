"""The port's UNet (ldm_tpu_torch/models/unet.py) held against the flax UNet
(ldm_tpu/models/unet.py), with the same weights carried across by the bridge
(ldm_tpu_torch/utils/flax_import.py) and the same inputs made with numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.config import load_config
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.utils.torch_export import unet_state_dict_from_params
from ldm_tpu_torch.factory import build_model
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.utils.flax_import import unet_from_flax

ATOL = 2e-5  # the JAX suite's module tolerance (tests/test_torch_parity.py:31)
TINY = dict(channels=8, channel_multipliers=(1, 2), num_classes=10)


def tiny_pair(in_channels, bottleneck_time_emb=True, dtype=torch.float32, size=16):
    """A flax UNet with initialised params, and the port's UNet loaded from
    them, both computing in ``dtype``."""
    flax_model = FlaxUNet(in_channels=in_channels, out_channels=in_channels,
                          bottleneck_time_emb=bottleneck_time_emb,
                          dtype=jnp.dtype(str(dtype)[6:]), **TINY)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(0), jnp.zeros((1, size, size, in_channels)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
    ))
    model = UNet(in_channels=in_channels, out_channels=in_channels,
                 bottleneck_time_emb=bottleneck_time_emb, dtype=dtype, **TINY)
    model.load_state_dict(unet_from_flax(params), strict=True)
    return flax_model, params, model.eval()


def inputs(b, size, c, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, c)).astype(np.float32)
    t = rng.integers(0, 400, b).astype(np.int32)
    y = rng.integers(0, 11, b).astype(np.int32)  # 10 is the null label
    return x, t, y


@pytest.mark.parametrize("in_channels,bottleneck_time_emb", [(1, True), (3, True), (3, False)])
def test_unet_matches_flax_fp32(in_channels, bottleneck_time_emb):
    flax_model, params, model = tiny_pair(in_channels, bottleneck_time_emb)
    x, t, y = inputs(3, 16, in_channels, seed=in_channels)
    want = np.asarray(flax_model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long())
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_unet_matches_flax_bf16():
    """bf16 compute with fp32 params on both sides.  The cast points follow
    the JAX package, but XLA and PyTorch round some elementwise chains (SiLU,
    GELU, GroupNorm's affine) at other points and sum in other orders, so
    the outputs differ by a few bf16 spacings (measured: max 0.078-0.094 at
    |eps| up to 5-7, mean 0.014): held to 2% of the output's scale."""
    flax_model, params, model = tiny_pair(3, dtype=torch.bfloat16)
    x, t, y = inputs(2, 16, 3, seed=7)
    want = np.asarray(flax_model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long())
    assert got.dtype == torch.float32
    diff = np.abs(got.numpy() - want)
    assert diff.max() <= 2e-2 * np.abs(want).max()
    assert diff.mean() <= 2e-2 * np.abs(want).mean()


def test_null_label_equals_no_label():
    _, _, model = tiny_pair(1)
    x, t, _ = inputs(2, 16, 1, seed=3)
    xt, tt = torch.from_numpy(x), torch.from_numpy(t).long()
    with torch.no_grad():
        o_null = model(xt, tt, torch.full((2,), model.null_label))
        o_none = model(xt, tt, None)
        o_cond = model(xt, tt, torch.tensor([3, 4]))
    assert torch.equal(o_null, o_none)
    assert not torch.equal(o_cond, o_none)


def test_flagship_parameters_and_keys_match_the_bridge():
    """The flagship port UNet counts 20,350,915 parameters, and its state_dict
    keys and shapes are those the bridge makes of the flax tree (shapes only:
    jax.eval_shape compiles nothing)."""
    config = load_config("configs/pixel_diffusion_model_cifar10.yaml")
    model = build_model(config)
    assert sum(p.numel() for p in model.parameters()) == 20_350_915
    assert model.dtype == torch.bfloat16  # use_amp: bf16 compute, fp32 params
    assert all(p.dtype == torch.float32 for p in model.parameters())

    flax_model = FlaxUNet(**config.model.params)
    shapes = jax.eval_shape(
        flax_model.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
    )
    zeros = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), shapes)
    bridged = unet_state_dict_from_params(zeros)
    ours = model.state_dict()
    assert sorted(ours) == sorted(bridged)
    for k, v in ours.items():
        assert tuple(v.shape) == bridged[k].shape, k


def test_unet_matches_flax_fp32_at_64px():
    """One forward at 64px, four levels (channels 16, multipliers 1/2/4/8:
    attention sites (4096, 16), (1024, 32), (256, 64), (64, 128) and back),
    B=1, fp32, at the module tolerance: the depth and the image size of
    configs/protocol_hard_64.yaml at a narrow width."""
    kw = dict(in_channels=3, out_channels=3, channels=16, channel_multipliers=(1, 2, 4, 8),
              num_classes=10)
    flax_model = FlaxUNet(**kw)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(0), jnp.zeros((1, 64, 64, 3)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32)))
    model = UNet(**kw).eval()
    model.load_state_dict(unet_from_flax(params), strict=True)
    x, t, y = inputs(1, 64, 3, seed=64)
    want = np.asarray(jax.jit(flax_model.apply)(params, jnp.asarray(x), jnp.asarray(t),
                                                jnp.asarray(y)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long())
    assert got.shape == want.shape == (1, 64, 64, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
