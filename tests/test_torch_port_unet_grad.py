"""The loss gradients of the port's UNet (ldm_tpu_torch/models/unet.py) held
against ``jax.grad`` of the flax UNet (ldm_tpu/models/unet.py), same weights
and inputs, fp32, and the 4-level UNet's forward.

The port's linear-attention blocks run in grad mode through
LinearAttentionBlockFn (on the CPU: the plain forward and the plain
hand-derived backward), so these tests hold the hand derivation inside the
whole network.  Flax grads go into the port's layout through
``unet_state_dict_from_params``, which is linear in the leaves.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.utils.torch_export import unet_state_dict_from_params
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.utils.flax_import import unet_from_flax

FWD_ATOL = 2e-5  # the JAX suite's module tolerance (tests/test_torch_parity.py:31)
# per leaf: 1e-4 of its largest gradient (fp32, sums in another order); a
# leaf whose exact gradient vanishes (a conv bias before a GroupNorm with one
# channel a group, at channels=8) carries rounding noise alone, so each
# leaf's scale is at least 1e-2 of the model's largest gradient
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-2


def pair(multipliers, size):
    kw = dict(in_channels=3, out_channels=3, channels=8,
              channel_multipliers=tuple(multipliers), num_classes=10)
    flax_model = FlaxUNet(**kw)
    params = jax.device_get(jax.jit(flax_model.init)(
        jax.random.key(1), jnp.zeros((1, size, size, 3)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32)))
    model = UNet(**kw)
    model.load_state_dict(unet_from_flax(params), strict=True)
    return flax_model, params, model


def inputs(size, seed, b=2):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    eps = rng.standard_normal((b, size, size, 3)).astype(np.float32)
    t = rng.integers(0, 400, b).astype(np.int32)
    y = np.array([3, 10, 7, 1][:b], np.int32)  # 10: the null label
    return x, eps, t, y


def assert_grads_match(model, flax_grads):
    want = unet_state_dict_from_params(flax_grads)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    floor = GRAD_FLOOR * max(float(np.abs(w).max()) for w in want.values())
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        scale = max(float(np.abs(w).max()), floor)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=GRAD_TOL * scale, err_msg=name)


@pytest.mark.parametrize("multipliers,size", [((1, 2), 16), ((1, 2, 4, 8), 32)])
def test_unet_loss_grad_matches_jax_grad(multipliers, size):
    """16px with 2 levels, and the flagship's 4 levels at 32px (N=16 sites
    and the 2x2 bottleneck)."""
    flax_model, params, model = pair(multipliers, size)
    x, eps, t, y = inputs(size, seed=size)

    def loss_fn(p):
        out = flax_model.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y))
        return jnp.mean((jnp.asarray(eps) - out) ** 2)

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    loss = torch.mean((torch.from_numpy(eps) - model(
        torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long())) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    assert_grads_match(model, jax.device_get(grads))


def test_four_level_unet_forward_matches_flax():
    """The 4-level UNet at 32px, fp32, B=2: forward at the module tolerance."""
    flax_model, params, model = pair((1, 2, 4, 8), 32)
    x, _, t, y = inputs(32, seed=5)
    want = np.asarray(flax_model.apply(params, jnp.asarray(x), jnp.asarray(t), jnp.asarray(y)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t).long(), torch.from_numpy(y).long())
    np.testing.assert_allclose(got.numpy(), want, atol=FWD_ATOL)
