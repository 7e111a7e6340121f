"""The port's fused ResNet-block op (ldm_tpu_torch/ops/resnet_block.py) held
against the JAX package's (ldm_tpu/ops/resnet_block.py), and the plain
versions of the two stage-ablation probes (ldm_tpu_torch/perf/probe13b.py,
probe7.py).

Same inputs, made with numpy from a seed, go through both.  On the CPU the
port's dispatching op takes its plain version; the CUDA kernels run only on a
GPU, where chip_smoke.py holds each against its plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.models.unet import ResNetBlock as FlaxResNetBlock
from ldm_tpu.ops.resnet_block import (
    resnet_block as jax_resnet_block,
    resnet_block_pallas,
    resnet_block_xla,
)
from ldm_tpu_torch.models.unet import ResNetBlock
from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.ops import resnet_block as rb
from ldm_tpu_torch.perf import probe7, probe13b
from ldm_tpu_torch.utils import launches
from ldm_tpu_torch.utils.flax_import import resnet_block_args, resnet_block_from_flax

GROUPS = 8


def make_args(cin, cout, b=2, s=8, seed=0):
    """x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs as float32 numpy
    (ws / bs (1, 1) zeros when cin == cout), and use_shortcut."""
    rng = np.random.default_rng(seed)

    def r(*shape, scale=1.0):
        return (scale * rng.standard_normal(shape)).astype(np.float32)

    use_sc = cin != cout
    args = [r(b, s, s, cin), r(b, cout, scale=0.5),
            1 + r(cin, scale=0.1), r(cin, scale=0.1),
            r(3, 3, cin, cout, scale=(9 * cin) ** -0.5), r(cout, scale=0.1),
            1 + r(cout, scale=0.1), r(cout, scale=0.1),
            r(3, 3, cout, cout, scale=(9 * cout) ** -0.5), r(cout, scale=0.1)]
    if use_sc:
        args += [r(cin, cout, scale=cin**-0.5), r(cout, scale=0.1)]
    else:
        args += [np.zeros((1, 1), np.float32)] * 2
    return args, use_sc


def jax_args(args):
    return [jnp.asarray(a) for a in args]


def torch_args(args):
    return [torch.from_numpy(a) for a in args]


CASES = [(16, 24), (16, 16), (64, 128)]


@pytest.mark.parametrize("cin,cout", CASES)
def test_plain_matches_xla_fp32(cin, cout):
    args, use_sc = make_args(cin, cout, seed=1)
    want = np.asarray(resnet_block_xla(*jax_args(args), groups=GROUPS, use_shortcut=use_sc))
    got = rb.resnet_block_torch(*torch_args(args), groups=GROUPS, use_shortcut=use_sc)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("cin,cout", CASES)
def test_plain_matches_pallas_interpret(cin, cout):
    args, use_sc = make_args(cin, cout, seed=2)
    want = np.asarray(resnet_block_pallas(*jax_args(args), groups=GROUPS,
                                          use_shortcut=use_sc, interpret=True))
    got = rb.resnet_block_torch(*torch_args(args), groups=GROUPS, use_shortcut=use_sc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("cin,cout", CASES)
def test_plain_matches_xla_bf16(cin, cout):
    """bf16 compute with x in bf16: the cast points match the XLA path's."""
    args, use_sc = make_args(cin, cout, seed=3)
    jargs = jax_args(args)
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    want = np.asarray(resnet_block_xla(*jargs, groups=GROUPS, compute_dtype=jnp.bfloat16,
                                       use_shortcut=use_sc), np.float32)
    targs = torch_args(args)
    targs[0] = targs[0].to(torch.bfloat16)
    got = rb.resnet_block_torch(*targs, groups=GROUPS, compute_dtype=torch.bfloat16,
                                use_shortcut=use_sc)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("cin,cout", [(16, 24), (16, 16)])
def test_op_matches_flax_module(cin, cout):
    """The flax ResNetBlock's own parameters through the bridge, and the op
    against ``apply``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 8, 8, cin)).astype(np.float32)
    traw = rng.standard_normal((3, 32)).astype(np.float32)
    mod = FlaxResNetBlock(cout)
    params = jax.tree_util.tree_map(np.asarray, mod.init(jax.random.key(4), x, traw))
    want = np.asarray(mod.apply(params, x, traw))
    args, use_sc = resnet_block_from_flax(params, traw)
    assert use_sc == (cin != cout)
    got = rb.resnet_block(torch.from_numpy(x), *args, groups=GROUPS, use_shortcut=use_sc)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("cin,cout,time_dim", [(16, 24, 32), (16, 16, 32), (16, 16, None)])
def test_op_matches_port_module(cin, cout, time_dim):
    """The port's models.unet.ResNetBlock (OIHW convs, NCHW channels_last)
    and the op on its weights, in the JAX layout; a block without a time
    MLP (the UNet's head) takes zero time rows."""
    torch.manual_seed(5)
    mod = ResNetBlock(cin, cout, time_dim).eval()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 8, 8, cin, generator=g)
    temb = torch.randn(2, 32, generator=g) if time_dim else None
    with torch.no_grad():
        want = mod(x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last), temb)
        args, use_sc = resnet_block_args(mod, temb, batch=2)
        got = rb.resnet_block(x, *args, groups=GROUPS, use_shortcut=use_sc)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(), atol=1e-5)


@pytest.mark.parametrize("cin,cout", [(16, 24), (16, 16)])
def test_gradients_match_jax_custom_vjp(cin, cout):
    """ResNetBlockFn's gradients for x, temb and every weight against
    jax.grad of the custom-VJP op (Pallas forward in interpret mode), within
    1e-4 of each leaf's largest gradient, at least 1e-4: the sums over the
    B*H*W pixels run in another order (temb's and the biases' grads reach
    ~60 here, where fp32 keeps ~1e-5 of that)."""
    from jax.experimental.pallas import tpu as pltpu

    args, use_sc = make_args(cin, cout, seed=6)
    n = 12 if use_sc else 10  # the identity block's ws / bs are dummies

    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            y = jax_resnet_block(*a, *jax_args(args)[n:], GROUPS, 1e-5, jnp.float32, use_sc)
        return jnp.sum(y * y)

    want = jax.grad(loss, argnums=tuple(range(n)))(*jax_args(args)[:n])
    leaves = [t.requires_grad_() for t in torch_args(args[:n])]
    y = rb.resnet_block(*leaves, *torch_args(args[n:]), groups=GROUPS, use_shortcut=use_sc)
    assert type(y.grad_fn).__name__ == "ResNetBlockFnBackward"
    (y * y).sum().backward()
    for i, (leaf, w) in enumerate(zip(leaves, want)):
        w = np.asarray(w)
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(w).max()),
                                   err_msg=f"grad of argument {i}")


def test_fn_backward_skips_unneeded_grads():
    """Only the inputs that require grad get one."""
    args, _ = make_args(16, 16, seed=7)
    t = torch_args(args)
    t[4].requires_grad_()
    rb.resnet_block(*t, groups=GROUPS).sum().backward()
    assert t[4].grad is not None and t[0].grad is None


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    t = torch_args(make_args(16, 24, seed=8)[0])
    before = launches.read(rb.LIB.name)
    got = rb.resnet_block(*t, use_shortcut=True)
    want = rb.resnet_block_torch(*t, groups=GROUPS, use_shortcut=True)
    assert torch.equal(got, want)
    assert launches.read(rb.LIB.name) == before


def test_other_devices_raise():
    t = [a.to("meta") for a in torch_args(make_args(16, 16)[0])]
    with pytest.raises(ValueError, match="no resnet-block implementation"):
        rb.resnet_block(*t)


def _bad_args(case):
    """Kernel arguments with one defect each; returns (args, dtype, use_sc)."""
    t = torch_args(make_args(16, 24, seed=9)[0])
    dtype, use_sc = torch.float32, True
    if case == "rank":
        t[0] = t[0][0]
    elif case == "dtype_mismatch":
        dtype = torch.bfloat16
    elif case == "fp16":
        t[0], dtype = t[0].half(), torch.float16
    elif case == "non_contiguous":
        t[0] = t[0].permute(0, 2, 1, 3)
    elif case == "groups":
        t = torch_args(make_args(12, 24, seed=9)[0])
    elif case == "wide":
        t = torch_args(make_args(16, 1024, b=1, s=2, seed=9)[0])
    elif case == "identity_width":
        use_sc = False
    elif case == "weight_shape":
        t[4] = t[4][:2]
    elif case == "weight_dtype":
        t[8] = t[8].double()
    elif case == "temb_dtype":
        t[1] = t[1].to(torch.bfloat16)
    elif case == "weight_layout":
        t[10] = t[10].t().contiguous().t()
    return t, dtype, use_sc


@pytest.mark.parametrize("case", ["rank", "dtype_mismatch", "fp16", "non_contiguous", "groups",
                                  "wide", "identity_width", "weight_shape", "weight_dtype",
                                  "temb_dtype", "weight_layout"])
def test_kernel_argument_checks_raise(case):
    """What the CUDA wrapper refuses before it launches (the checks run the
    same on any device, so they are tested here)."""
    t, dtype, use_sc = _bad_args(case)
    with pytest.raises(ValueError):
        rb._check_cuda_args(t[0], t[1], t[2:10], t[10], t[11], GROUPS, dtype, use_sc)


def test_kernel_refuses_grad():
    t = torch_args(make_args(16, 24, seed=10)[0])
    t[4].requires_grad_()
    with pytest.raises(RuntimeError, match="not differentiable"):
        rb._check_cuda_args(t[0], t[1], t[2:10], t[10], t[11], GROUPS, torch.float32, True)
    with torch.no_grad():
        rb._check_cuda_args(t[0], t[1], t[2:10], t[10], t[11], GROUPS, torch.float32, True)


# ---- the probes' plain versions


def test_probe13b_full_mode_is_the_block():
    """Mode ``full`` in fp32 is the plain block with the identity shortcut."""
    t = torch_args(make_args(16, 16, seed=11)[0])[:10]
    got = probe13b.probe_block(probe13b.MODES[-1], *t)
    want = rb.resnet_block_torch(*t, None, None, groups=GROUPS)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_probe13b_modes():
    """noop copies x; center keeps only the middle tap of each conv (full
    with the other eight taps zeroed); gnonly makes each conv its input."""
    t = torch_args(make_args(16, 16, seed=12)[0])[:10]
    assert torch.equal(probe13b.probe_block("noop", *t), t[0])
    centre = [w.clone() for w in (t[4], t[8])]
    for w in centre:
        w[[0, 0, 0, 1, 1, 2, 2, 2], [0, 1, 2, 0, 2, 0, 1, 2]] = 0
    want = probe13b.probe_block_torch("full", *t[:4], centre[0], t[5], t[6], t[7],
                                      centre[1], t[9])
    np.testing.assert_allclose(probe13b.probe_block("center", *t).numpy(), want.numpy(),
                               atol=1e-5)
    eye = torch.eye(16).expand(3, 3, 16, 16) * torch.tensor([0, 1, 0.0])[None, :, None, None]
    eye = eye * torch.tensor([0, 1, 0.0])[:, None, None, None]
    want = probe13b.probe_block_torch("center", *t[:4], eye, t[5], t[6], t[7], eye, t[9])
    np.testing.assert_allclose(probe13b.probe_block("gnonly", *t).numpy(), want.numpy(),
                               atol=1e-6)
    with pytest.raises(ValueError, match="mode"):
        probe13b.probe_block("accum", *t)


def test_probe7_stage6_is_the_block():
    x, params = probe7.probe_inputs("cpu", torch.float32, b=2, n=16, c=64, seed=1)
    want = la.linear_attention_block_torch(x, *params, heads=4, dim_head=32)
    assert torch.equal(probe7.stage_block(6, x, *params), want)


def test_probe7_stages_build_on_each_other():
    """In fp32: stage 1 adds GN1(x) (per item mean 0, variance 1 with the
    identity norm); stage 5's y - x, normalised by GN2, is stage 6's; every
    stage is finite and of x's shape; unknown stages raise."""
    x, params = probe7.probe_inputs("cpu", torch.float32, b=2, n=16, c=64, seed=2)
    outs = {s: probe7.stage_block(s, x, *params) for s in probe7.STAGES}
    for s, y in outs.items():
        assert y.shape == x.shape and torch.isfinite(y).all(), s
    h = outs[1] - x
    np.testing.assert_allclose(h.mean(dim=(1, 2)).numpy(), 0, atol=1e-5)
    np.testing.assert_allclose(h.var(dim=(1, 2), correction=0).numpy(), 1, atol=1e-4)
    o = outs[5] - x
    gn2 = (o - o.mean(dim=(1, 2), keepdim=True)) * torch.rsqrt(
        o.var(dim=(1, 2), keepdim=True, correction=0) + 1e-5)
    np.testing.assert_allclose((x + gn2).numpy(), outs[6].numpy(), atol=1e-4)
    assert not torch.equal(outs[3], outs[2]) and not torch.equal(outs[4], outs[3])
    with pytest.raises(ValueError, match="stage"):
        probe7.stage_block(7, x, *params)
