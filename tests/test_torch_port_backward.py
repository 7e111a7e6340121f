"""The backward of the port's fused linear-attention block
(ldm_tpu_torch/ops/linear_attention.py) held against the JAX package's
(ldm_tpu/ops/linear_attention.py), and its autograd wiring.

Same inputs, made with numpy from a seed, go through both.  On the CPU the
port's backward takes its plain version (``linear_attention_block_bwd_torch``);
the CUDA kernels run only on a GPU, where chip_smoke.py holds them against
that plain version at every site shape of the flagship UNet.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.ops.linear_attention import (
    linear_attention_block_pallas_bwd,
    linear_attention_block_xla,
)
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.ops import launch_counts, linear_attention as la

HEADS, DIM_HEAD = 4, 32
HIDDEN = HEADS * DIM_HEAD
KW = dict(heads=HEADS, dim_head=DIM_HEAD)
GRADS = ("dx", "dwqkv", "dwout", "dbout", "dg1s", "dg1b", "dg2s", "dg2b")
# the JAX suite's tolerance for its backward kernel, per gradient
# (tests/test_linear_attention_op.py: 2e-5 of the gradient's largest entry)
TOL = 2e-5


def make_inputs(b, n, c, seed):
    """x, wqkv, wout, bout, gn1 scale/bias, gn2 scale/bias and dy, float32."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    args = [r(b, n, c), 0.1 * r(c, 3 * HIDDEN), 0.1 * r(HIDDEN, c), 0.1 * r(c),
            1 + 0.1 * r(c), 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c)]
    return args, r(b, n, c)


def port_bwd(args, dy, dtype=torch.float32):
    t = [torch.from_numpy(a) for a in args]
    t[0] = t[0].to(dtype)
    return la.linear_attention_block_bwd_torch(
        t[0], torch.from_numpy(dy).to(dtype), *t[1:], compute_dtype=dtype, **KW)


def xla_vjp(args, dy, dtype=jnp.float32):
    ja = [jnp.asarray(a) for a in args]
    ja[0] = ja[0].astype(dtype)
    fn = lambda *a: linear_attention_block_xla(*a, compute_dtype=dtype, **KW)  # noqa: E731
    _, vjp = jax.vjp(fn, *ja)
    return vjp(jnp.asarray(dy).astype(dtype))


def assert_grads_close(got, want, tol):
    for name, g, w in zip(GRADS, got, want):
        w = np.asarray(w, np.float32)
        assert tuple(g.shape) == w.shape, name
        scale = float(np.abs(w).max()) + 1e-12
        np.testing.assert_allclose(g.float().numpy(), w, atol=tol * scale, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("b,n,c,g", [
    (4, 32, 16, 2),    # unpacked kernel, weight grads summed over 2 programs
    (2, 64, 32, 1),    # unpacked, single-item programs
    (4, 32, 64, 2),    # the pixel-pair packed kernel (2C == hidden)
    (4, 32, 64, 4),    # packed, one program
])
def test_plain_bwd_matches_pallas_bwd(b, n, c, g):
    """The JAX suite's four cases of the hand-written Pallas backward."""
    args, dy = make_inputs(b, n, c, seed=3)
    want = linear_attention_block_pallas_bwd(
        jnp.asarray(args[0]), jnp.asarray(dy), *map(jnp.asarray, args[1:]),
        interpret=True, block_items=g, **KW)
    got = port_bwd(args, dy)
    assert got[0].dtype == torch.float32
    assert all(t.dtype == torch.float32 for t in got[1:])
    assert_grads_close(got, want, TOL)


@pytest.mark.parametrize("b,n,c", [(2, 16, 128), (2, 16, 256), (2, 16, 512)])
def test_plain_bwd_matches_xla_vjp_wide(b, n, c):
    """C > 64, which no backward exactness test of the JAX suite reaches."""
    args, dy = make_inputs(b, n, c, seed=4)
    assert_grads_close(port_bwd(args, dy), xla_vjp(args, dy), TOL)


@pytest.mark.parametrize("b,n,c", [(2, 64, 16), (2, 32, 64), (2, 16, 256)])
def test_plain_bwd_matches_xla_vjp_bf16(b, n, c):
    """bf16 compute with x and dy in bf16.  The plain backward rounds at the
    Pallas kernel's points, the XLA VJP at its autodiff's, and bf16 keeps 8
    bits: measured at most 1.9e-2 of a gradient's largest entry (dbout, a
    sum of nearly cancelling terms), 0.2-0.8e-2 for the others; held to
    3e-2, the forward's bf16 tolerance, relative to each gradient's scale."""
    args, dy = make_inputs(b, n, c, seed=5)
    got = port_bwd(args, dy, torch.bfloat16)
    assert got[0].dtype == torch.bfloat16
    assert_grads_close(got, xla_vjp(args, dy, jnp.bfloat16), 3e-2)


def test_function_gradcheck_float64():
    """LinearAttentionBlockFn's backward (the hand derivation) against finite
    differences of its forward, float64, at heads=2, dim_head=4."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, s=1.0, o=0.0):
        return (o + s * torch.randn(*shape, generator=g, dtype=torch.float64)).requires_grad_()

    c, hidden = 8, 8
    args = (r(2, 6, c), r(c, 3 * hidden, s=0.3), r(hidden, c, s=0.3), r(c, s=0.1),
            r(c, s=0.1, o=1.0), r(c, s=0.1), r(c, s=0.1, o=1.0), r(c, s=0.1))
    fn = lambda *a: la.LinearAttentionBlockFn.apply(*a, 2, 4, 1e-5, torch.float64)  # noqa: E731
    assert torch.autograd.gradcheck(fn, args)


def test_grad_mode_dispatch_goes_through_the_function():
    """In grad mode with an input that requires grad, the op is the autograd
    Function; its grads are the plain backward's; no kernel is counted on the
    CPU."""
    args, dy = make_inputs(2, 16, 64, seed=6)
    t = [torch.from_numpy(a).requires_grad_() for a in args]
    before = launch_counts()
    y = la.linear_attention_block(*t, **KW)
    assert type(y.grad_fn).__name__ == "LinearAttentionBlockFnBackward"
    y.backward(torch.from_numpy(dy))
    want = port_bwd(args, dy)
    for name, a, w in zip(GRADS, t, want):
        torch.testing.assert_close(a.grad, w, rtol=0, atol=0, msg=name)
    assert launch_counts() == before
    with torch.no_grad():
        assert la.linear_attention_block(*t, **KW).grad_fn is None


def test_bwd_other_devices_raise():
    args, dy = make_inputs(1, 16, 64, seed=7)
    x, *p = (torch.from_numpy(a).to("meta") for a in args)
    with pytest.raises(ValueError, match="no linear-attention implementation"):
        la.linear_attention_block_bwd(x, torch.from_numpy(dy).to("meta"), *p, **KW)


def test_bwd_kernel_takes_c_up_to_512():
    """The backward kernel's shared-memory tiles take C <= 512; the check
    refuses wider before any launch."""
    x = torch.zeros(1, 4, 768)
    p = [torch.zeros(768, 3 * HIDDEN), torch.zeros(HIDDEN, 768)] + [torch.zeros(768)] * 5
    with torch.no_grad():
        la._check_cuda_args(x, p, HEADS, DIM_HEAD, torch.float32)
        with pytest.raises(ValueError, match=r"\[8, 512\]"):  # the wrapper pads C = 8
            la._check_cuda_args(x, p, HEADS, DIM_HEAD, torch.float32, max_c=la.MAX_C_BWD)
    la.plan_fwd(4, 768, torch.float32)
    with pytest.raises(ValueError, match=r"\[16, 512\]"):
        la.plan_bwd(4, 768, torch.float32)


# (N, C) of the 32px flagship UNet's 8 sites, the 64px UNet's and the 128px one
# that chip_smoke.py checks on the card
KERNEL_SHAPES = [(1024, 64), (256, 128), (64, 256), (16, 512), (16, 256), (64, 128), (256, 64),
                 (1024, 64), (4096, 64), (1024, 128), (256, 256), (64, 512), (16384, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", KERNEL_SHAPES)
def test_bwd_plan_is_a_function_of_the_shape(n, c, dtype):
    """plan_bwd: the cluster size from N alone, the rows split evenly, the
    buffers 16-byte aligned, in order, and inside the 232,448 bytes a CTA can
    take; the same answer every time."""
    plan = la.plan_bwd(n, c, dtype)
    assert plan == la.plan_bwd(n, c, dtype)
    assert plan.cs == la.cluster_size(n) == {16: 1, 64: 1, 256: 2, 1024: 8, 4096: 8, 16384: 8}[n]
    assert plan.cs * plan.rows == n and la.HIDDEN % plan.cs == 0
    assert plan.smem_bytes <= la.SMEM_LIMIT == 232_448
    offs = [plan.off_tile, plan.off_ctxn, plan.off_dctx, plan.off_dctxt, plan.off_vec,
            plan.off_cw, plan.off_cwt, plan.off_qkv, plan.smem_bytes]
    assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
    es, pad = dtype.itemsize, 16 // dtype.itemsize
    if plan.keep:  # the cluster path holds the CTA's rows of qn | kn | v
        assert plan.smem_bytes - plan.off_qkv == plan.rows * (3 * HIDDEN + pad) * es
    else:
        assert plan.off_qkv == plan.smem_bytes
    if plan.keep_cw:
        assert plan.off_qkv - plan.off_cw == (HIDDEN * (c + pad) + c * (HIDDEN + pad)) * es
    assert plan.path == ("cluster" if plan.keep else "tiled")
    assert len(plan.ints()) == 12
    if dtype == torch.bfloat16 and (n, c) in ((1024, 64), (256, 64), (256, 128)):
        assert plan.keep  # the flagship sites stay on chip
        assert plan.keep_cw == (c == 64)  # beside 128 rows at C=128, cw goes through scratch
    if n >= 4096:
        assert not plan.keep


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unet_step_puts_grads_on_every_attention_weight(dtype):
    """A grad-mode UNet step through LinearAttentionBlockFn puts a non-zero
    gradient on every to_qkv and to_out weight, equal to what torch autograd
    of the plain forward (attention_impl="torch") gives.  fp32 to 1e-5 of
    each gradient's scale (summation order); bf16 to 2e-2 (the two round
    the block's backward at different points).  A leaf whose exact gradient
    vanishes (at channels=8 every GroupNorm(8) has one channel a group, so
    the bias of the conv before it gets none) carries rounding noise alone,
    so each leaf's scale is at least 1e-2 of the model's largest gradient."""
    kw = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=(1, 2),
              num_classes=10, dtype=dtype)
    torch.manual_seed(0)
    fused = UNet(**kw)
    plain = UNet(attention_impl="torch", **kw)
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.standard_normal((2, 16, 16, 3)).astype(np.float32))
    t, y = torch.tensor([3, 250]), torch.tensor([1, 10])
    for m in (fused, plain):
        torch.mean((eps - m(x, t, y)) ** 2).backward()
    want = dict(plain.named_parameters())
    convs = [n for n, _ in fused.named_parameters()
             if n.endswith(("fn.fn.to_qkv.weight", "fn.fn.to_out.0.weight"))
             and "bottleneck" not in n]
    assert len(convs) == 2 * 4  # to_qkv and to_out of the 4 linear-attention sites
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    floor = 1e-2 * max(float(p.grad.abs().max()) for p in want.values())
    for name, p in fused.named_parameters():
        w = want[name].grad
        if name in convs:
            assert p.grad.abs().max() > 0, name
        scale = max(float(w.abs().max()), floor)
        torch.testing.assert_close(p.grad, w, rtol=0, atol=tol * scale, msg=name)
