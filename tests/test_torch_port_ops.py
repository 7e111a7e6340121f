"""The port's fused linear-attention block (ldm_tpu_torch/ops/linear_attention.py)
held against the JAX package's (ldm_tpu/ops/linear_attention.py).

Same inputs, made with numpy from a seed, go through both.  On the CPU the
port's dispatching op takes its plain version.  The CUDA kernel itself runs
only on a GPU, where chip_smoke.py holds it against the plain version at
every site shape of the flagship UNet.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.ops.linear_attention import (
    linear_attention_block_pallas,
    linear_attention_block_xla,
)
from ldm_tpu_torch.ops import launch_counts, linear_attention as la

HEADS, DIM_HEAD = 4, 32
HIDDEN = HEADS * DIM_HEAD
KW = dict(heads=HEADS, dim_head=DIM_HEAD)


def make_inputs(b, n, c, seed=0):
    """x, wqkv, wout, bout, gn1 scale/bias, gn2 scale/bias as float32 numpy."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return [r(b, n, c), 0.1 * r(c, 3 * HIDDEN), 0.1 * r(HIDDEN, c), 0.1 * r(c),
            1 + 0.1 * r(c), 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c)]


def jax_args(args):
    return [jnp.asarray(a) for a in args]


def torch_args(args, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in args]


@pytest.mark.parametrize("b,n,c", [(2, 64, 16), (3, 32, 64), (2, 16, 128), (2, 16, 512)])
def test_plain_matches_xla_fp32(b, n, c):
    args = make_inputs(b, n, c, seed=1)
    want = np.asarray(linear_attention_block_xla(*jax_args(args), **KW))
    got = la.linear_attention_block_torch(*torch_args(args), **KW)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("b,n,c", [(3, 32, 64), (2, 16, 128)])
def test_plain_matches_pallas_interpret(b, n, c):
    """C=64 reaches the pixel-pair packed Pallas kernel, C=128 the unpacked one."""
    args = make_inputs(b, n, c, seed=2)
    want = np.asarray(linear_attention_block_pallas(*jax_args(args), interpret=True, **KW))
    got = la.linear_attention_block_torch(*torch_args(args), **KW)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("b,n,c", [(2, 64, 16), (2, 32, 64), (2, 16, 256)])
def test_plain_matches_xla_bf16(b, n, c):
    """bf16 compute, x in bf16 as the UNet passes it: the cast points match."""
    args = make_inputs(b, n, c, seed=3)
    jargs = jax_args(args)
    jargs[0] = jargs[0].astype(jnp.bfloat16)
    want = linear_attention_block_xla(*jargs, compute_dtype=jnp.bfloat16, **KW)
    targs = torch_args(args)
    targs[0] = targs[0].to(torch.bfloat16)
    got = la.linear_attention_block_torch(*targs, compute_dtype=torch.bfloat16, **KW)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    args = torch_args(make_inputs(2, 16, 64, seed=4))
    before = launch_counts()
    got = la.linear_attention_block(*args, **KW)
    want = la.linear_attention_block_torch(*args, **KW)
    assert torch.equal(got, want)
    assert launch_counts() == before


def test_other_devices_raise():
    x, *params = (t.to("meta") for t in torch_args(make_inputs(1, 16, 64)))
    with pytest.raises(ValueError, match="no linear-attention implementation"):
        la.linear_attention_block(x, *params, **KW)


def _bad_args(case):
    """Kernel arguments with one defect each (shapes of a C=64 site)."""
    x, *p = torch_args(make_inputs(2, 16, 64, seed=5))
    dtype, kw = torch.float32, dict(KW)
    if case == "heads":
        kw = dict(heads=2, dim_head=64)
    elif case == "rank":
        x = x[0]
    elif case == "dtype_mismatch":
        dtype = torch.bfloat16
    elif case == "fp16":
        x, dtype = x.half(), torch.float16
    elif case == "non_contiguous":
        x = x.transpose(1, 2).contiguous().transpose(1, 2)
    elif case == "weight_shape":
        p[0] = p[0][:, :HIDDEN]
    elif case == "weight_dtype":
        p[1] = p[1].double()
    elif case == "weight_layout":
        p[0] = p[0].t().contiguous().t()
    elif case == "odd_width":
        x = torch.zeros(1, 4, 6)
        p = [torch.zeros(6, 3 * HIDDEN), torch.zeros(HIDDEN, 6)] + [torch.zeros(6)] * 5
    elif case == "misaligned":
        p[2] = torch.zeros(65)[1:]
    elif case == "wide":
        x = torch.zeros(1, 4, 1024)
        p = [torch.zeros(1024, 3 * HIDDEN), torch.zeros(HIDDEN, 1024)] + [torch.zeros(1024)] * 5
    return x, p, kw, dtype


@pytest.mark.parametrize("case", ["heads", "rank", "dtype_mismatch", "fp16",
                                  "non_contiguous", "weight_shape", "weight_dtype",
                                  "weight_layout", "misaligned", "odd_width", "wide"])
def test_kernel_argument_checks_raise(case):
    """What the CUDA wrapper refuses before it launches (the checks run the
    same on any device, so they are tested here)."""
    x, p, kw, dtype = _bad_args(case)
    with pytest.raises(ValueError):
        la._check_cuda_args(x, p, kw["heads"], kw["dim_head"], dtype)


def test_kernel_refuses_grad():
    """The raw kernel launchers are not differentiable: a call that autograd
    would track raises there.  The dispatching op sends such calls through
    LinearAttentionBlockFn instead, whose forward runs with grad mode off."""
    x, *p = torch_args(make_inputs(2, 16, 64, seed=6))
    p[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        la._check_cuda_args(x, p, HEADS, DIM_HEAD, torch.float32)
    with torch.no_grad():
        la._check_cuda_args(x, p, HEADS, DIM_HEAD, torch.float32)
    y = la.linear_attention_block(x, *p, **KW)
    assert type(y.grad_fn).__name__ == "LinearAttentionBlockFnBackward"


def test_kernel_module_imports_without_nvcc(tmp_path):
    """Importing the kernels' modules builds nothing and needs no nvcc."""
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(tmp_path))
    code = ("import ldm_tpu_torch.ops.linear_attention as la, ldm_tpu_torch.ops.build as b; "
            "assert b.build.cache_info().currsize == 0; "
            "assert la.FWD_LIB.cdll is None and la.BWD_LIB.cdll is None; "
            "print(la.launches.read(la.FWD_LIB.name), la.launches.read(la.BWD_LIB.name))")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "0 0"


def test_unet_block_reshapes_its_weights_once_per_version():
    """LinAttnBlock hands the kernels its 1x1-conv weights as contiguous
    copies in the compute type, in both orientations, made once, and made
    again only after the weights change (load_state_dict, an optimizer step,
    any in-place update) or move, or when the compute type changes."""
    from ldm_tpu_torch.models.unet import LinAttnBlock

    block = LinAttnBlock(64)
    attn, out_conv, out_norm = block.fn.fn, *block.fn.fn.to_out
    w = block.kernel_weights(torch.bfloat16)
    assert block.kernel_weights(torch.bfloat16) is w  # cached: no copy per call
    assert w.wqkv is None and w.wout is None  # the forward reads the transposes alone
    wq, wo = attn.to_qkv.weight.view(-1, 64), out_conv.weight.view(64, -1)
    torch.testing.assert_close(w.wqkv_t, wq.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(w.wout_t, wo.to(torch.bfloat16), rtol=0, atol=0)
    full = block.kernel_weights(torch.bfloat16, backward=True)  # a backward asks for all four
    assert full is not w
    assert block.kernel_weights(torch.bfloat16) is full
    assert block.kernel_weights(torch.bfloat16, backward=True) is full
    torch.testing.assert_close(full.wqkv, wq.t().to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(full.wout, wo.t().to(torch.bfloat16), rtol=0, atol=0)
    for name, t_ in full._asdict().items():
        assert t_.is_contiguous() and t_.dtype == torch.bfloat16 and not t_.requires_grad, name
    params = [wq.t(), wo.t(), out_conv.bias, block.fn.norm.weight, block.fn.norm.bias,
              out_norm.weight, out_norm.bias]
    x = torch.zeros(2, 16, 64, dtype=torch.bfloat16)
    with torch.no_grad():
        # views of any strides pass beside the kernels' copies; alone they do not
        la._check_cuda_args(x, params, HEADS, DIM_HEAD, torch.bfloat16, weights=full)
        with pytest.raises(ValueError, match="contiguous"):
            la._check_cuda_args(x, params, HEADS, DIM_HEAD, torch.bfloat16)
        wrong = full._replace(wqkv_t=full.wqkv_t.float())
        with pytest.raises(ValueError, match="kernel weight wqkv_t"):
            la._check_cuda_args(x, params, HEADS, DIM_HEAD, torch.bfloat16, weights=wrong)

    fp32 = block.kernel_weights(torch.float32, backward=True)  # another compute type
    assert fp32.wqkv_t.dtype == torch.float32 and fp32 is not full
    assert block.kernel_weights(torch.float32) is fp32
    torch.testing.assert_close(fp32.wqkv, wq.t(), rtol=0, atol=0)

    sd = {k: torch.randn_like(v) for k, v in block.state_dict().items()}
    block.load_state_dict(sd)
    w2 = block.kernel_weights(torch.bfloat16, backward=True)
    assert block.kernel_weights(torch.bfloat16, backward=True) is w2
    torch.testing.assert_close(w2.wqkv, sd["fn.fn.to_qkv.weight"].view(-1, 64).t()
                               .to(torch.bfloat16), rtol=0, atol=0)
    with torch.no_grad():
        out_conv.weight.mul_(2)
    torch.testing.assert_close(block.kernel_weights(torch.bfloat16).wout_t,
                               (2 * sd["fn.fn.to_out.0.weight"].view(64, -1))
                               .to(torch.bfloat16), rtol=0, atol=0)


def test_unet_block_remakes_its_weights_after_an_optimizer_step():
    """The trainer's optimizer (foreach Adam) bumps the parameters' versions,
    so the next call makes new copies, with the new values; a call with
    nothing changed in between makes none."""
    from ldm_tpu_torch.models.unet import LinAttnBlock

    torch.manual_seed(0)
    block = LinAttnBlock(64)
    opt = torch.optim.Adam(block.parameters(), lr=1e-2, foreach=True)
    before = block.kernel_weights(torch.bfloat16, backward=True)
    x = torch.randn(2, 64, 4, 4)
    block(x).square().mean().backward()  # a CPU tensor: the plain versions, no copies
    assert block._kernel_w is before
    assert block.kernel_weights(torch.bfloat16, backward=True) is before
    assert block.fn.fn.to_qkv.weight.grad.abs().max() > 0
    assert block.fn.fn.to_out[0].weight.grad.abs().max() > 0
    opt.step()
    after = block.kernel_weights(torch.bfloat16, backward=True)
    assert after is not before
    assert not torch.equal(after.wqkv_t, before.wqkv_t)
    torch.testing.assert_close(after.wqkv_t, block.fn.fn.to_qkv.weight.detach().view(-1, 64)
                               .to(torch.bfloat16), rtol=0, atol=0)
    assert block.kernel_weights(torch.bfloat16, backward=True) is after


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_make_kernel_weights(dtype):
    """Both orientations of both projections, contiguous, in the compute type;
    a weight that already is what the kernels read is not copied."""
    wqkv, wout = torch_args(make_inputs(1, 16, 64, seed=9))[1:3]
    conv_q = wqkv.t().contiguous()  # the UNet's layout, (3H, C); the op sees its transpose
    w = la.make_kernel_weights(conv_q.t(), wout, dtype)
    for got, want in zip(w, (wqkv, wqkv.t(), wout, wout.t())):
        assert got.is_contiguous() and got.dtype == dtype
        torch.testing.assert_close(got, want.to(dtype), rtol=0, atol=0)
    if dtype == torch.float32:
        assert w.wqkv_t.data_ptr() == conv_q.data_ptr() and w.wout.data_ptr() == wout.data_ptr()
    fwd_only = la.make_kernel_weights(conv_q.t(), wout, dtype, backward=False)
    assert fwd_only.wqkv is None and fwd_only.wout is None
    torch.testing.assert_close(fwd_only.wout_t, wout.t().to(dtype), rtol=0, atol=0)


# (N, C) of the 32px flagship UNet's 8 sites, the 64px UNet's and the 128px one
# that chip_smoke.py checks on the card
KERNEL_SHAPES = [(1024, 64), (256, 128), (64, 256), (16, 512), (16, 256), (64, 128), (256, 64),
                 (1024, 64), (4096, 64), (1024, 128), (256, 256), (64, 512), (16384, 64)]


# (N, C) of every attention site the benchmark's configurations reach: the
# 32px flagship UNet's 8 (sampling and training), its 128px UNet's 4, the
# latent UNet's 2; the 64px UNet's, and the smoke config's two narrow ones
CONFIG_SHAPES = sorted(set(KERNEL_SHAPES) | {(4096, 128), (1024, 256), (256, 512), (16, 128),
                                             (16, 64), (256, 16), (64, 16)})
# the batches the kernel sees there: 2B of the samplers and the service, B of
# the train steps, the small batches of a request, and batches past one
# unit a team
BATCHES = (1, 7, 20, 64, 128, 256, 1000)


def _persistent_sites(plan, n):
    """What the plan's units hold: for each unit of a B-item launch, the
    (item, first row, rows) slices its CTAs own, as the kernel walks them."""
    def units(b):
        for u in range(b):
            yield u, [(u, rank * plan.rows, plan.rows) for rank in range(plan.cs)]
    return units


def _two_team_plan(n, c, cs):
    """The persistent plan with the unit of ``cs`` CTAs an item and two
    teams, as the plan tries its layouts; None where two units do not fit."""
    plans = (la._persistent_layout(n, c, cs, 2, keep_q, *o) for keep_q in (0, 1)
             for o in la.PERSISTENT_OPTIONS)
    return next((p for p in plans if p is not None), None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", KERNEL_SHAPES)
def test_fwd_plan_is_a_function_of_the_shape(n, c, dtype):
    """plan_fwd: the same answer every time for the same (B, N, C, dtype).
    bf16 takes the persistent path where two units fit: the rows of an item
    split evenly over 1-16 CTAs, at least a 64-row tile each (16 at
    N = 1024), the buffers 16-byte aligned, in order and inside the 232,448
    bytes a block can take; units of 128 rows where two fit, with q out of
    shared memory, else 64 with q | k | v kept.  fp32, the shapes whose
    units do not fit, and those where the cluster path timed faster
    (la.CLUSTER_FASTER), take the cluster or tiled path: an item over
    cluster_size(N) CTAs, what is kept in shared memory with its room."""
    for b in BATCHES:
        plan = la.plan_fwd(n, c, dtype, b)
        assert plan == la.plan_fwd(n, c, dtype, b)
        assert plan.smem_bytes <= la.SMEM_LIMIT == 232_448
        assert plan.cs * plan.rows == n
        if dtype == torch.bfloat16 and n <= 1024 and c <= 256:
            # the 32px sites, the 64px ones up to N = 1024, but where the
            # cluster path timed faster
            faster = la.cluster_faster(n, c, b)
            assert plan.path == ("cluster" if faster else "persistent")
        if dtype == torch.bfloat16 and plan.path == "tiled":  # two units do not fit
            assert la.plan_persistent(n, c, b) is None
        if plan.path == "persistent":
            # two units in flight an SM, one where the launch has no more
            # units than the card has SMs
            units = b * plan.cs
            assert dtype == torch.bfloat16 and plan.teams == (1 if units <= la.SMS else 2)
            # slices of 128 rows where two fit (64 where the batch has fewer
            # 128-row ones than the card has SMs), larger with one team
            assert plan.cs in (1, 2, 4, 8, 16) and plan.rows in (16, 64, 128, 256)
            if plan.teams == 2 and n >= 256:
                assert plan.rows == (128 if b * n >= 128 * la.SMS else 64)
            assert plan.rows >= 64 or plan.cs == 1
            assert plan.keep_q == (plan.rows < 128)
            assert plan.off_w == 0 and plan.u_qkv == 0
            offs = [plan.off_bar, plan.off_unit]
            unit = [plan.u_a, plan.u_b, plan.u_vec, plan.unit_bytes]
            assert offs == sorted(offs) and unit == sorted(unit)
            assert all(o % 16 == 0 for o in offs + unit)
            assert plan.off_unit + plan.teams * plan.unit_bytes == plan.smem_bytes
            assert plan.off_bar >= (3 * HIDDEN * (c + 8) * 2 if plan.stage_w else 0)
            assert plan.u_a == plan.qrows * ((3 if plan.keep_q else 2) * HIDDEN + 8) * 2
            assert plan.qrows % 16 == 0 and plan.qrows >= plan.rows
            assert len(plan.ints()) == 16
            continue
        assert plan.cs == la.cluster_size(n) == {16: 1, 64: 1, 256: 2, 1024: 8, 4096: 8,
                                                 16384: 8}[n]
        offs = [plan.off_tile, plan.off_ctxn, plan.off_vec, plan.off_u, plan.off_qkv,
                plan.smem_bytes]
        assert offs == sorted(offs) and all(o % 16 == 0 for o in offs)
        es, pad = dtype.itemsize, 16 // dtype.itemsize
        tile = plan.off_ctxn - plan.off_tile
        assert tile >= 64 * (c + pad) * es and tile >= 2 * 64 * (HIDDEN + pad) * es
        assert tile >= HIDDEN * DIM_HEAD * 4 + 2 * 256 * 4  # the partial ctx blocks and k sums
        if plan.keep:
            assert plan.smem_bytes - plan.off_qkv == plan.rows * (3 * HIDDEN + pad) * es
            assert plan.off_out - plan.off_u == c * (HIDDEN + pad) * es
            assert plan.off_qkv - plan.off_out >= plan.rows * (c + pad) * es
        else:
            assert plan.off_qkv == plan.smem_bytes
        if plan.stage_w:
            assert plan.off_qkv - plan.off_u >= 3 * HIDDEN * (c + pad) * es
        assert plan.path == ("cluster" if plan.keep else "tiled")
        assert len(plan.ints()) == 10
    if dtype == torch.float32:
        assert plan.path in ("cluster", "tiled")  # the persistent path is the bf16 forward's
    if n == 16384:
        assert plan.path == "tiled"  # too large for a unit, and for a CTA


def test_plans_refuse_what_no_path_takes():
    for bad in ((64, 8), (64, 24), (0, 64), (64, 1024)):
        with pytest.raises(ValueError):
            la.plan_fwd(*bad, torch.float32)
        with pytest.raises(ValueError):
            la.plan_fwd(*bad, torch.bfloat16, 64)
    with pytest.raises(ValueError):
        la.plan_fwd(64, 64, torch.float16)
    with pytest.raises(ValueError):
        la.plan_fwd(64, 64, torch.bfloat16, 0)
    # the backward's split: rows evenly, at least 128 a CTA
    assert [la.cluster_size(n) for n in (96, 100, 128, 384, 512)] == [1, 1, 1, 2, 4]
    # the persistent forward's: at least 128 rows a CTA where two such units
    # fit (q out of shared memory), else at least one 64-row tile, up to 16
    # CTAs
    assert [la.plan_fwd(n, 64, torch.bfloat16, 256).cs for n in (96, 100, 128, 384, 512)] == \
        [1, 1, 1, 2, 4]
    # at 2B=20 those slices would leave SMs idle: 64 rows a CTA
    assert [la.plan_fwd(n, 64, torch.bfloat16, 20).cs for n in (96, 100, 128, 384, 512)] == \
        [1, 1, 2, 4, 8]


@pytest.mark.parametrize("n,c", CONFIG_SHAPES)
def test_persistent_plan_fits_two_units(n, c):
    """Every site the configurations reach that takes the persistent path
    holds two units at once beside the staged weight (when staged), inside
    the 232,448 bytes of a block, at every batch (the plan takes one where
    the batch has no more units than SMs); the sites whose units do not fit
    say so by taking the tiled path, and those where the cluster path timed
    faster take that."""
    for b in BATCHES:
        picked = la.plan_fwd(n, c, torch.bfloat16, b)
        if la.cluster_faster(n, c, b):
            assert picked.path == "cluster"
            picked = la.plan_persistent(n, c, b)
        if picked is None or picked.path != "persistent":
            assert (n, c) in {(4096, 64), (16384, 64), (4096, 128), (64, 512), (256, 512)}
            assert la.plan_fwd(n, c, torch.bfloat16, b).path == "tiled"
            assert la.plan_persistent(n, c, b) is None
            continue
        plan = _two_team_plan(n, c, picked.cs)
        assert plan is not None and picked.teams in (1, 2)
        assert plan.teams == 2 and plan.smem_bytes <= la.SMEM_LIMIT
        if not plan.keep_q:  # q's tiles come back into k | v's rows past the first 64
            assert plan.qrows >= 128
        w = 3 * HIDDEN * (c + 8) * 2 if plan.stage_w else 0
        assert plan.off_unit >= w + 2 * plan.teams * 8  # the weight, then 2 mbarriers a team
        # a unit's buffers: q | k | v (or k | v), then the h tile / partial
        # ctx / ctx_w^T, then ctx and out, then the vectors; with q out of
        # shared memory the partial ctx and ctx lie in k | v's rows 64-127
        assert plan.u_b - plan.u_a >= min(64, plan.qrows) * (c + 8) * 2
        if plan.keep_q:
            if plan.cs > 1:
                assert plan.u_b - plan.u_a >= HIDDEN * DIM_HEAD * 4
            assert plan.u_vec - plan.u_b >= HIDDEN * (DIM_HEAD + 8) * 2
        else:
            assert 32 * (2 * HIDDEN + 8) * 2 >= max(HIDDEN * DIM_HEAD * 4,
                                                    HIDDEN * (DIM_HEAD + 8) * 2)
        if plan.keep_cw:
            assert plan.u_b - plan.u_a >= c * (HIDDEN + 8) * 2
        if plan.keep_out:  # out lies over ctx, which it outlives
            assert plan.u_vec - plan.u_b >= plan.qrows * (c + 8) * 2
        assert plan.unit_bytes - plan.u_vec >= 4 * (5 * HIDDEN + 14)


@pytest.mark.parametrize("b", BATCHES + (2, 3, 21, 263, 264, 265, 527))
@pytest.mark.parametrize("n,c", [(1024, 64), (256, 128), (64, 256), (16, 512), (16, 64),
                                 (100, 64), (384, 64), (32, 64)])
def test_persistent_units_tile_every_row_once(n, c, b):
    """The units of a B-item launch, as the kernel walks them (unit u: item
    u, each CTA of the cluster its slice of N / cs rows), cover every row of
    every item exactly once, and every unit goes to exactly one team
    whatever the number of clusters the card holds."""
    plan = la.plan_persistent(n, c, b)
    assert plan is not None and plan.path == "persistent"
    units = dict(_persistent_sites(plan, n)(b))
    seen = {}
    for _, slices in units.items():
        for item, first, rows in slices:
            for r in range(first, first + rows):
                seen[item, r] = seen.get((item, r), 0) + 1
    assert seen == {(i, r): 1 for i in range(b) for r in range(n)}
    for groups in (1, 3, 8, 66, 132 // plan.cs):
        stride = plan.teams * groups
        taken = sorted(u for g in range(groups) for t in range(plan.teams)
                       for u in range(t * groups + g, len(units), stride))
        assert taken == list(range(len(units)))


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("b", [20, 256, 264, 265, 600, 1000, 1055, 4096])
def test_persistent_plan_packs_whole_items(n, b):
    """At N < 64 a unit is one whole item, on one CTA, its rows padded to
    the mma's 16 and not to a 64-row tile; two teams once the batch has more
    items than the card has SMs."""
    plan = la.plan_fwd(n, 64, torch.bfloat16, b)
    assert plan.path == "persistent" and plan.cs == 1 and plan.rows == n
    assert plan.qrows == n and plan.keep_q  # the whole item, no padding rows
    assert plan.teams == (1 if b <= la.SMS else 2)
    assert plan == la.plan_persistent(n, 64, b)


@pytest.mark.parametrize("where", ["env", "checkout", "installed"])
def test_build_dir(where, tmp_path, monkeypatch):
    """Libraries go to $LDM_TPU_TORCH_BUILD_DIR, else the checkout's git-ignored
    build/, else (an installed package) the user's cache, never the prefix."""
    from ldm_tpu_torch.ops import build

    monkeypatch.delenv("LDM_TPU_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    if where == "env":
        monkeypatch.setenv("LDM_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
        want = tmp_path / "b"
    elif where == "checkout":
        want = build.CHECKOUT / "build" / "ldm_tpu_torch"
    else:
        monkeypatch.setattr(build, "CHECKOUT", tmp_path / "lib" / "python3" / "site-packages")
        want = tmp_path / "home" / ".cache" / "ldm_tpu_torch"
    assert build.build_dir() == want
    assert all(build.lib_path(src).parent == want for src in build.sources())


def test_build_without_nvcc_raises_and_leaves_no_files(tmp_path, monkeypatch):
    """No nvcc: build() raises with what to set, and leaves no temporary
    library behind in the build directory."""
    from ldm_tpu_torch.ops import build

    monkeypatch.setenv("LDM_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "no_bin"))
    build.build.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build()
    finally:
        build.build.cache_clear()
    assert list((tmp_path / "b").iterdir()) == []
