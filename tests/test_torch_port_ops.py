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
from ldm_tpu_torch.ops import linear_attention as la

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
    before = la.linear_attention_block.launches
    got = la.linear_attention_block(*args, **KW)
    want = la.linear_attention_block_torch(*args, **KW)
    assert torch.equal(got, want)
    assert la.linear_attention_block.launches == before


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
            "assert b.build.cache_info().currsize == b.load.cache_info().currsize == 0; "
            "print(la.linear_attention_block.launches, la.linear_attention_block_bwd.launches)")
    r = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                       text=True, timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "0 0"


def test_unet_block_reshapes_its_weights_once_per_version():
    """LinAttnBlock hands the kernel its 1x1-conv weights as row-major (C, 3H)
    and (H, C) copies made once, and made again only after the weights
    change (load_state_dict, an in-place update) or move."""
    from ldm_tpu_torch.models.unet import LinAttnBlock

    block = LinAttnBlock(64)
    attn, out_conv, out_norm = block.fn.fn, *block.fn.fn.to_out
    wqkv, wout = block.kernel_weights()
    assert block.kernel_weights()[0] is wqkv  # cached: no copy per call
    torch.testing.assert_close(wqkv, attn.to_qkv.weight.view(-1, 64).t(), rtol=0, atol=0)
    torch.testing.assert_close(wout, out_conv.weight.view(64, -1).t(), rtol=0, atol=0)
    params = [wqkv, wout, out_conv.bias, block.fn.norm.weight, block.fn.norm.bias,
              out_norm.weight, out_norm.bias]
    with torch.no_grad():
        la._check_cuda_args(torch.zeros(2, 16, 64), params, HEADS, DIM_HEAD, torch.float32)

    sd = {k: torch.randn_like(v) for k, v in block.state_dict().items()}
    block.load_state_dict(sd)
    wqkv2, _ = block.kernel_weights()
    torch.testing.assert_close(wqkv2, sd["fn.fn.to_qkv.weight"].view(-1, 64).t(), rtol=0, atol=0)
    with torch.no_grad():
        out_conv.weight.mul_(2)
    torch.testing.assert_close(block.kernel_weights()[1],
                               2 * sd["fn.fn.to_out.0.weight"].view(64, -1).t(), rtol=0, atol=0)


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
