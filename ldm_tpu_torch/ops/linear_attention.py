"""Fused linear-attention block: the Hopper kernel and its plain PyTorch version.

The port of ldm_tpu/ops/linear_attention.py.  The UNet's per-level attention
block, Residual(PreNorm(LinearAttention)), runs as one op:

    h   = GroupNorm1(x)
    qkv = h @ Wqkv
    q   = softmax_per_head_over_d(q) * d^-0.5
    k   = softmax_over_N(k)
    ctx = k^T v   (per head)
    o   = q @ (ctx @ Wout) + bout
    y   = x + GroupNorm2(o)

* :func:`linear_attention_block_torch` is the plain version, written line for
  line after ``linear_attention_block_xla`` (same signature, same cast points:
  matmul inputs in the compute type, fp32 norm statistics and softmax sums,
  output in ``x.dtype``).
* :func:`linear_attention_block` dispatches on the tensor's device: a CPU
  tensor takes the plain version; a CUDA tensor launches the hand-written
  kernel (``csrc/linear_attention_fwd.cu``) or raises.  There is no fallback
  from CUDA to the plain version.  ``linear_attention_block.launches`` counts
  the kernel's launches.

Forward only: sampling is the slice this package carries so far.
"""

from __future__ import annotations

import torch

from ldm_tpu_torch.ops import build

HIDDEN = 128  # heads * dim_head the kernel is written for
DIM_HEAD = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _block_diag_mask(heads: int, dim_head: int, dtype, device) -> torch.Tensor:
    return torch.kron(
        torch.eye(heads, dtype=dtype, device=device),
        torch.ones((dim_head, dim_head), dtype=dtype, device=device),
    )


def linear_attention_block_torch(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    wout: torch.Tensor,
    bout: torch.Tensor,
    gn1_scale: torch.Tensor,
    gn1_bias: torch.Tensor,
    gn2_scale: torch.Tensor,
    gn2_bias: torch.Tensor,
    *,
    heads: int,
    dim_head: int,
    eps: float = 1e-5,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version of the fused block (linear_attention_block_xla).

    Args:
      x: (B, N, C) tokens (flattened H*W grid).
      wqkv: (C, 3*heads*dim_head) fused qkv projection, no bias.
      wout/bout: (heads*dim_head, C) / (C,) output projection.
      gn{1,2}_scale/bias: (C,) GroupNorm affine params (pre-norm / post-norm).
    """
    hidden = heads * dim_head
    cd = compute_dtype
    f32 = torch.float32
    xf32 = x.to(f32)
    mean = xf32.mean(dim=(1, 2), keepdim=True)
    var = xf32.var(dim=(1, 2), keepdim=True, correction=0)
    h = ((xf32 - mean) * torch.rsqrt(var + eps) * gn1_scale + gn1_bias).to(cd)

    w = wqkv.to(cd)
    q = h @ w[:, :hidden]
    k = h @ w[:, hidden : 2 * hidden]
    v = h @ w[:, 2 * hidden :]

    # q: per-head softmax over dim_head; the row max over all lanes is a valid
    # shift for every head; per-head sums via a block-diagonal ones matmul in
    # fp32 (the products of values in the compute type are exact in fp32)
    seg = _block_diag_mask(heads, dim_head, cd, x.device)
    q_shift = q.to(f32).amax(dim=-1, keepdim=True).to(cd)
    q_e = torch.exp(q - q_shift)
    q_sum = q_e.to(f32) @ seg.to(f32)
    q = (q_e.to(f32) / q_sum * (dim_head**-0.5)).to(cd)

    # k: softmax over N; the per-(b, d) normalisation commutes out of the
    # context product, so only exp(k - max) is materialised
    k_shift = k.to(f32).amax(dim=1, keepdim=True).to(cd)
    k_e = torch.exp(k - k_shift)
    k_sum = k_e.to(f32).sum(dim=1)  # (B, hidden)

    ctx = torch.einsum("bnd,bne->bde", k_e, v).to(f32)
    ctx = ctx * (seg.to(f32) / k_sum[:, :, None])
    ctx_w = torch.einsum("bde,ec->bdc", ctx.to(cd), wout.to(cd))
    out = torch.einsum("bdc,bnd->bnc", ctx_w, q) + bout.to(cd)

    of32 = out.to(f32)
    mean2 = of32.mean(dim=(1, 2), keepdim=True)
    var2 = of32.var(dim=(1, 2), keepdim=True, correction=0)
    o = (of32 - mean2) * torch.rsqrt(var2 + eps) * gn2_scale + gn2_bias
    return (x.to(f32) + o).to(x.dtype)


def _check_cuda_args(x, params, heads, dim_head, compute_dtype) -> None:
    """Raise on anything the kernel does not take."""
    if heads * dim_head != HIDDEN or dim_head != DIM_HEAD:
        raise ValueError(
            f"kernel is written for heads*dim_head={HIDDEN}, dim_head={DIM_HEAD}; "
            f"got heads={heads}, dim_head={dim_head}"
        )
    if x.dim() != 3:
        raise ValueError(f"x must be (B, N, C), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or compute_dtype != x.dtype:
        raise ValueError(
            f"kernel takes x in float32 or bfloat16 with the same compute dtype; "
            f"got x {x.dtype}, compute {compute_dtype}"
        )
    b, n, c = x.shape
    # C <= 768 keeps a 64-row tile of C fp32 values in shared memory
    if b < 1 or n < 1 or not 4 <= c <= 768 or c % 4:
        raise ValueError(
            f"kernel takes B, N >= 1 and C a multiple of 4 in [4, 768], got {b, n, c}"
        )
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    shapes = [(c, 3 * HIDDEN), (HIDDEN, c)] + [(c,)] * 5
    names = ("wqkv", "wout", "bout", "gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias")
    for name, p, shape in zip(names, params, shapes):
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
        if p.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {p.dtype}")
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(p.shape)}")
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise RuntimeError(
            "the kernel is forward-only: call it under torch.no_grad() or "
            "torch.inference_mode()"
        )


def _launch_kernel(x, params, *, heads, dim_head, eps, compute_dtype) -> torch.Tensor:
    _check_cuda_args(x, params, heads, dim_head, compute_dtype)
    b, n, c = x.shape
    lib = build.load()
    y = torch.empty_like(x)
    qkv_scratch = torch.empty((b, n, 3 * HIDDEN), dtype=x.dtype, device=x.device)
    cw_scratch = torch.empty((b, HIDDEN, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ldm_lin_attn_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), *(p.data_ptr() for p in params),
            y.data_ptr(), qkv_scratch.data_ptr(), cw_scratch.data_ptr(),
            b, n, c, float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"linear-attention kernel launch failed: CUDA error {err}")
    linear_attention_block.launches += 1
    return y


def linear_attention_block(
    x, wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias,
    *, heads: int, dim_head: int, eps: float = 1e-5,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The fused block: the plain version for a CPU tensor, the Hopper kernel
    for a CUDA tensor (which raises on what the kernel does not take)."""
    params = (wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias)
    kw = dict(heads=heads, dim_head=dim_head, eps=eps, compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        return linear_attention_block_torch(x, *params, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no linear-attention implementation for device {x.device}")
    return _launch_kernel(x, params, **kw)


linear_attention_block.launches = 0  # kernel launches, counted where they happen
