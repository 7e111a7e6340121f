"""Fused linear-attention block: the Hopper kernels and their plain PyTorch versions.

The port of ldm_tpu/ops/linear_attention.py.  The UNet's per-level attention
block, Residual(PreNorm(LinearAttention)), runs as one op:

    h   = GroupNorm1(x)
    qkv = h @ Wqkv
    q   = softmax_per_head_over_d(q) * d^-0.5
    k   = softmax_over_N(k)
    ctx = k^T v   (per head)
    o   = q @ (ctx @ Wout) + bout
    y   = x + GroupNorm2(o)

* :func:`linear_attention_block_torch` is the plain forward, written line for
  line after ``linear_attention_block_xla`` (same signature, same cast points:
  matmul inputs in the compute type, fp32 norm statistics and softmax sums,
  output in ``x.dtype``).
* :func:`linear_attention_block_bwd_torch` is the plain backward, the
  hand-derived VJP of ``_fused_kernel_bwd``: it recomputes the forward from x
  and runs the chain back, with that kernel's cast points.
* :class:`LinearAttentionBlockFn` is the autograd op: forward and backward
  are the Hopper kernels (``csrc/linear_attention_fwd.cu``,
  ``csrc/linear_attention_bwd.cu``) for CUDA tensors and the plain versions
  for CPU tensors.
* :func:`linear_attention_block` dispatches: in grad mode, when an input
  requires grad, it runs :class:`LinearAttentionBlockFn`; otherwise a CPU
  tensor takes the plain forward and a CUDA tensor the forward kernel.  A
  CUDA tensor launches a kernel or raises: there is no fallback to the plain
  versions.  ``linear_attention_block.launches`` and
  ``linear_attention_block_bwd.launches`` count the kernels' launches.

The plain versions also take float64 (statistics then in float64 too), so
``torch.autograd.gradcheck`` can hold the backward against the forward.
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


def _stat_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """Type of statistics and accumulations: fp32, or fp64 for fp64 compute."""
    return torch.float64 if compute_dtype == torch.float64 else torch.float32


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
    acc = _stat_dtype(cd)
    xf = x.to(acc)
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = xf.var(dim=(1, 2), keepdim=True, correction=0)
    h = ((xf - mean) * torch.rsqrt(var + eps) * gn1_scale + gn1_bias).to(cd)

    w = wqkv.to(cd)
    q = h @ w[:, :hidden]
    k = h @ w[:, hidden : 2 * hidden]
    v = h @ w[:, 2 * hidden :]

    # q: per-head softmax over dim_head; the row max over all lanes is a valid
    # shift for every head; per-head sums via a block-diagonal ones matmul in
    # fp32 (the products of values in the compute type are exact in fp32)
    seg = _block_diag_mask(heads, dim_head, cd, x.device)
    q_shift = q.to(acc).amax(dim=-1, keepdim=True).to(cd)
    q_e = torch.exp(q - q_shift)
    q_sum = q_e.to(acc) @ seg.to(acc)
    q = (q_e.to(acc) / q_sum * (dim_head**-0.5)).to(cd)

    # k: softmax over N; the per-(b, d) normalisation commutes out of the
    # context product, so only exp(k - max) is materialised
    k_shift = k.to(acc).amax(dim=1, keepdim=True).to(cd)
    k_e = torch.exp(k - k_shift)
    k_sum = k_e.to(acc).sum(dim=1)  # (B, hidden)

    ctx = torch.einsum("bnd,bne->bde", k_e, v).to(acc)
    ctx = ctx * (seg.to(acc) / k_sum[:, :, None])
    ctx_w = torch.einsum("bde,ec->bdc", ctx.to(cd), wout.to(cd))
    out = torch.einsum("bdc,bnd->bnc", ctx_w, q) + bout.to(cd)

    of = out.to(acc)
    mean2 = of.mean(dim=(1, 2), keepdim=True)
    var2 = of.var(dim=(1, 2), keepdim=True, correction=0)
    o = (of - mean2) * torch.rsqrt(var2 + eps) * gn2_scale + gn2_bias
    return (x.to(acc) + o).to(x.dtype)


def linear_attention_block_bwd_torch(
    x: torch.Tensor,
    dy: torch.Tensor,
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
) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the fused block's backward (_fused_kernel_bwd).

    Recomputes the forward from x, then runs the hand-derived chain back
    (per item; mean/var over the whole (N, C) slab):

        GN:    dA = (dÂ - mean(dÂ) - Â*mean(dÂ*Â)) / sigma,  dÂ = dH*g
        q-sm:  dq = qn * (dqn - ((qn*dqn) @ seg) / s),  s = dim_head^-0.5
        k-sm:  dk = kn * (dkn - colsum_N(kn*dkn))
        ctx:   dkn = v @ dctx^T, dv = kn @ dctx, dctx = (dcw @ Wout^T) * seg
        out:   dqn = do @ cw^T, dcw = qn^T @ do, dWout = sum_b ctx^T @ dcw

    Cast points are the Pallas kernel's: every matmul input is rounded to the
    compute type and accumulated in fp32 (products of bf16 values are exact
    in fp32, so an fp32 matmul of the rounded values is that product), norm
    statistics and softmax sums in fp32, dy rounded to x.dtype.  The GN
    variances are two-pass, as the forward's.

    Returns (dx in x.dtype, dWqkv, dWout, dbout, dg1s, dg1b, dg2s, dg2b), the
    parameter grads in the parameters' dtype (fp32).
    """
    hidden = heads * dim_head
    cd = compute_dtype
    acc = _stat_dtype(cd)
    scale = dim_head**-0.5
    b, n, c = x.shape

    def rnd(t):  # round to the compute type, carry in the statistics type
        return t.to(cd).to(acc)

    def item_mean(t):
        return t.mean(dim=(1, 2), keepdim=True)

    def norm(t):
        mu = item_mean(t)
        inv = torch.rsqrt(item_mean((t - mu) ** 2) + eps)
        return (t - mu) * inv, inv

    seg = _block_diag_mask(heads, dim_head, acc, x.device)
    xf = x.to(acc)
    dyf = dy.to(x.dtype).to(acc)

    # ---- forward recompute
    xhat, inv1 = norm(xf)
    h = rnd(xhat * gn1_scale.to(acc) + gn1_bias.to(acc))
    w = rnd(wqkv)
    q, k, v = (rnd(h @ w[:, i * hidden : (i + 1) * hidden]) for i in range(3))
    q_e = rnd(torch.exp(rnd(q - q.amax(dim=-1, keepdim=True))))
    qn = rnd(q_e / (q_e @ seg) * scale)
    k_e = rnd(torch.exp(rnd(k - k.amax(dim=1, keepdim=True))))
    kn = rnd(k_e / k_e.sum(dim=1, keepdim=True))
    ctx = rnd((kn.transpose(1, 2) @ v) * seg)  # (B, H, H)
    wo = rnd(wout)
    cw = rnd(ctx @ wo)  # (B, H, C)
    o = qn @ cw + bout.to(acc)
    ohat, inv2 = norm(o)

    # ---- backward chain
    dg2s = (dyf * ohat).sum(dim=(0, 1))
    dg2b = dyf.sum(dim=(0, 1))
    dhat2 = dyf * gn2_scale.to(acc)
    do = (dhat2 - item_mean(dhat2) - ohat * item_mean(dhat2 * ohat)) * inv2
    dbout = do.sum(dim=(0, 1))
    do = rnd(do)
    dqn = do @ cw.transpose(1, 2)  # (B, N, H)
    dcw = rnd(qn.transpose(1, 2) @ do)  # (B, H, C)
    dwout = (ctx.transpose(1, 2) @ dcw).sum(dim=0)
    dctx = rnd((dcw @ wo.t()) * seg)  # (B, H, H)
    dkn = v @ dctx.transpose(1, 2)
    dv = kn @ dctx
    dk = kn * (dkn - (kn * dkn).sum(dim=1, keepdim=True))
    dq = qn * (dqn - (rnd(qn * dqn) @ seg) / scale)
    dqkv = rnd(torch.cat([dq, dk, dv], dim=-1))  # (B, N, 3H)
    dh = dqkv @ w.t()  # (B, N, C)
    dwqkv = h.reshape(b * n, c).t() @ dqkv.reshape(b * n, 3 * hidden)

    dg1s = (dh * xhat).sum(dim=(0, 1))
    dg1b = dh.sum(dim=(0, 1))
    dhat1 = dh * gn1_scale.to(acc)
    dx = dyf + (dhat1 - item_mean(dhat1) - xhat * item_mean(dhat1 * xhat)) * inv1
    grads = (dwqkv, dwout, dbout, dg1s, dg1b, dg2s, dg2b)
    params = (wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias)
    return (dx.to(x.dtype),) + tuple(g.to(p.dtype) for g, p in zip(grads, params))


MAX_C_BWD = 512  # the backward kernel's widest C (its shared-memory tiles)


def _check_cuda_args(x, params, heads, dim_head, compute_dtype, max_c=768) -> None:
    """Raise on anything the kernels do not take."""
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
    # C <= 768 keeps a 64-row tile of C fp32 values in shared memory (512
    # for the backward, whose tiles are wider)
    if b < 1 or n < 1 or not 4 <= c <= max_c or c % 4:
        raise ValueError(
            f"kernel takes B, N >= 1 and C a multiple of 4 in [4, {max_c}], got {b, n, c}"
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
            "the raw kernel launchers are not differentiable: call "
            "linear_attention_block, which routes grad-mode calls through "
            "LinearAttentionBlockFn"
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


def _launch_bwd_kernel(x, dy, params, *, heads, dim_head, eps, compute_dtype):
    """The backward kernels' launch: returns (dx, dWqkv, dWout, dbout, dg1s,
    dg1b, dg2s, dg2b).  ``params`` are the forward kernel's: wqkv row-major
    (C, 3H) and wout (H, C)."""
    _check_cuda_args(x, params, heads, dim_head, compute_dtype, max_c=MAX_C_BWD)
    b, n, c = x.shape
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != x.shape or dy.data_ptr() % 16:
        raise ValueError(f"dy must be a 16-byte aligned {tuple(x.shape)} tensor")
    lib = build.load()
    wqkv_t = params[0].t().contiguous()  # (3H, C): the dh product's operand
    f32 = dict(dtype=torch.float32, device=x.device)
    cdt = dict(dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    dwqkv = torch.empty((c, 3 * HIDDEN), **f32)
    dwout = torch.empty((HIDDEN, c), **f32)
    dvec = torch.empty((5, c), **f32)  # dbout, dg1s, dg1b, dg2s, dg2b
    splits = lib.ldm_lin_attn_bwd_splits(b, n, c)
    scratch = dict(
        qkv=torch.empty((b, n, 3 * HIDDEN), **cdt),
        dqkv=torch.empty((b, n, 3 * HIDDEN), **cdt),
        o=torch.empty((b, n, c), **f32),
        do=torch.empty((b, n, c), **cdt),
        cw=torch.empty((b, HIDDEN, c), **cdt),
        cw_t=torch.empty((b, c, HIDDEN), **cdt),
        stats=torch.empty((b, 2), **f32),
        pvec=torch.empty((b, 5, c), **f32),
        pwout=torch.empty((b, HIDDEN, c), **f32),
        pwqkv=torch.empty((splits, c, 3 * HIDDEN), **f32),
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ldm_lin_attn_bwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(),
            *(p.data_ptr() for p in params), wqkv_t.data_ptr(),
            dx.data_ptr(), dwqkv.data_ptr(), dwout.data_ptr(), dvec.data_ptr(),
            *(t.data_ptr() for t in scratch.values()),
            b, n, c, splits, float(eps), stream,
        )
    if err != 0:
        raise RuntimeError(f"linear-attention backward launch failed: CUDA error {err}")
    linear_attention_block_bwd.launches += 1
    return (dx, dwqkv, dwout, *dvec.unbind(0))


def linear_attention_block_bwd(
    x, dy, wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias,
    *, heads: int, dim_head: int, eps: float = 1e-5,
    compute_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, ...]:
    """The block's backward: the plain version for a CPU tensor, the Hopper
    kernels for a CUDA tensor (which raise on what they do not take)."""
    params = (wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias)
    kw = dict(heads=heads, dim_head=dim_head, eps=eps, compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        return linear_attention_block_bwd_torch(x, dy, *params, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no linear-attention implementation for device {x.device}")
    return _launch_bwd_kernel(x, dy, params, **kw)


linear_attention_block_bwd.launches = 0  # backward launches (3 kernels each)


class LinearAttentionBlockFn(torch.autograd.Function):
    """The fused block as an autograd op (``linear_attention_block_fused_grads``).

    Forward: the forward kernel on a CUDA tensor, the plain forward on a CPU
    one.  Backward: likewise the backward kernels or the plain backward; both
    recompute the forward from x, so only the inputs are saved.  The weights
    may come in as views of the UNet's 1x1-conv weights (``wqkv`` the (C, 3H)
    transpose of to_qkv's (3H, C)); the row-major copies the kernels read are
    made here, and the grads go back in the views' shapes, so autograd carries
    them to the convs' layouts.
    """

    @staticmethod
    def forward(ctx, x, wqkv, wout, bout, g1s, g1b, g2s, g2b,
                heads, dim_head, eps, compute_dtype):
        kw = dict(heads=heads, dim_head=dim_head, eps=eps, compute_dtype=compute_dtype)
        params = (wqkv, wout, bout, g1s, g1b, g2s, g2b)
        if x.device.type == "cuda":
            params = (wqkv.contiguous(), wout.contiguous()) + params[2:]
            # refuse now what the backward would refuse after the forward
            _check_cuda_args(x, params, heads, dim_head, compute_dtype, max_c=MAX_C_BWD)
            y = _launch_kernel(x, params, **kw)
        elif x.device.type == "cpu":
            y = linear_attention_block_torch(x, *params, **kw)
        else:
            raise ValueError(f"no linear-attention implementation for device {x.device}")
        ctx.save_for_backward(x, *params)
        ctx.kw = kw
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        grads = linear_attention_block_bwd(x, dy, *params, **ctx.kw)
        return (*grads, None, None, None, None)


def linear_attention_block(
    x, wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias,
    *, heads: int, dim_head: int, eps: float = 1e-5,
    compute_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The fused block.  In grad mode with an input that requires grad:
    :class:`LinearAttentionBlockFn`.  Otherwise the plain version for a CPU
    tensor and the forward kernel for a CUDA tensor (which raises on what the
    kernel does not take)."""
    params = (wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return LinearAttentionBlockFn.apply(x, *params, heads, dim_head, eps, compute_dtype)
    kw = dict(heads=heads, dim_head=dim_head, eps=eps, compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        return linear_attention_block_torch(x, *params, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no linear-attention implementation for device {x.device}")
    return _launch_kernel(x, params, **kw)


linear_attention_block.launches = 0  # forward kernel launches, counted where they happen
