"""Fused UNet ResNet block: the Hopper kernel and its plain PyTorch version.

The port of ldm_tpu/ops/resnet_block.py.  The UNet's ResNet block as one op:

    h = GroupNorm8(x); h = silu(h); h = conv3x3(h) + b1     # Block 1
    h = h + temb[:, None, None, :]                          # time row
    h = GroupNorm8(h); h = silu(h); h = conv3x3(h) + b2     # Block 2
    y = h + (x if no shortcut else x @ ws + bs)             # shortcut

The JAX package's layout is kept at the public functions: NHWC x, HWIO conv
weights, an already-projected ``temb`` (B, C_out) (zeros for an
unconditioned block), and ``(1, 1)`` dummies for ``ws`` / ``bs`` when there
is no shortcut.  Like the JAX op it is not wired into the UNet.

* :func:`resnet_block_torch` is the plain version, written line for line
  after ``resnet_block_xla`` with its cast points.
* :func:`resnet_block_cuda` launches the Hopper kernel
  (``csrc/resnet_block_fwd.cu``), which has the TPU kernel's cast points
  (in bf16: SiLU in fp32, conv2's sum, bias and shortcut in fp32).
* :class:`ResNetBlockFn` is the counterpart of the custom VJP: the forward
  is the kernel for a CUDA tensor and the plain version for a CPU tensor;
  the backward recomputes through :func:`resnet_block_torch`, the reference's
  own policy (there is no backward kernel for this block).
* :func:`resnet_block` dispatches as ``linear_attention_block`` does.  A
  CUDA tensor launches the kernel or raises; ``resnet_block.launches``
  counts the kernel's launches (one per block, four CUDA kernels each).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ldm_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_C = 768  # the widest C_in / C_out the kernel's statistics hold


def resnet_block_torch(
    x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs,
    *, groups: int, eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32,
    use_shortcut: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version of the block (resnet_block_xla), on NHWC.

    Args:
      x: (B, H, W, C_in).
      temb: (B, C_out) projected time embedding row.
      n{1,2}s/n{1,2}b: GroupNorm scale/bias, (C_in,) / (C_out,).
      w1/w2: (3, 3, C_in, C_out) / (3, 3, C_out, C_out) HWIO conv kernels.
      b1/b2: (C_out,) conv biases.
      ws/bs: (C_in, C_out) / (C_out,) 1x1 shortcut (ignored unless
        ``use_shortcut``).
    """
    cd = compute_dtype
    f32 = torch.float32
    bsz, hh, ww, cin = x.shape
    cout = w1.shape[-1]

    def gn_silu(t, scale, bias, c):
        tf = t.to(f32).reshape(bsz, hh * ww, groups, c // groups)
        mu = tf.mean(dim=(1, 3), keepdim=True)
        var = ((tf * tf).mean(dim=(1, 3), keepdim=True) - mu * mu).clamp_min(0.0)
        y = (tf - mu) * torch.rsqrt(var + eps)
        y = y.reshape(bsz, hh, ww, c) * scale.to(f32) + bias.to(f32)
        y = y.to(cd)
        return y * torch.sigmoid(y)

    def conv(t, w, b):
        # NHWC .permute is a channels_last NCHW view; HWIO -> OIHW
        out = F.conv2d(t.permute(0, 3, 1, 2), w.to(cd).permute(3, 2, 0, 1), padding=1)
        out = out.permute(0, 2, 3, 1)
        return out + b.to(out.dtype)

    h = conv(gn_silu(x, n1s, n1b, cin), w1, b1)
    h = h + temb.to(h.dtype)[:, None, None, :]
    h = conv(gn_silu(h, n2s, n2b, cout), w2, b2)
    if use_shortcut:
        sc = torch.einsum("bhwc,cd->bhwd", x.to(cd), ws.to(cd)) + bs.to(cd)
    else:
        sc = x
    return (h.to(f32) + sc.to(f32)).to(x.dtype)


def _check_cuda_args(x, temb, params, ws, bs, groups, compute_dtype, use_shortcut) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B, H, W, C_in), got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE or compute_dtype != x.dtype:
        raise ValueError(
            f"kernel takes x in float32 or bfloat16 with the same compute dtype; "
            f"got x {x.dtype}, compute {compute_dtype}"
        )
    b, h, w, cin = x.shape
    cout = params[2].shape[-1] if params[2].dim() == 4 else -1
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"kernel takes B, H, W >= 1, got {b, h, w}")
    for name, c in (("C_in", cin), ("C_out", cout)):
        if not 1 <= c <= MAX_C or c % groups:
            raise ValueError(f"kernel takes {name} in [1, {MAX_C}] divisible by "
                             f"groups={groups}, got {c}")
    if not use_shortcut and cin != cout:
        raise ValueError(f"identity shortcut needs C_in == C_out, got {cin} -> {cout}")
    if not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor")
    names = ("n1s", "n1b", "w1", "b1", "n2s", "n2b", "w2", "b2")
    shapes = [(cin,), (cin,), (3, 3, cin, cout), (cout,), (cout,), (cout,),
              (3, 3, cout, cout), (cout,)]
    checked = list(zip(names, params, shapes)) + [("temb", temb, (b, cout))]
    if use_shortcut:
        checked += [("ws", ws, (cin, cout)), ("bs", bs, (cout,))]
    for name, p, shape in checked:
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
        if p.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {p.dtype}")
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(p.shape)}")
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    tensors = (x, temb, *params) + ((ws, bs) if use_shortcut else ())
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the raw kernel launcher is not differentiable: call resnet_block, "
            "which routes grad-mode calls through ResNetBlockFn"
        )


def launch_args(x, temb, params, ws, bs, *, groups, eps, compute_dtype, use_shortcut):
    """Check the arguments, allocate the output and the scratch, and return
    (y, the C entry point's arguments after its dtype code); shared with the
    stage-ablation probe (ldm_tpu_torch/perf/probe13b.py)."""
    _check_cuda_args(x, temb, params, ws, bs, groups, compute_dtype, use_shortcut)
    b, h, w, cin = x.shape
    cout = params[2].shape[-1]
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    h1 = torch.empty_like(y)
    stats = torch.empty((2, b, groups, 2), dtype=torch.float32, device=x.device)
    sc = (ws.data_ptr(), bs.data_ptr()) if use_shortcut else (None, None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), temb.data_ptr(), *(p.data_ptr() for p in params), *sc,
            y.data_ptr(), h1.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            b, h, w, cin, cout, groups, float(eps), stream)
    # the scratch must outlive the launch: keep it with the output's arguments
    return y, args, (h1, stats)


def resnet_block_cuda(
    x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs,
    *, groups: int, eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32,
    use_shortcut: bool = False,
) -> torch.Tensor:
    """The Hopper kernel's launch (``csrc/resnet_block_fwd.cu``): four CUDA
    kernels on the current stream, no synchronisation."""
    params = (n1s, n1b, w1, b1, n2s, n2b, w2, b2)
    with torch.cuda.device(x.device):
        y, args, _scratch = launch_args(x, temb, params, ws, bs, groups=groups, eps=eps,
                                        compute_dtype=compute_dtype,
                                        use_shortcut=use_shortcut)
        err = build.load().ldm_resnet_block_fwd(_DTYPE_CODE[x.dtype], *args)
    if err != 0:
        raise RuntimeError(f"resnet-block kernel launch failed: CUDA error {err}")
    resnet_block.launches += 1
    return y


def _forward(x, temb, params, ws, bs, kw):
    """The plain version for a CPU tensor, the kernel for a CUDA tensor."""
    if x.device.type == "cpu":
        return resnet_block_torch(x, temb, *params, ws, bs, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no resnet-block implementation for device {x.device}")
    return resnet_block_cuda(x, temb, *params, ws, bs, **kw)


class ResNetBlockFn(torch.autograd.Function):
    """The block as an autograd op (the custom VJP of ``resnet_block``).

    Forward: the kernel on a CUDA tensor, the plain version on a CPU one.
    Backward: autograd of :func:`resnet_block_torch`, recomputed from the
    saved inputs."""

    @staticmethod
    def forward(ctx, x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs,
                groups, eps, compute_dtype, use_shortcut):
        kw = dict(groups=groups, eps=eps, compute_dtype=compute_dtype,
                  use_shortcut=use_shortcut)
        inputs = (x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs)
        y = _forward(x, temb, inputs[2:10], ws, bs, kw)
        ctx.save_for_backward(*inputs)
        ctx.kw = kw
        return y

    @staticmethod
    def backward(ctx, dy):
        inputs = [t.detach().requires_grad_(need)
                  for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t.requires_grad]
        grads = iter(())
        if wanted:
            with torch.enable_grad():
                y = resnet_block_torch(*inputs, **ctx.kw)
            grads = iter(torch.autograd.grad(y, wanted, dy, allow_unused=True))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None)


def resnet_block(
    x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs,
    *, groups: int = 8, eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32,
    use_shortcut: bool = False,
) -> torch.Tensor:
    """The fused block.  In grad mode with an input that requires grad:
    :class:`ResNetBlockFn`.  Otherwise the plain version for a CPU tensor and
    the kernel for a CUDA tensor (which raises on what it does not take)."""
    inputs = (x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs)
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return ResNetBlockFn.apply(*inputs, groups, eps, compute_dtype, use_shortcut)
    kw = dict(groups=groups, eps=eps, compute_dtype=compute_dtype, use_shortcut=use_shortcut)
    return _forward(x, temb, inputs[2:10], ws, bs, kw)


resnet_block.launches = 0  # kernel launches (one per block), counted where they happen
