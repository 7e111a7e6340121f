"""Adam and the EMA in one pass over every parameter leaf: the Hopper kernel
and its plain PyTorch version.

The port of ``fused_apply_gradients`` (ldm_tpu/training/state.py:78), the
JAX package's statement of the optimizer's whole update as one explicit pass
a leaf, with optax's association (and so within an ulp of the optax chain):

    m2 = b1 m + (1 - b1) g
    v2 = b2 v + (1 - b2) g g
    p2 = p - lr ((m2 / c1) / (sqrt(v2 / c2) + eps))
    e2 = d e + (1 - d) p2

in fp32, with ``c1 = 1 - b1**count`` and ``c2 = 1 - b2**count`` where
``count`` is Adam's step of the leaf after this update's increment.

* :func:`fused_adam_ema_torch` is the plain version, one leaf at a time,
  written after the JAX function's lines and rounding where they round.
* :func:`fused_adam_ema` dispatches: CPU tensors take the plain version; CUDA
  tensors launch ``csrc/fused_adam_ema.cu`` (one launch for up to 448 leaves)
  or raise; they count its launches as ``fused_adam_ema``
  (``utils/launches.py``, through ``LIB.count``).

Both update ``params``, the moments and the EMA in place and leave the step
counts alone: the caller increments them after the pass.  A leaf whose
gradient is None keeps its parameter and moments (torch's Adam skips such a
leaf, and its caller does not count its step) and only its EMA moves.  The
kernel writes through raw pointers, so the wrapper bumps the version
counters of the tensors it wrote, as an in-place PyTorch op does: the
attention blocks key their kernel copies of the weights on them
(``models/unet.py::LinAttnBlock._weights_key``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ldm_tpu_torch.ops import build

Tensors = Sequence[torch.Tensor]


def fused_adam_ema_torch(params: Tensors, grads: Sequence[Optional[torch.Tensor]],
                         exp_avgs: Tensors, exp_avg_sqs: Tensors,
                         emas: Optional[Tensors], count: Tensors, d: Optional[torch.Tensor],
                         lr: float, b1: float, b2: float, eps: float) -> None:
    """The plain version, in place.  ``count``: each leaf's Adam step (a 0-d
    fp32 tensor) before this update; ``d``: the EMA weight (a 0-d fp32
    tensor); ``emas=None``: no EMA stream (``d`` unused)."""
    emas = [None] * len(params) if emas is None else emas
    for p, g, m, v, e, s in zip(params, grads, exp_avgs, exp_avg_sqs, emas, count):
        if g is not None:
            n = s + 1.0
            # optax's tree_bias_correction: 1 - decay**count in fp32 (the
            # Python base is taken as an fp32 value)
            c1 = 1.0 - torch.pow(b1, n)
            c2 = 1.0 - torch.pow(b2, n)
            m.mul_(b1).add_(g * (1.0 - b1))
            v.mul_(b2).add_(g * (1.0 - b2) * g)
            p.sub_(lr * ((m / c1) / ((v / c2).sqrt() + eps)))
        if e is not None:
            e.mul_(d).add_(p * (1.0 - d))


def _check(params, grads, exp_avgs, exp_avg_sqs, emas, count, d) -> None:
    """What the kernel takes: contiguous fp32 leaves on one CUDA device, the
    streams of a leaf of one size, each step count and ``d`` 0-d fp32."""
    device = params[0].device
    if emas is not None and d is None:
        raise ValueError("an EMA needs its weight d")
    for i, p in enumerate(params):
        streams = [p, exp_avgs[i], exp_avg_sqs[i]]
        streams += [grads[i]] if grads[i] is not None else []
        streams += [emas[i]] if emas is not None else []
        for t in streams:
            if (t.device != device or t.dtype != torch.float32 or not t.is_contiguous()
                    or t.numel() != p.numel()):
                raise ValueError(f"leaf {i}: the kernel takes contiguous fp32 tensors of one "
                                 f"size on {device}, got {tuple(t.shape)} {t.dtype} on "
                                 f"{t.device} beside {tuple(p.shape)}")
    for t in [*count, *([d] if d is not None else [])]:
        if t.device != device or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"step counts and d must be one fp32 value on {device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")


LIB = build.Library("fused_adam_ema", {
    # leaves, the leaf table (7 rows of 64-bit words), d, lr, b1, b2, 1 - b1,
    # 1 - b2, eps, stream, launches made (out)
    "ldm_fused_adam_ema": ([ctypes.c_int, ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p,
                            *[ctypes.c_float] * 6, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_int)], ctypes.c_int),
    # the leaves one launch takes
    "ldm_fused_adam_ema_leaves": ([], ctypes.c_int)})


def _launch_kernel(params, grads, exp_avgs, exp_avg_sqs, emas, count, d,
                   lr, b1, b2, eps) -> int:
    """The kernel's launches over the table of the leaves, built anew from the
    tensors' addresses at every call; returns the launches made."""
    _check(params, grads, exp_avgs, exp_avg_sqs, emas, count, d)
    leaves = [i for i, p in enumerate(params)
              if p.numel() and (grads[i] is not None or emas is not None)]
    n = len(leaves)
    if n == 0:
        return 0

    def ptr(t: Optional[torch.Tensor]) -> int:
        return 0 if t is None else t.data_ptr()

    rows = [[ptr(params[i]) for i in leaves], [ptr(grads[i]) for i in leaves]]
    # a leaf without a gradient needs no moments or count
    rows += [[ptr(seq[i]) if grads[i] is not None else 0 for i in leaves]
             for seq in (exp_avgs, exp_avg_sqs)]
    rows.append([ptr(emas[i]) for i in leaves] if emas is not None else [0] * n)
    rows.append([ptr(count[i]) if grads[i] is not None else 0 for i in leaves])
    rows.append([params[i].numel() for i in leaves])
    table = (ctypes.c_longlong * (7 * n))(*(w for row in rows for w in row))
    launches = ctypes.c_int(0)
    device = params[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = LIB.ldm_fused_adam_ema(n, table, ptr(d), lr, b1, b2, 1.0 - b1, 1.0 - b2, eps,
                                     stream, ctypes.byref(launches))
    if err != 0:
        raise RuntimeError(f"fused Adam + EMA launch failed: CUDA error {err} ({n} leaves)")
    # the kernel wrote through raw pointers: the version counters an in-place
    # op would have bumped (one tensor a call: older releases take no list)
    for i in leaves:
        if grads[i] is not None:
            for t in (params[i], exp_avgs[i], exp_avg_sqs[i]):
                torch.autograd.graph.increment_version(t)
        if emas is not None:
            torch.autograd.graph.increment_version(emas[i])
    return launches.value


@torch.no_grad()
def fused_adam_ema(params: Tensors, grads: Sequence[Optional[torch.Tensor]],
                   exp_avgs: Tensors, exp_avg_sqs: Tensors, emas: Optional[Tensors],
                   count: Tensors, d: Optional[torch.Tensor],
                   lr: float, b1: float, b2: float, eps: float) -> None:
    """Adam and the EMA of every leaf, in place (see the module's docstring):
    the plain version for CPU tensors, the Hopper kernel for CUDA tensors
    (which raises on what it does not take)."""
    if not params:
        return
    device = params[0].device
    if device.type == "cpu":
        return fused_adam_ema_torch(params, grads, exp_avgs, exp_avg_sqs, emas, count, d,
                                    lr, b1, b2, eps)
    if device.type != "cuda":
        raise ValueError(f"fused_adam_ema runs on CPU or CUDA tensors, got {device}")
    LIB.count(_launch_kernel(params, grads, exp_avgs, exp_avg_sqs, emas, count, d, lr, b1, b2,
                             eps))
