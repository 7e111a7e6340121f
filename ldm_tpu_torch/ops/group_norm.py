"""GroupNorm, and the SiLU after it, as one pass: the Hopper kernel and its
plain PyTorch version.

The model layer's norms (``models/unet.py::GroupNorm``, the VAE's too) keep
fp32 statistics and affine and hand back their input's type in
channels_last; a ResNet block puts a SiLU after its norms.

* :func:`group_norm_silu_torch` is the plain version, the model layer's
  chain as it was: ``F.group_norm(x.float(), ...).to(x.dtype,
  memory_format=channels_last)``, then ``F.silu`` with ``silu``.
* :func:`group_norm_silu` dispatches: a CPU tensor takes the plain version;
  a CUDA tensor launches ``csrc/group_norm_silu.cu`` (one launch a call) or
  raises; it counts its launches as ``group_norm_silu``
  (``utils/launches.py``).
* :func:`plan_group_norm` chooses the launch's shape from (H*W, C, G) alone:
  the threads a CTA, the CTAs that share an item (a thread-block cluster) or
  the items that share a CTA, and the chunks a thread holds in registers.
  Nothing depends on the batch, so an item's output does not either.

The kernel takes bf16 channels_last activations; the model layer sends it
those outside autograd (:func:`takes_kernel`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ldm_tpu_torch.ops import build

_CL = torch.channels_last
CTA_THREADS = 256    # the threads a CTA aims at
MIN_THREADS = 128    # small items share a CTA until it has this many
MAX_THREADS = 512    # the kernel's launch bound
MAX_CLUSTER = 8      # the portable cluster size
MAX_KR = 16          # chunks a thread may hold in registers (the kernel's templates)
K_TARGET = 8         # chunks a thread, where a cluster of up to 8 CTAs allows (4 and 16: slower)
SMEM_LIMIT = 232448  # dynamic shared memory a CTA can take on an H100


class GnPlan(NamedTuple):
    """The kernel's launch shape (``GnPlan`` in csrc/group_norm_silu.cu, in
    that order)."""

    cs: int       # CTAs in the cluster of one item
    items: int    # items a CTA (1 where cs > 1)
    pi: int       # rows of an item in a CTA (a row: one pixel, C / 8 threads)
    k: int        # 16-byte chunks a thread
    kr: int       # of which held in registers
    threads: int  # items * pi * C / 8
    smem: int     # dynamic shared-memory bytes


def smem_bytes(c: int, groups: int, cs: int, items: int, pi: int) -> int:
    """The kernel's shared memory (``layout`` in the source): the affine
    pairs, a thread's 8 channel sums a row, an item's channel sums, the
    cluster's exchange of partials, the means and rstds."""
    return (8 * items * c + 4 * items * pi * c + 4 * items * c + (8 * c if cs > 1 else 0)
            + 8 * items * groups)


def _check_shape(hw: int, c: int, groups: int) -> None:
    if hw < 1 or c < 8 or c % 8:
        raise ValueError(f"the GroupNorm kernel takes H*W >= 1 and C a multiple of 8, "
                         f"got H*W={hw}, C={c}")
    if groups < 1 or c % groups:
        raise ValueError(f"the GroupNorm kernel takes G dividing C, got G={groups}, C={c}")
    if c // 8 > MAX_THREADS:
        raise ValueError(f"the GroupNorm kernel takes C <= {8 * MAX_THREADS}, got {c}")


@functools.lru_cache(maxsize=None)
def plan_group_norm(hw: int, c: int, groups: int) -> GnPlan:
    """The launch shape for items of H*W pixels and C channels in G groups.

    A row of a CTA is one pixel's C / 8 chunks of 16 bytes.  A CTA takes
    about 256 threads in whole warps (``r0`` rows).  An item of at most
    ``r0`` pixels takes one row a pixel, and small ones share a CTA until it
    has 128 threads; a larger item takes ``r0`` rows of each of ``cs`` CTAs
    (a cluster, doubled until a thread has at most K_TARGET chunks, up to 8
    CTAs), each thread ``k`` chunks, the first 16 of them in registers."""
    _check_shape(hw, c, groups)
    nv = c // 8
    step = 32 // math.gcd(nv, 32)  # rows that make whole warps
    if nv * step <= CTA_THREADS:
        r0 = CTA_THREADS // (nv * step) * step
    else:
        r0 = step if nv * step <= MAX_THREADS else 1
    if hw <= r0:
        cs, items, pi, k = 1, max(1, MIN_THREADS // (hw * nv)), hw, 1
    else:
        cs, items, pi = 1, 1, r0
        while cs < MAX_CLUSTER and -(-hw // (cs * pi)) > K_TARGET:
            cs *= 2
        k = -(-hw // (cs * pi))
    kr = min(1 << (k - 1).bit_length(), MAX_KR)
    smem = smem_bytes(c, groups, cs, items, pi)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the GroupNorm kernel's buffers take {smem} bytes of shared memory "
                         f"at H*W={hw}, C={c}, G={groups}")
    return GnPlan(cs, items, pi, k, kr, items * pi * nv, smem)


def takes_kernel(x: torch.Tensor) -> bool:
    """Whether the model layer's norm of ``x`` runs as the kernel: a bf16
    CUDA tensor outside autograd (the samplers, serving, the decode).
    Everything else keeps the plain chain: fp32, the CPU, every train step."""
    return x.is_cuda and x.dtype == torch.bfloat16 and not torch.is_grad_enabled()


def group_norm_silu_torch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                          groups: int, eps: float, silu: bool = False) -> torch.Tensor:
    """The plain version: fp32 statistics and affine, the output in x's type
    and in channels_last, then the SiLU in that type with ``silu``."""
    y = F.group_norm(x.float(), groups, weight, bias, eps).to(x.dtype, memory_format=_CL)
    return F.silu(y) if silu else y


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> None:
    """What the kernel takes: a 4-d bf16 channels_last x, 16-byte aligned,
    and fp32 (C,) weight and bias on its device."""
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous(memory_format=_CL):
        raise ValueError(f"the GroupNorm kernel takes a 4-d bf16 channels_last tensor, got "
                         f"{tuple(x.shape)} {x.dtype} with strides {x.stride()}")
    if x.data_ptr() % 16:
        raise ValueError("the GroupNorm kernel takes a 16-byte aligned x")
    c = x.shape[1]
    for name, t in (("weight", weight), ("bias", bias)):
        if (t is None or t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != (c,) or not t.is_contiguous()):
            raise ValueError(f"the GroupNorm kernel takes an fp32 ({c},) {name} on {x.device}, "
                             f"got {None if t is None else (tuple(t.shape), t.dtype, t.device)}")


_P, _I = ctypes.c_void_p, ctypes.c_int
LIB = build.Library("group_norm_silu", {
    # x, gamma, beta, y, B, H*W, C, G, eps, silu, plan (host ints), stream
    "ldm_group_norm_silu": ([_P] * 4 + [_I] * 4 + [ctypes.c_float, _I, ctypes.POINTER(_I), _P],
                            _I)})


def _launch_kernel(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float, silu: bool) -> torch.Tensor:
    _check(x, weight, bias)
    b, c, h, w = x.shape
    plan = plan_group_norm(h * w, c, groups)
    y = torch.empty_like(x, memory_format=_CL)
    if b == 0:
        return y
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = LIB.ldm_group_norm_silu(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                      y.data_ptr(), b, h * w, c, groups, eps, int(silu),
                                      (ctypes.c_int * len(plan))(*plan), stream)
    if err != 0:
        raise RuntimeError(f"GroupNorm kernel launch failed: CUDA error {err} at "
                           f"{tuple(x.shape)}, G={groups}, plan {plan}")
    return y


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                    eps: float, silu: bool = False) -> torch.Tensor:
    """GroupNorm(groups, eps) of the NCHW view ``x`` with the affine
    (``weight``, ``bias``), then the SiLU with ``silu``: the plain version
    for a CPU tensor, the kernel for a CUDA tensor (which raises on what it
    does not take)."""
    if x.device.type == "cpu":
        return group_norm_silu_torch(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"no GroupNorm implementation for device {x.device}")
    y = _launch_kernel(x, weight, bias, groups, eps, silu)
    LIB.count()
    return y
