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
  versions.  The launches are counted as ``linear_attention_fwd`` and
  ``linear_attention_bwd`` (``utils/launches.py``).
* :func:`plan_fwd` chooses the forward's schedule from (B, N, C, dtype):
  in bf16, where two units fit in shared memory, the persistent path
  (:func:`plan_persistent`: one block a SM, two teams of 8 warps each
  walking its own work units, Wqkv^T staged once a block), but for the
  shapes in :data:`CLUSTER_FASTER`; otherwise, and in fp32, the cluster path (a CTA cluster an item, the item kept in shared
  memory) or the tiled path (through global scratch).  :func:`plan_bwd`
  chooses the backward's from (N, C, dtype): the CTAs that share an item
  (:func:`cluster_size`) and the same two paths.  The kernels follow the
  plan; ``linear_attention_fwd.persistent`` counts the forward launches
  that took the persistent path.
* :class:`KernelWeights` holds the two projection weights in the compute
  type, in both orientations, as the kernels read them; a caller that keeps
  its weights (``models.unet.LinAttnBlock``) makes them once per weight
  version, a bare call makes them on the way.

The plain versions also take float64 (statistics then in float64 too), so
``torch.autograd.gradcheck`` can hold the backward against the forward.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import NamedTuple, Optional

import torch

from ldm_tpu_torch.ops import build
from ldm_tpu_torch.ops.collectives import copy_to_model, reduce_from_model
from ldm_tpu_torch.utils import launches

HIDDEN = 128  # heads * dim_head the kernel is written for
DIM_HEAD = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def block_diag_mask(heads: int, dim_head: int, dtype, device) -> torch.Tensor:
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
    stat_c: Optional[int] = None,
    group=None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused block (linear_attention_block_xla).

    Args:
      x: (B, N, C) tokens (flattened H*W grid).
      wqkv: (C, 3*heads*dim_head) fused qkv projection, no bias.
      wout/bout: (heads*dim_head, C) / (C,) output projection.
      gn{1,2}_scale/bias: (C,) GroupNorm affine params (pre-norm / post-norm).
      stat_c: the kernels' treatment of a zero-padded width (:func:`pad_width`):
        the two GroupNorms take their statistics over the first ``stat_c``
        columns alone.  None: over all C.
      group: under tensor parallelism, the model axis's process group the
        heads are split over; ``heads``, ``wqkv`` and ``wout`` are then this
        process's share (its heads' q, k and v columns, in that order, and
        their rows of ``wout``).  The normalized input enters the heads
        through ``copy_to_model``, their partial output projection leaves
        through ``reduce_from_model``, and the bias is added once.  None:
        every head is here.
    """
    hidden = heads * dim_head
    if wout.shape[0] != hidden:
        raise ValueError(f"wout has {wout.shape[0]} rows, not heads * dim_head = {hidden}")
    cd = compute_dtype
    acc = _stat_dtype(cd)
    sc = x.shape[-1] if stat_c is None else stat_c

    def stats(t):  # mean and variance of an item over its first sc columns
        live = t[..., :sc]
        return (live.mean(dim=(1, 2), keepdim=True),
                live.var(dim=(1, 2), keepdim=True, correction=0))

    xf = x.to(acc)
    mean, var = stats(xf)
    h = copy_to_model(((xf - mean) * torch.rsqrt(var + eps) * gn1_scale + gn1_bias).to(cd),
                      group)

    w = wqkv.to(cd)
    q = h @ w[:, :hidden]
    k = h @ w[:, hidden : 2 * hidden]
    v = h @ w[:, 2 * hidden :]

    # q: per-head softmax over dim_head; the row max over all lanes is a valid
    # shift for every head; per-head sums via a block-diagonal ones matmul in
    # fp32 (the products of values in the compute type are exact in fp32)
    seg = block_diag_mask(heads, dim_head, cd, x.device)
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
    out = reduce_from_model(torch.einsum("bdc,bnd->bnc", ctx_w, q), group) + bout.to(cd)

    of = out.to(acc)
    mean2, var2 = stats(of)
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
    stat_c: Optional[int] = None,
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

    ``stat_c``: the kernels' treatment of a zero-padded width
    (:func:`pad_width`): the items' means run over the first ``stat_c``
    columns alone, and do and dx are zero in the others.  None: all C.

    Returns (dx in x.dtype, dWqkv, dWout, dbout, dg1s, dg1b, dg2s, dg2b), the
    parameter grads in the parameters' dtype (fp32).
    """
    hidden = heads * dim_head
    cd = compute_dtype
    acc = _stat_dtype(cd)
    scale = dim_head**-0.5
    b, n, c = x.shape
    sc = c if stat_c is None else stat_c
    live = (torch.arange(c, device=x.device) < sc).to(acc)  # 1 on the true columns

    def rnd(t):  # round to the compute type, carry in the statistics type
        return t.to(cd).to(acc)

    def item_mean(t):
        return t[..., :sc].mean(dim=(1, 2), keepdim=True)

    def norm(t):
        mu = item_mean(t)
        inv = torch.rsqrt(item_mean((t - mu) ** 2) + eps)
        return (t - mu) * inv, inv

    seg = block_diag_mask(heads, dim_head, acc, x.device)
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
    do = (dhat2 - item_mean(dhat2) - ohat * item_mean(dhat2 * ohat)) * inv2 * live
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
    dx = dyf + (dhat1 - item_mean(dhat1) - xhat * item_mean(dhat1 * xhat)) * inv1 * live
    grads = (dwqkv, dwout, dbout, dg1s, dg1b, dg2s, dg2b)
    params = (wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias)
    return (dx.to(x.dtype),) + tuple(g.to(p.dtype) for g, p in zip(grads, params))


# On a CUDA tensor the block runs in inference up to C = 768 and trains up to
# C = 512: the forward kernel's widest C is a 64-row fp32 tile of C values
# in shared memory, the backward kernel's that tile beside the fp32 dqn tile.
# A UNet with an attention site wider than 512 samples on the card but cannot
# train there (LinearAttentionBlockFn refuses it in its forward).
MAX_C_FWD = 768
MAX_C_BWD = 512
MIN_C = 8  # the narrowest C, and what C must be a multiple of
C_STEP = 16  # the kernels' buffers are this multiple wide: narrower C is zero-padded
SMEM_LIMIT = 232_448  # dynamic shared memory one CTA can take on an H100
TILE_R = 64  # rows of a tile
MAX_CLUSTER = 8  # the portable cluster size
MIN_ROWS = 128  # the fewest rows of an item a CTA of a cluster takes
# the persistent forward (csrc/linear_attention_fwd.cuh, lin_attn_fwd_persistent_kernel)
TEAMS = 2  # units in flight on an SM: teams of 8 warps a block
MAX_CLUSTER_PERSISTENT = 16  # the non-portable cluster size
UNIT_ROWS = (128, 64)  # the rows of an item a unit's slice takes, in the order tried
SMS = 132  # the H100's SMs, which the plan sizes units for
# a unit's fp32 vectors: kmax, ksum, their partials and the odd rows'; red; stat; slots
_VEC_PERSISTENT = (5 * HIDDEN + 8 + 2 + 4) * 4
# (N, C) -> the batches B, of those timed on an H100 (chip_smoke.py phase 10:
# the 32px UNet's sites at B = 20, 128 and 256), at which the cluster path
# beat the persistent one; a batch counts as the timed one nearest to it
# (in ratio).  The bf16 forward takes the cluster path there.  (64, 256):
# one 64-row item a unit, Wqkv^T not staged, 9-10% slower at every batch.
CLUSTER_TIMED_B = (20, 128, 256)
CLUSTER_FASTER = {(64, 256): (20, 128, 256), (256, 128): (256,), (16, 256): (128,),
                  (64, 128): (128,)}
_BARRIERS = 2 * TEAMS * 8  # two mbarriers a team
_VEC_FWD = (4 * HIDDEN + 8 + 8) * 4  # kmax, ksum and their partials; red; slots
_VEC_BWD = (6 * HIDDEN + 256 + 8 + 16) * 4  # + inner and its partial; sred


def pad_width(c: int) -> int:
    """The width of the kernels' buffers for a block of true width ``c``: the
    next multiple of 16 (the tensor-core products walk C in steps of 16).
    The wrappers pad x, dy, the projections and the vectors with zero columns
    up to it, hand the kernels both widths, and slice the outputs; the
    kernels take GroupNorm's statistics over the true columns alone."""
    return -(-c // C_STEP) * C_STEP


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` with zero columns appended up to ``width``; itself if it is that wide."""
    extra = width - t.shape[-1]
    return t if extra == 0 else torch.nn.functional.pad(t, (0, extra))


def _split(n: int, most: int, least: int) -> int:
    """CTAs that share one item of N rows: doubled while the rows still
    split evenly into at least ``least`` a CTA, up to ``most``."""
    cs = 1
    while cs < most and n % (2 * cs) == 0 and n // (2 * cs) >= least:
        cs *= 2
    return cs


def cluster_size(n: int) -> int:
    """The backward's CTAs that share one item of N rows: doubled while the
    rows still split evenly into at least 128 a CTA, up to the portable 8
    (the forward's cluster and tiled paths split an item the same way).
    1024 -> 8 CTAs of 128 rows, 256 -> 2 of 128, 64 and 16 -> 1.  A CTA's
    time is mostly the latencies of its phases, not its rows, so at a batch
    that fills the card several times over 64-row CTAs only add waves (timed
    by perf/plan_sweep.py: at N=256 two CTAs an item beat four at 2B=128 and
    at B=64, and lose only where the batch leaves SMs idle, 2B=20)."""
    return _split(n, MAX_CLUSTER, MIN_ROWS)


def _row_pad(dtype: torch.dtype) -> int:
    """Padding of a shared-memory row, in elements: 16 bytes."""
    return 16 // dtype.itemsize


@dataclasses.dataclass(frozen=True)
class FwdPlan:
    """The forward kernel's launch plan (``FwdPlan`` in
    csrc/linear_attention_fwd.cuh): cluster size, rows a CTA, what stays in
    shared memory, byte offsets of the buffers there, and the total."""

    cs: int
    rows: int
    keep: int      # q | k | v, out and (ctx @ Wout)^T in shared memory
    stage_w: int   # Wqkv^T staged in shared memory
    off_tile: int
    off_ctxn: int
    off_vec: int
    off_u: int     # Wqkv^T, later (ctx @ Wout)^T and out
    off_out: int
    off_qkv: int
    smem_bytes: int

    @property
    def path(self) -> str:
        return "cluster" if self.keep else "tiled"

    def ints(self):
        return dataclasses.astuple(self)[:-1]


@dataclasses.dataclass(frozen=True)
class PersistentPlan:
    """The persistent forward's launch plan (``PersistPlan`` in
    csrc/linear_attention_fwd.cuh).  A unit is one item's slice of ``rows``
    rows, the item split over a cluster of ``cs`` CTAs (the whole item at
    ``cs`` 1); ``teams`` units are in flight on each SM.  Offsets are bytes
    into dynamic shared memory, the ``u_*`` ones into a team's unit buffers."""

    cs: int
    rows: int
    qrows: int     # rows of the unit's q | k | v: rows up to a multiple of 16
    teams: int
    keep_q: int    # q in shared memory beside k | v (else in a team's slot of scratch)
    stage_w: int   # Wqkv^T in shared memory, once a block
    keep_cw: int   # (ctx @ Wout)^T in shared memory (else a team's slot of scratch)
    keep_out: int  # out in shared memory (else in y)
    off_w: int
    off_bar: int
    off_unit: int
    unit_bytes: int
    u_qkv: int
    u_a: int       # the h tile; the partial ctx (cs > 1); (ctx @ Wout)^T
    u_b: int       # ctx, then out over it
    u_vec: int
    smem_bytes: int

    @property
    def path(self) -> str:
        return "persistent"

    def ints(self):
        return dataclasses.astuple(self)[:-1]


@dataclasses.dataclass(frozen=True)
class BwdPlan:
    """The backward item kernel's launch plan (``BwdPlan`` in
    csrc/linear_attention_bwd.cu)."""

    cs: int
    rows: int
    keep: int      # qn | kn | v of the CTA's rows in shared memory
    keep_cw: int   # cw, cw^T and dcw in shared memory
    off_tile: int
    off_ctxn: int
    off_dctx: int
    off_dctxt: int
    off_vec: int
    off_cw: int
    off_cwt: int
    off_qkv: int
    smem_bytes: int

    @property
    def path(self) -> str:
        return "cluster" if self.keep else "tiled"

    def ints(self):
        return dataclasses.astuple(self)[:-1]


def _check_plan_shape(n: int, c: int, dtype: torch.dtype, max_c: int) -> None:
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
    if n < 1 or not 16 <= c <= max_c or c % 16:
        raise ValueError(
            f"kernel takes N >= 1 and C a multiple of 16 in [16, {max_c}], got {n, c}")


# (keep, stage_w) in the order the cluster and tiled paths try them
FWD_OPTIONS = ((1, 1), (1, 0), (0, 1), (0, 0))
# (stage_w, keep_cw, keep_out) in the order the persistent path tries them:
# the weight once a block first, then the unit's own buffers
PERSISTENT_OPTIONS = ((1, 1, 1), (1, 0, 1), (1, 1, 0), (1, 0, 0),
                      (0, 1, 1), (0, 0, 1), (0, 1, 0), (0, 0, 0))


def _align(n: int, to: int) -> int:
    return -(-n // to) * to


def _persistent_layout(n, c, cs, teams, keep_q, stage_w, keep_cw, keep_out):
    """The persistent plan with these choices, or None where it does not fit
    (perf/plan_sweep.py times the kernel under each)."""
    es, pad = 2, _row_pad(torch.bfloat16)
    rows = n // cs
    qrows = _align(rows, 16)
    if not keep_q and qrows < 2 * TILE_R:
        return None  # q's tiles come back into k | v's rows past the first tile
    qkv = qrows * ((3 if keep_q else 2) * HIDDEN + pad) * es
    h = min(TILE_R, qrows) * (c + pad) * es
    # with q out of shared memory, the partial ctx and ctx lie in k | v's
    # rows 64-127, which the ctx sums have consumed
    ctx_p = HIDDEN * DIM_HEAD * 4 if cs > 1 and keep_q else 0
    cwt = c * (HIDDEN + pad) * es if keep_cw else 0
    ctxn = HIDDEN * (DIM_HEAD + pad) * es if keep_q else 0
    out = qrows * (c + pad) * es if keep_out else 0
    u_a = qkv
    u_b = u_a + max(h, ctx_p, cwt)
    u_vec = u_b + max(ctxn, out)  # out lies over ctx, which it outlives
    unit = _align(u_vec + _VEC_PERSISTENT, 128)
    w = 3 * HIDDEN * (c + pad) * es if stage_w else 0
    off_bar = _align(w, 16)
    off_unit = _align(off_bar + _BARRIERS, 128)
    total = off_unit + teams * unit
    if total > SMEM_LIMIT:
        return None
    return PersistentPlan(cs, rows, qrows, teams, keep_q, stage_w, keep_cw, keep_out, 0,
                          off_bar, off_unit, unit, 0, u_a, u_b, u_vec, total)


def plan_persistent(n: int, c: int, b: int = 1) -> Optional[PersistentPlan]:
    """The bf16 forward's persistent plan for B items of (N, C), or None
    where two units do not fit in shared memory beside each other.

    The unit comes from the shape and the batch.  For N >= 128 an item's
    slice over cs CTAs (a power of two up to 16): 128 rows where two such
    units fit, with q in global scratch and only k | v in shared memory (a
    unit's time is mostly its chain of barriers and reductions, whatever its
    rows, so fewer, larger units go faster), else 64 rows with q | k | v
    kept; 64 first where the batch has fewer 128-row slices than the card
    has SMs (``SMS``), so that they are spread over more of them.  Below
    128 rows, one whole item.  Two units in flight on an SM (``TEAMS``), one
    where the launch has no more units than the card has SMs: a team alone
    gets all of the SM's registers and shared memory.  Of the buffers that
    may stay in shared memory (the staged Wqkv^T, the unit's (ctx @ Wout)^T
    and out) it keeps what fits, in the order of ``PERSISTENT_OPTIONS``."""
    layouts = [(keep_q, *o) for keep_q in (0, 1) for o in PERSISTENT_OPTIONS]
    # 128-row slices unless they leave SMs idle that 64-row ones would fill
    rows = UNIT_ROWS if b * n >= UNIT_ROWS[0] * SMS else UNIT_ROWS[::-1]
    for cs in dict.fromkeys(_split(n, MAX_CLUSTER_PERSISTENT, r) for r in rows):
        fits = [lay for lay in layouts if _persistent_layout(n, c, cs, TEAMS, *lay) is not None]
        if not fits:
            continue
        if b * cs > SMS:
            return _persistent_layout(n, c, cs, TEAMS, *fits[0])
        # one team alone: the first layout that fits it
        return next(plan for plan in (_persistent_layout(n, c, cs, 1, *lay) for lay in layouts)
                    if plan is not None)
    return None


def cluster_faster(n: int, c: int, b: int) -> bool:
    """Whether the cluster path timed faster than the persistent one at
    (N, C) and the timed batch nearest B (:data:`CLUSTER_FASTER`)."""
    timed = min(CLUSTER_TIMED_B, key=lambda t: abs(math.log(b / t)))
    return timed in CLUSTER_FASTER.get((n, c), ())


def plan_fwd(n: int, c: int, dtype: torch.dtype, b: int = 1):
    """The forward kernel's plan for B items of (N, C) in ``dtype``, from the
    shape alone: in bf16 the persistent path where two units fit
    (:func:`plan_persistent`) and the cluster path did not time faster
    (:func:`cluster_faster`), otherwise, and in fp32, the cluster or the
    tiled path (:func:`plan_cluster`).  Raises on what no path takes."""
    _check_plan_shape(n, c, dtype, MAX_C_FWD)
    if b < 1:
        raise ValueError(f"the forward kernel takes B >= 1, got {b}")
    plan = None
    if dtype == torch.bfloat16 and not cluster_faster(n, c, b):
        plan = plan_persistent(n, c, b)
    return plan if plan is not None else plan_cluster(n, c, dtype)


def plan_cluster(n: int, c: int, dtype: torch.dtype, options=FWD_OPTIONS) -> FwdPlan:
    """The forward's cluster or tiled plan for items of (N, C) in ``dtype``:
    an item over a cluster of :func:`cluster_size` CTAs, keeping what fits
    of its buffers in shared memory, tried in a fixed order: first q | k | v
    with out and (ctx @ Wout)^T (the cluster path; without them the tiled
    path through global scratch), then the staged Wqkv^T (worth 4.0-8.5%
    where the CTA has 128 rows or more, 2% at 64: perf/plan_sweep.py).
    Raises where not even the bare tiles fit.  ``options``: the (keep,
    stage_w) to try, for perf/plan_sweep.py, which times the kernel under
    each."""
    _check_plan_shape(n, c, dtype, MAX_C_FWD)
    es, pad = dtype.itemsize, _row_pad(dtype)
    cs = _split(n, MAX_CLUSTER, MIN_ROWS)
    rows = n // cs
    tile = TILE_R * max(c + pad, 2 * (HIDDEN + pad)) * es
    ctxn = HIDDEN * (DIM_HEAD + pad) * es
    w = 3 * HIDDEN * (c + pad) * es
    cwt = c * (HIDDEN + pad) * es
    out = rows * (c + pad) * es
    qkv = rows * (3 * HIDDEN + pad) * es
    base = tile + ctxn + _VEC_FWD
    for keep, stage_w in options:
        u = max(w if stage_w else 0, cwt + out if keep else 0)
        total = base + u + (qkv if keep else 0)
        if total <= SMEM_LIMIT:
            return FwdPlan(cs, rows, keep, stage_w, 0, tile, tile + ctxn, base, base + cwt,
                           base + u, total)
    raise ValueError(f"the forward kernel's tiles do not fit in shared memory at {n, c, dtype}")


def plan_bwd(n: int, c: int, dtype: torch.dtype) -> BwdPlan:
    """The backward item kernel's plan for items of (N, C) in ``dtype``:
    qn | kn | v of the CTA's rows in shared memory where they fit (the
    cluster path), then cw, cw^T and dcw."""
    _check_plan_shape(n, c, dtype, MAX_C_BWD)
    es, pad = dtype.itemsize, _row_pad(dtype)
    cs = cluster_size(n)
    rows = n // cs
    tile = TILE_R * max((3 * HIDDEN + pad) * es, (c + pad) * es + (HIDDEN + 4) * 4,
                        2 * (HIDDEN + pad) * es)
    ctx = HIDDEN * (DIM_HEAD + pad) * es
    cw = HIDDEN * (c + pad) * es
    cwt = c * (HIDDEN + pad) * es
    qkv = rows * (3 * HIDDEN + pad) * es
    base = tile + 3 * ctx + _VEC_BWD
    for keep, keep_cw in ((1, 1), (1, 0), (0, 1), (0, 0)):
        total = base + (cw + cwt if keep_cw else 0) + (qkv if keep else 0)
        if total <= SMEM_LIMIT:
            off_cw = base
            off_qkv = off_cw + (cw + cwt if keep_cw else 0)
            return BwdPlan(cs, rows, keep, keep_cw, 0, tile, tile + ctx, tile + 2 * ctx,
                           tile + 3 * ctx, off_cw, off_cw + (cw if keep_cw else 0), off_qkv,
                           total)
    raise ValueError(f"the backward kernel's tiles do not fit in shared memory at {n, c, dtype}")


class KernelWeights(NamedTuple):
    """The two projection weights as the kernels read them: contiguous, in
    the compute type, in both orientations.  The forward reads the
    transposes; the backward all four."""

    wqkv: Optional[torch.Tensor]  # (C, 3H)
    wqkv_t: torch.Tensor          # (3H, C)
    wout: Optional[torch.Tensor]  # (H, C)
    wout_t: torch.Tensor          # (C, H)


def _copy_as(src: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``src`` contiguous in ``dtype``: itself where it already is, else one
    cast-and-copy kernel."""
    if src.dtype == dtype and src.is_contiguous():
        return src.detach()
    return torch.empty(src.shape, dtype=dtype, device=src.device).copy_(src.detach())


def make_kernel_weights(wqkv: torch.Tensor, wout: torch.Tensor, dtype: torch.dtype,
                        backward: bool = True) -> KernelWeights:
    """``wqkv`` (C, 3H) and ``wout`` (H, C), of any strides (the UNet hands in
    transposed views of its 1x1-conv weights), as :class:`KernelWeights` in
    ``dtype``; without ``backward`` only the forward's two.  A C that is no
    multiple of 16 is zero-padded to :func:`pad_width`."""
    with torch.no_grad():
        cp = pad_width(wout.shape[1])
        wqkv, wout = _pad_last(wqkv.t(), cp).t(), _pad_last(wout, cp)
        return KernelWeights(
            _copy_as(wqkv, dtype) if backward else None, _copy_as(wqkv.t(), dtype),
            _copy_as(wout, dtype) if backward else None, _copy_as(wout.t(), dtype))


def _check_cuda_args(x, params, heads, dim_head, compute_dtype, max_c=MAX_C_FWD,
                     weights: Optional[KernelWeights] = None) -> None:
    """Raise on anything the kernels do not take.  With ``weights`` the two
    projections in ``params`` may be views of any strides (only their shapes
    are checked); the kernels read ``weights``, which are :func:`pad_width`
    of C wide."""
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
    # a 64-row tile of C values must fit in shared memory; the UNet's widths
    # are multiples of 8 (its ResNet blocks' GroupNorm(8)), and the wrappers
    # pad one that is no multiple of 16
    if b < 1 or n < 1 or not MIN_C <= c <= max_c or c % MIN_C:
        raise ValueError(
            f"kernel takes B, N >= 1 and C a multiple of {MIN_C} in [{MIN_C}, {max_c}], "
            f"got {b, n, c}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    shapes = [(c, 3 * HIDDEN), (HIDDEN, c)] + [(c,)] * 5
    cp = pad_width(c)
    names = ("wqkv", "wout", "bout", "gn1_scale", "gn1_bias", "gn2_scale", "gn2_bias")
    for i, (name, p, shape) in enumerate(zip(names, params, shapes)):
        if p.device != x.device:
            raise ValueError(f"{name} is on {p.device}, x on {x.device}")
        if p.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {p.dtype}")
        if tuple(p.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(p.shape)}")
        if weights is not None and i < 2:
            continue
        if not p.is_contiguous() or p.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if weights is not None:
        for name, w in weights._asdict().items():
            if w is None:
                continue
            want = {"wqkv": (cp, 3 * HIDDEN), "wqkv_t": (3 * HIDDEN, cp),
                    "wout": (HIDDEN, cp), "wout_t": (cp, HIDDEN)}[name]
            if (w.device != x.device or w.dtype != x.dtype or tuple(w.shape) != want
                    or not w.is_contiguous() or w.data_ptr() % 16):
                raise ValueError(
                    f"kernel weight {name} must be a contiguous, 16-byte aligned {want} "
                    f"tensor of {x.dtype} on {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        raise RuntimeError(
            "the raw kernel launchers are not differentiable: call "
            "linear_attention_block, which routes grad-mode calls through "
            "LinearAttentionBlockFn"
        )


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
FWD_LIB = build.Library("linear_attention_fwd", {
    # dtype, x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, qkv scratch,
    # ctx@Wout scratch, B, N, C, the true C, eps, plan (host ints), smem
    # bytes, stream
    "ldm_lin_attn_fwd": ([_I] + [_P] * 11 + [_I] * 4 + [_F, ctypes.POINTER(_I), _I, _P], _I),
    # x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, ctx@Wout scratch, q
    # scratch, their slots, B, N, C, the true C, eps, plan (host ints), smem
    # bytes, stream
    "ldm_lin_attn_fwd_persistent": ([_P] * 11 + [_I] * 5 + [_F, ctypes.POINTER(_I), _I, _P],
                                    _I)})
BWD_LIB = build.Library("linear_attention_bwd", {  # a launch is 3 CUDA kernels
    "ldm_lin_attn_bwd_splits": ([_I, _I, _I], _I),  # B, N, C
    # dtype, x, dy, wqkv, wqkv_t, wout, wout_t, bout, g1s, g1b, g2s, dx,
    # dwqkv, dwout, dvec, 11 scratch buffers, B, N, C, the true C, splits,
    # eps, plan (host ints), smem bytes, stream
    "ldm_lin_attn_bwd": ([_I] + [_P] * 25 + [_I] * 5 + [_F, ctypes.POINTER(_I), _I, _P], _I)})
# the forward's launches on the persistent path
PERSISTENT = FWD_LIB.name + ".persistent"


def _plan_array(plan) -> ctypes.Array:
    ints = plan.ints()
    return (ctypes.c_int * len(ints))(*ints)


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _call_production(plan, args) -> int:
    """The production entry point of the plan's path, counted (a failed
    launch raises)."""
    FWD_LIB.count()
    if plan.path != "persistent":
        return FWD_LIB.ldm_lin_attn_fwd(*args)
    launches.count(PERSISTENT)
    return FWD_LIB.ldm_lin_attn_fwd_persistent(*args)


def _launch_kernel(x, params, *, heads, dim_head, eps, compute_dtype,
                   weights: Optional[KernelWeights] = None, call=_call_production):
    """The forward's launch: checks, pads, plans, allocates the output and
    the scratch, then ``call(plan, args)`` calls an entry point with the
    arguments of the plan's path's production entry point and returns its
    error code: the production entry points, or probe 7's stage builds
    (perf/probe7.py).  Returns y."""
    if weights is None:
        weights = make_kernel_weights(params[0], params[1], x.dtype, backward=False)
    _check_cuda_args(x, params, heads, dim_head, compute_dtype, weights=weights)
    b, n, c_true = x.shape
    c = pad_width(c_true)
    x = _pad_last(x, c)
    params = (*params[:2], *(_pad_last(p, c) for p in params[2:]))
    plan = plan_fwd(n, c, x.dtype, b)
    y = torch.empty_like(x)
    qkv_scratch = cw_scratch = q_scratch = None
    slots = 0
    if plan.path == "persistent":
        # a slot a team of the launch, at most one block a SM
        slots = _sm_count(x.device.index if x.device.index is not None
                          else torch.cuda.current_device()) * plan.teams
        if not plan.keep_cw:
            cw_scratch = torch.empty((slots, c, HIDDEN), dtype=x.dtype, device=x.device)
        if not plan.keep_q:
            q_scratch = torch.empty((slots, plan.qrows, HIDDEN), dtype=x.dtype, device=x.device)
    elif not plan.keep:  # the tiled path's buffers
        qkv_scratch = torch.empty((b, n, 3 * HIDDEN), dtype=x.dtype, device=x.device)
        cw_scratch = torch.empty((b * plan.cs, c, HIDDEN), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        weights_args = (x.data_ptr(), weights.wqkv_t.data_ptr(), weights.wout_t.data_ptr(),
                        *(p.data_ptr() for p in params[2:]), y.data_ptr())
        if plan.path == "persistent":
            args = (*weights_args, _ptr(cw_scratch), _ptr(q_scratch), slots, b, n, c, c_true,
                    float(eps), _plan_array(plan), plan.smem_bytes, stream)
        else:
            args = (_DTYPE_CODE[x.dtype], *weights_args, _ptr(qkv_scratch), _ptr(cw_scratch), b,
                    n, c, c_true, float(eps), _plan_array(plan), plan.smem_bytes, stream)
        err = call(plan, args)
    if err != 0:
        raise RuntimeError(f"linear-attention kernel launch failed: CUDA error {err} "
                           f"(shape {b, n, c_true}, {plan})")
    return y if c == c_true else y[..., :c_true].contiguous()


def _launch_bwd_kernel(x, dy, params, *, heads, dim_head, eps, compute_dtype,
                       weights: Optional[KernelWeights] = None):
    """The backward kernels' launch: returns (dx, dWqkv, dWout, dbout, dg1s,
    dg1b, dg2s, dg2b).  ``params`` are the forward's: wqkv (C, 3H) and wout
    (H, C)."""
    if weights is None or weights.wqkv is None:
        weights = make_kernel_weights(params[0], params[1], x.dtype)
    _check_cuda_args(x, params, heads, dim_head, compute_dtype, max_c=MAX_C_BWD,
                     weights=weights)
    b, n, c_true = x.shape
    c = pad_width(c_true)
    dy = dy.to(x.dtype).contiguous()
    if dy.shape != x.shape or dy.data_ptr() % 16:
        raise ValueError(f"dy must be a 16-byte aligned {tuple(x.shape)} tensor")
    x, dy = _pad_last(x, c), _pad_last(dy, c)
    params = (*params[:2], *(_pad_last(p, c) for p in params[2:]))
    plan = plan_bwd(n, c, x.dtype)
    f32 = dict(dtype=torch.float32, device=x.device)
    cdt = dict(dtype=x.dtype, device=x.device)
    dx = torch.empty_like(x)
    dwqkv = torch.empty((c, 3 * HIDDEN), **f32)
    dwout = torch.empty((HIDDEN, c), **f32)
    dvec = torch.empty((5, c), **f32)  # dbout, dg1s, dg1b, dg2s, dg2b
    splits = BWD_LIB.ldm_lin_attn_bwd_splits(b, n, c)
    ctas = b * plan.cs
    scratch = dict(
        qkv=None if plan.keep else torch.empty((b, n, 3 * HIDDEN), **cdt),
        dqkv=torch.empty((b, n, 3 * HIDDEN), **cdt),
        o=torch.empty((b, n, c), **f32),
        do=torch.empty((b, n, c), **cdt),
        cw=None if plan.keep_cw else torch.empty((ctas, HIDDEN, c), **cdt),
        cw_t=None if plan.keep_cw else torch.empty((ctas, c, HIDDEN), **cdt),
        stats=torch.empty((b, 2), **f32),
        pvec=torch.empty((ctas, 5, c), **f32),
        pwout=torch.empty((b, HIDDEN, c), **f32),
        pdcw=None if plan.cs == 1 else torch.empty((ctas, HIDDEN, c), **f32),
        pwqkv=torch.empty((splits, c, 3 * HIDDEN), **f32),
    )
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = BWD_LIB.ldm_lin_attn_bwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), dy.data_ptr(),
            *(w.data_ptr() for w in weights), *(p.data_ptr() for p in params[2:6]),
            dx.data_ptr(), dwqkv.data_ptr(), dwout.data_ptr(), dvec.data_ptr(),
            *(_ptr(t) for t in scratch.values()),
            b, n, c, c_true, splits, float(eps), _plan_array(plan), plan.smem_bytes, stream,
        )
    if err != 0:
        raise RuntimeError(f"linear-attention backward launch failed: CUDA error {err} "
                           f"(shape {b, n, c_true}, {plan})")
    BWD_LIB.count()
    if c != c_true:
        dx, dwqkv = dx[..., :c_true].contiguous(), dwqkv[:c_true]
        dwout, dvec = dwout[:, :c_true], dvec[:, :c_true]
    return (dx, dwqkv, dwout, *dvec.unbind(0))


def linear_attention_block_bwd(
    x, dy, wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias,
    *, heads: int, dim_head: int, eps: float = 1e-5,
    compute_dtype: torch.dtype = torch.float32,
    weights: Optional[KernelWeights] = None,
) -> tuple[torch.Tensor, ...]:
    """The block's backward: the plain version for a CPU tensor, the Hopper
    kernels for a CUDA tensor (which raise on what they do not take).
    ``weights``: the projections as the kernels read them, where the caller
    keeps them; made here otherwise."""
    params = (wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias)
    kw = dict(heads=heads, dim_head=dim_head, eps=eps, compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        return linear_attention_block_bwd_torch(x, dy, *params, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no linear-attention implementation for device {x.device}")
    return _launch_bwd_kernel(x, dy, params, weights=weights, **kw)


class LinearAttentionBlockFn(torch.autograd.Function):
    """The fused block as an autograd op (``linear_attention_block_fused_grads``).

    Forward: the forward kernel on a CUDA tensor, the plain forward on a CPU
    one.  Backward: likewise the backward kernels or the plain backward; both
    recompute the forward from x, so only the inputs are saved.  The weights
    may come in as views of the UNet's 1x1-conv weights (``wqkv`` the (C, 3H)
    transpose of to_qkv's (3H, C)); the kernels read ``weights``, the
    contiguous copies in the compute type (made here when the caller keeps
    none), and the grads go back in the views' shapes, so autograd carries
    them to the convs' layouts.
    """

    @staticmethod
    def forward(ctx, x, wqkv, wout, bout, g1s, g1b, g2s, g2b,
                heads, dim_head, eps, compute_dtype, weights=None):
        kw = dict(heads=heads, dim_head=dim_head, eps=eps, compute_dtype=compute_dtype)
        params = (wqkv, wout, bout, g1s, g1b, g2s, g2b)
        if x.device.type == "cuda":
            if weights is None or weights.wqkv is None:
                weights = make_kernel_weights(wqkv, wout, x.dtype)
            # refuse now what the backward would refuse after the forward
            _check_cuda_args(x, params, heads, dim_head, compute_dtype, max_c=MAX_C_BWD,
                             weights=weights)
            y = _launch_kernel(x, params, weights=weights, **kw)
        elif x.device.type == "cpu":
            y = linear_attention_block_torch(x, *params, **kw)
        else:
            raise ValueError(f"no linear-attention implementation for device {x.device}")
        ctx.save_for_backward(x, *params)
        ctx.kw = kw
        ctx.weights = weights
        return y

    @staticmethod
    def backward(ctx, dy):
        x, *params = ctx.saved_tensors
        grads = linear_attention_block_bwd(x, dy, *params, weights=ctx.weights, **ctx.kw)
        return (*grads, None, None, None, None, None)


def linear_attention_block(
    x, wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias,
    *, heads: int, dim_head: int, eps: float = 1e-5,
    compute_dtype: torch.dtype = torch.float32,
    weights: Optional[KernelWeights] = None,
) -> torch.Tensor:
    """The fused block.  In grad mode with an input that requires grad:
    :class:`LinearAttentionBlockFn`.  Otherwise the plain version for a CPU
    tensor and the forward kernel for a CUDA tensor (which raises on what the
    kernel does not take).  ``weights``: the projections as the kernels read
    them (:func:`make_kernel_weights`), where the caller keeps them; a CPU
    tensor ignores them."""
    params = (wqkv, wout, bout, gn1_scale, gn1_bias, gn2_scale, gn2_bias)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, *params)):
        return LinearAttentionBlockFn.apply(x, *params, heads, dim_head, eps, compute_dtype,
                                            weights)
    kw = dict(heads=heads, dim_head=dim_head, eps=eps, compute_dtype=compute_dtype)
    if x.device.type == "cpu":
        return linear_attention_block_torch(x, *params, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no linear-attention implementation for device {x.device}")
    return _launch_kernel(x, params, weights=weights, **kw)
