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
* :func:`plan_resnet` is the kernel's launch plan, a pure function of the
  shapes: the tiles, how many CTAs share an output tile and which (channel
  chunk, tap) units each takes, the shared memory and the scratch.
* :class:`ResNetBlockFn` is the counterpart of the custom VJP: the forward
  is the kernel for a CUDA tensor and the plain version for a CPU tensor;
  the backward recomputes through :func:`resnet_block_torch`, the reference's
  own policy (there is no backward kernel for this block).
* :func:`resnet_block` dispatches as ``linear_attention_block`` does.  A
  CUDA tensor launches the kernel or raises, and counts its launches as
  ``resnet_block_fwd`` (``utils/launches.py``; one per block, three CUDA
  kernels each).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from ldm_tpu_torch.ops import build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_C = 768  # the widest C_in / C_out the kernel takes
# csrc/resnet_block.cuh's constants
TILE_M = 128        # output pixels per tile (RB_TM)
TILE_N = 64         # output channels per tile (RB_TN)
ROW_BYTES = 144     # an A-tile row: a 128-byte chunk of channels + 16 of padding
B_STAGES = 3        # weight tiles in the cp.async ring (RB_STAGES)
OUT_LD = TILE_N + 4  # row stride of the fp32 output tile
MAX_SPLIT = 8       # the portable cluster size
SMEM_LIMIT = 232448  # dynamic shared memory a CTA can take on an H100
N_SMS = 132         # the H100's SMs: a grid of fewer tiles is split along K
MIN_UNITS = 2       # a rank of a split keeps at least this many units
TAPS = 9


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _slots(rows: int, n: int) -> int:
    """Items a run of ``rows`` consecutive pixels can touch, n pixels an item
    (rb_slots)."""
    return min((rows + n - 2) // n + 1, rows)


@dataclasses.dataclass(frozen=True)
class ResNetPlan:
    """The ResNet-block kernel's launch plan (``RbPlan`` and ``rb_layout`` in
    csrc/resnet_block.cuh): conv ``i`` runs ``m_tiles x n_tiles x split[i]``
    CTAs, the ``split[i]`` CTAs of an output tile a thread-block cluster."""

    m_tiles: int       # tiles of TILE_M pixels over B*H*W
    n_tiles: int       # tiles of TILE_N channels over C_out
    chunk: int         # channels in a K chunk: 128 bytes of the compute type
    halo_rows: int     # rows of a chunk's tile: TILE_M + 2 W + 2
    chunks1: int       # K chunks of conv1 (C_in), conv2 (C_out), the shortcut
    chunks2: int
    chunks_sc: int
    split1: int        # CTAs sharing an output tile in conv1 / conv2
    split2: int
    smem1: int         # dynamic shared memory of a conv1 / conv2 CTA
    smem2: int
    wt_elems: int      # elements of the padded weight copy, in the compute type
    part_floats: int   # floats of the statistics' partial sums

    def ints(self):
        """What the C entry point takes (RbPlan)."""
        return (self.split1, self.split2, self.smem1, self.smem2, self.wt_elems,
                self.part_floats)

    def n_units(self, conv: int) -> int:
        """K units of conv 1 or 2: (chunk, tap) pairs, then for conv2 the
        1x1 shortcut's chunks."""
        return TAPS * self.chunks1 if conv == 1 else TAPS * self.chunks2 + self.chunks_sc

    def ctas(self, conv: int) -> int:
        return self.m_tiles * self.n_tiles * (self.split1 if conv == 1 else self.split2)

    def units(self, conv: int, rank: int):
        """The units rank ``rank`` of conv ``conv`` multiplies, in its order:
        ("conv", chunk, tap) or ("shortcut", chunk, 4); chunk-major, so a rank
        loads a chunk's halo tile once for all its taps of it."""
        split = self.split1 if conv == 1 else self.split2
        if not 0 <= rank < split:
            raise ValueError(f"rank {rank} of a split of {split}")
        n, n_conv = self.n_units(conv), TAPS * (self.chunks1 if conv == 1 else self.chunks2)
        return [("conv", u // TAPS, u % TAPS) if u < n_conv else ("shortcut", u - n_conv, 4)
                for u in range(n * rank // split, n * (rank + 1) // split)]


def _split(tiles: int, units: int) -> int:
    """CTAs sharing an output tile, a power of two: 1 where the tiles alone
    fill the card's SMs.  Two CTAs a tile are cheap, so up to 2 the split goes
    on until the 132 SMs are covered; beyond 2 it stops at 128 CTAs: at two
    CTAs an SM a cluster of 4 or 8 loses more than its shorter K gains
    (perf/resnet_sweep.py).  Every rank keeps MIN_UNITS units."""
    split = 1
    while (tiles * split < N_SMS and 2 * split <= MAX_SPLIT
           and units // (2 * split) >= MIN_UNITS):
        if split >= 2 and tiles * split >= 128:
            break
        split *= 2
    return split


def plan_resnet(b: int, h: int, w: int, cin: int, cout: int, dtype: torch.dtype,
                *, groups: int = 8, use_shortcut=None, split=None) -> ResNetPlan:
    """The kernel's plan for x (b, h, w, cin) -> (b, h, w, cout) in ``dtype``,
    from the shapes alone (``use_shortcut`` defaults to cin != cout).  Raises
    on what the kernel does not take.  ``split``: another number of CTAs a tile
    (both convs) than the rule's, for perf/resnet_sweep.py, which times the
    kernel under each."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"kernel takes float32 or bfloat16, got {dtype}")
    if b < 1 or h < 1 or w < 1:
        raise ValueError(f"kernel takes B, H, W >= 1, got {b, h, w}")
    for name, c in (("C_in", cin), ("C_out", cout)):
        if not 1 <= c <= MAX_C or groups < 1 or c % groups:
            raise ValueError(f"kernel takes {name} in [1, {MAX_C}] divisible by "
                             f"groups={groups}, got {c}")
    if split is not None and split not in (1, 2, 4, 8):
        raise ValueError(f"a tile is shared by 1, 2, 4 or 8 CTAs, got {split}")
    if use_shortcut is None:
        use_shortcut = cin != cout
    if not use_shortcut and cin != cout:
        raise ValueError(f"identity shortcut needs C_in == C_out, got {cin} -> {cout}")
    n, m = h * w, b * h * w
    if m > 2**31 - 1 - TILE_M:
        raise ValueError(f"kernel indexes pixels with 32 bits, got {m}")
    es = dtype.itemsize
    chunk = 128 // es
    m_tiles, n_tiles = -(-m // TILE_M), -(-cout // TILE_N)
    cip, cmp_, cop = _round_up(cin, chunk), _round_up(cout, chunk), n_tiles * TILE_N
    chunks1, chunks2 = cip // chunk, cmp_ // chunk
    chunks_sc = chunks1 if use_shortcut else 0
    halo = TILE_M + 2 * w + 2

    def smem(csp):
        a_bytes = (halo + 1) * ROW_BYTES
        if dtype == torch.bfloat16:
            # swizzled 128-byte rows on a multiple of 1024 bytes, with room to
            # align the ring whatever the dynamic array's own address
            off_b = _round_up(2 * a_bytes, 1024)
            b_bytes = B_STAGES * chunk * TILE_N * es + 1024
        else:
            off_b = 2 * a_bytes
            b_bytes = B_STAGES * chunk * (TILE_N + 16 // es) * es
        total = (off_b + b_bytes + 2 * csp * 4 + _slots(halo, n) * groups * 2 * 4
                 + TILE_M * 4 + halo * 4)
        assert 2 * a_bytes >= TILE_M * OUT_LD * 4  # the output tile lies over the A tiles
        return total

    smem1, smem2 = smem(cip), smem(cmp_)
    if max(smem1, smem2) > SMEM_LIMIT:
        raise ValueError(f"the kernel's tiles take {max(smem1, smem2)} bytes of shared "
                         f"memory at W={w}, groups={groups}; the card has {SMEM_LIMIT}")
    wt = TAPS * cip * cop + TAPS * cmp_ * cop + (cip * cop if use_shortcut else 0)
    tiles = m_tiles * n_tiles
    split1 = split or _split(tiles, TAPS * chunks1)
    # the statistics' partials: a (slots, G, 2) block per pixel tile and
    # column tile of x (its C_in columns), and per pixel tile, column tile and
    # rank of conv1 of h1
    part_tiles = m_tiles * (-(-cin // TILE_N) + n_tiles * split1)
    return ResNetPlan(
        m_tiles=m_tiles, n_tiles=n_tiles, chunk=chunk, halo_rows=halo, chunks1=chunks1,
        chunks2=chunks2, chunks_sc=chunks_sc,
        split1=split1, split2=split or _split(tiles, TAPS * chunks2 + chunks_sc),
        smem1=smem1, smem2=smem2, wt_elems=wt,
        part_floats=part_tiles * _slots(TILE_M, n) * groups * 2)


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


_P, _I = ctypes.c_void_p, ctypes.c_int
# dtype, x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs, y, h1 scratch,
# padded-weight scratch, statistics scratch, B, H, W, C_in, C_out, groups,
# eps, plan (host ints), stream: ldm_resnet_block_fwd's arguments, which the
# probes' entry points share
BLOCK_ARGTYPES = [_I] + [_P] * 16 + [_I] * 6 + [ctypes.c_float, ctypes.POINTER(_I), _P]
LIB = build.Library("resnet_block_fwd", {"ldm_resnet_block_fwd": (BLOCK_ARGTYPES, _I)})


def launch_args(x, temb, params, ws, bs, *, groups, eps, compute_dtype, use_shortcut,
                plan=None):
    """Check the arguments, plan the launch, allocate the output and the
    scratch, and return (y, the C entry point's arguments after its dtype
    code, what must outlive the launch); shared with the stage-ablation probe
    (ldm_tpu_torch/perf/probe13b.py).  ``plan``: :func:`plan_resnet`'s with
    other splits, for perf/resnet_sweep.py, which times the kernel under each."""
    _check_cuda_args(x, temb, params, ws, bs, groups, compute_dtype, use_shortcut)
    b, h, w, cin = x.shape
    cout = params[2].shape[-1]
    if plan is None:
        plan = plan_resnet(b, h, w, cin, cout, x.dtype, groups=groups,
                           use_shortcut=use_shortcut)
    y = torch.empty((b, h, w, cout), dtype=x.dtype, device=x.device)
    h1 = torch.empty_like(y)
    wt = torch.empty(plan.wt_elems, dtype=x.dtype, device=x.device)
    part = torch.empty(plan.part_floats, dtype=torch.float32, device=x.device)
    ints = plan.ints()
    plan_arr = (ctypes.c_int * len(ints))(*ints)
    sc = (ws.data_ptr(), bs.data_ptr()) if use_shortcut else (None, None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = (x.data_ptr(), temb.data_ptr(), *(p.data_ptr() for p in params), *sc,
            y.data_ptr(), h1.data_ptr(), wt.data_ptr(), part.data_ptr(),
            b, h, w, cin, cout, groups, float(eps), plan_arr, stream)
    # the scratch must outlive the launch: keep it with the output's arguments
    return y, args, (h1, wt, part, plan_arr)


def resnet_block_cuda(
    x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs,
    *, groups: int, eps: float = 1e-5, compute_dtype: torch.dtype = torch.float32,
    use_shortcut: bool = False, plan=None,
) -> torch.Tensor:
    """The Hopper kernel's launch (``csrc/resnet_block_fwd.cu``): three CUDA
    kernels on the current stream, no synchronisation."""
    params = (n1s, n1b, w1, b1, n2s, n2b, w2, b2)
    with torch.cuda.device(x.device):
        y, args, _scratch = launch_args(x, temb, params, ws, bs, groups=groups, eps=eps,
                                        compute_dtype=compute_dtype,
                                        use_shortcut=use_shortcut, plan=plan)
        err = LIB.ldm_resnet_block_fwd(_DTYPE_CODE[x.dtype], *args)
    if err != 0:
        raise RuntimeError(f"resnet-block kernel launch failed: CUDA error {err}")
    LIB.count()
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
