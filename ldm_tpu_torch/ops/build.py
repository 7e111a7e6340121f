"""Build the port's CUDA kernels at first use and load them with ctypes.

The counterpart of ldm_tpu/native/build.py: ``nvcc`` compiles each source
under ``ldm_tpu_torch/csrc/`` into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), for
Hopper's ``sm_90a`` target; the sources' compilers run at the same time.
Each library lands in :func:`build_dir`, named by a hash of its source, the
shared headers and the flags, so an edited file never loads a stale build.
It is written to a temporary name and renamed into place, so concurrent
processes never load a half-written file.

Nothing here runs at import: the CPU tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
import types
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
# the root of the checkout when the package runs from source
CHECKOUT = Path(__file__).resolve().parents[2]
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else the toolkit's
    default location, else ``nvcc`` on ``PATH``."""
    roots = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for root in filter(None, roots):
        cand = Path(root) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_dir() -> Path:
    """Where built libraries go: ``$LDM_TPU_TORCH_BUILD_DIR`` if set; else
    ``build/ldm_tpu_torch/`` in the checkout the package runs from (``build/``
    is git-ignored); else, for an installed package, the user's
    ``~/.cache/ldm_tpu_torch``, never a directory of the Python prefix."""
    env = os.environ.get("LDM_TPU_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    if (CHECKOUT / "pyproject.toml").is_file() and (CHECKOUT / "ldm_tpu_torch").is_dir():
        return CHECKOUT / "build" / "ldm_tpu_torch"
    return Path.home() / ".cache" / "ldm_tpu_torch"


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def lib_path(source: Path) -> Path:
    """Where the library built from ``source`` (with the current headers and
    flags) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [source, *headers()]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libldm_tpu_torch_{source.stem}_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> dict[str, tuple[Path, str, float]]:
    """Compile every source's library that is not built yet, one ``nvcc`` per
    source, all started together.

    Returns, for each source's name: the library's path, the compiler's output
    (``-Xptxas -v`` reports each kernel's registers, shared memory and
    spills; empty when the library was already there) and the seconds its
    build took.  Raises if an ``nvcc`` fails.
    """
    jobs, done, tmps = {}, {}, []
    try:
        for src in sources():
            out = lib_path(src)
            if out.exists():
                done[src.name] = (out, "", 0.0)
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
            os.close(fd)
            tmps.append(tmp)
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
            jobs[src.name] = (proc, cmd, tmp, out, time.perf_counter())
        for name, (proc, cmd, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate(timeout=900)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{log}")
            os.replace(tmp, out)
            done[name] = (out, log, seconds)
    finally:
        for proc, *_ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for tmp in tmps:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return done


@functools.lru_cache(maxsize=None)
def load() -> types.SimpleNamespace:
    """Every source's built library, loaded, with every entry point's C
    signature declared; the entry points are the namespace's attributes."""
    libs = {name: ctypes.CDLL(str(path)) for name, (path, _, _) in build().items()}
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fwd = libs["linear_attention_fwd.cu"].ldm_lin_attn_fwd
    # dtype, x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, qkv scratch,
    # ctx@Wout scratch, B, N, C, the true C, eps, plan (host ints), smem bytes,
    # stream
    fwd.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, f,
                    ctypes.POINTER(ctypes.c_int), i, p]
    fwd.restype = i
    stage = libs["linear_attention_fwd.cu"].ldm_lin_attn_fwd_stage
    stage.argtypes = [i] + fwd.argtypes  # stage, then the forward's arguments
    stage.restype = i
    persistent = libs["linear_attention_fwd.cu"].ldm_lin_attn_fwd_persistent
    # x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, ctx@Wout scratch, q
    # scratch, their slots, B, N, C, the true C, eps, plan (host ints), smem
    # bytes, stream
    persistent.argtypes = [p] * 11 + [i, i, i, i, i, f, ctypes.POINTER(ctypes.c_int), i, p]
    persistent.restype = i
    persistent_stage = libs["linear_attention_fwd.cu"].ldm_lin_attn_fwd_persistent_stage
    persistent_stage.argtypes = [i] + persistent.argtypes
    persistent_stage.restype = i
    bwd_lib = libs["linear_attention_bwd.cu"]
    splits = bwd_lib.ldm_lin_attn_bwd_splits
    splits.argtypes = [i, i, i]  # B, N, C
    splits.restype = i
    bwd = bwd_lib.ldm_lin_attn_bwd
    # dtype, x, dy, wqkv, wqkv_t, wout, wout_t, bout, g1s, g1b, g2s, dx, dwqkv,
    # dwout, dvec, 11 scratch buffers, B, N, C, the true C, splits, eps, plan
    # (host ints), smem bytes, stream
    bwd.argtypes = [i] + [p] * 25 + [i, i, i, i, i, f, ctypes.POINTER(ctypes.c_int), i, p]
    bwd.restype = i
    rb = libs["resnet_block_fwd.cu"].ldm_resnet_block_fwd
    # dtype, x, temb, n1s, n1b, w1, b1, n2s, n2b, w2, b2, ws, bs, y, h1 scratch,
    # padded-weight scratch, statistics scratch, B, H, W, C_in, C_out, groups,
    # eps, plan (host ints), stream
    rb.argtypes = [i] + [p] * 16 + [i] * 6 + [f, ctypes.POINTER(ctypes.c_int), p]
    rb.restype = i
    rb_probe = libs["resnet_block_probe.cu"].ldm_resnet_block_probe
    rb_probe.argtypes = [i] + rb.argtypes  # mode, then the block's arguments
    rb_probe.restype = i
    adam = libs["fused_adam_ema.cu"].ldm_fused_adam_ema
    # leaves, the leaf table (7 rows of 64-bit words), d, lr, b1, b2, 1 - b1,
    # 1 - b2, eps, stream, launches made (out)
    adam.argtypes = [i, ctypes.POINTER(ctypes.c_longlong), p, f, f, f, f, f, f, p,
                     ctypes.POINTER(ctypes.c_int)]
    adam.restype = i
    adam_leaves = libs["fused_adam_ema.cu"].ldm_fused_adam_ema_leaves
    adam_leaves.argtypes = []
    adam_leaves.restype = i
    gn = libs["group_norm_silu.cu"].ldm_group_norm_silu
    # x, gamma, beta, y, B, H*W, C, G, eps, silu, plan (host ints), stream
    gn.argtypes = [p] * 4 + [i] * 4 + [f, i, ctypes.POINTER(ctypes.c_int), p]
    gn.restype = i
    return types.SimpleNamespace(ldm_lin_attn_fwd=fwd, ldm_lin_attn_fwd_stage=stage,
                                 ldm_lin_attn_fwd_persistent=persistent,
                                 ldm_lin_attn_fwd_persistent_stage=persistent_stage,
                                 ldm_lin_attn_bwd=bwd, ldm_lin_attn_bwd_splits=splits,
                                 ldm_resnet_block_fwd=rb, ldm_resnet_block_probe=rb_probe,
                                 ldm_fused_adam_ema=adam,
                                 ldm_fused_adam_ema_leaves=adam_leaves,
                                 ldm_group_norm_silu=gn)
