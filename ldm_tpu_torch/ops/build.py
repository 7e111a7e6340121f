"""Build the port's CUDA kernels at first use and load them with ctypes.

The counterpart of ldm_tpu/native/build.py: ``nvcc`` compiles every source
under ``ldm_tpu_torch/csrc/`` into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), for
Hopper's ``sm_90a`` target.  The library lands in :func:`build_dir`, named
by a hash of the sources and the flags, so an edited source never loads a
stale build.  It is written to a temporary name and renamed into place, so
concurrent processes never load a half-written file.

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


def lib_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libldm_tpu_torch_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build() -> tuple[Path, str, float]:
    """Compile the library unless it is already built.

    Returns its path, the compiler's output (``-Xptxas -v`` reports each
    kernel's registers, shared memory and spills; empty when the library was
    already there) and the seconds the build took.  Raises if ``nvcc`` fails.
    """
    out = lib_path()
    if out.exists():
        return out, "", 0.0
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, sources())]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({r.returncode}):\n{' '.join(cmd)}\n{r.stdout}{r.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, r.stdout + r.stderr, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The built library, with every entry point's C signature declared."""
    lib = ctypes.CDLL(str(build()[0]))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.ldm_lin_attn_fwd
    # dtype, x, wqkv_t, wout_t, bout, g1s, g1b, g2s, g2b, y, qkv scratch,
    # ctx@Wout scratch, B, N, C, eps, stream
    fn.argtypes = [i, p, p, p, p, p, p, p, p, p, p, p, i, i, i, f, p]
    fn.restype = i
    return lib
