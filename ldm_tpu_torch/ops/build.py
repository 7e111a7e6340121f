"""Build the port's CUDA kernels at first use and load them with ctypes.

The counterpart of ldm_tpu/native/build.py: ``nvcc`` compiles each source
under ``ldm_tpu_torch/csrc/`` into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds, not minutes), for
Hopper's ``sm_90a`` target; the sources' compilers run at the same time.
Each library lands in :func:`build_dir`, named by a hash of its source, the
headers it includes and the flags, so an edited file never loads a stale
build.  It is written to a temporary name and renamed into place, so
concurrent processes never load a half-written file.

This module knows sources by name and nothing of what they export: the
module that calls a library declares its entry points (:class:`Library`).
A source whose name ends in ``_probe`` is a probe's, built only when asked
for by name; the production set is every other source.

Nothing here runs at import: the CPU tests import every module on machines
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ldm_tpu_torch.utils import launches

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
    """The production sources: every one but the probes'."""
    return sorted(s for s in CSRC.glob("*.cu") if not s.stem.endswith("_probe"))


def launch_counts() -> dict:
    """Each production library's launches so far (``utils/launches.py``),
    by its source's name: its caller counts under that name
    (:meth:`Library.count`)."""
    return {s.stem: launches.read(s.stem) for s in sources()}


def includes(source: Path) -> list[Path]:
    """The headers beside ``source`` that it includes, directly or through
    another of them, sorted by name."""
    found, todo = set(), [source]
    while todo:
        for name in re.findall(r'^\s*#\s*include\s*"([^"]+)"', todo.pop().read_text(), re.M):
            header = source.parent / name
            if header.is_file() and header not in found:
                found.add(header)
                todo.append(header)
    return sorted(found)


def lib_path(source: Path) -> Path:
    """Where the library built from ``source`` (with the headers it includes
    and the flags) lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [source, *includes(source)]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"libldm_tpu_torch_{source.stem}_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def build(*names: str) -> dict[str, tuple[Path, str, float]]:
    """Compile the libraries of the named sources (``csrc/<name>.cu``; none
    named: the production set) that are not built yet, one ``nvcc`` per
    source, all started together.

    Returns, for each source's file name: the library's path, the compiler's
    output (``-Xptxas -v`` reports each kernel's registers, shared memory and
    spills; empty when the library was already there) and the seconds its
    build took.  Raises if an ``nvcc`` fails.
    """
    srcs = [CSRC / f"{name}.cu" for name in names] if names else sources()
    jobs, done, tmps = {}, {}, []
    try:
        for src in srcs:
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


class Library:
    """The library of ``csrc/<name>.cu``, built and loaded at the first call
    of one of its ``entry_points`` ({function: (argtypes, restype)}), each
    declared with its C signature: ``Library(...).<function>(*args)``.  A
    production source's first load builds the production set
    (:func:`build`), a probe's that source alone.  Its caller counts the
    kernel's launches under the source's name (:meth:`count`)."""

    def __init__(self, name: str, entry_points: dict):
        self.name, self.entry_points, self.cdll = name, entry_points, None

    def count(self, n: int = 1) -> None:
        launches.count(self.name, n)

    def declare(self, lib: ctypes.CDLL) -> ctypes.CDLL:
        for function, (argtypes, restype) in self.entry_points.items():
            f = getattr(lib, function)
            f.argtypes, f.restype = argtypes, restype
        return lib

    def __getattr__(self, function: str):
        if function not in self.entry_points:
            raise AttributeError(f"{function} is no declared entry point of {self.name}")
        if self.cdll is None:
            source = CSRC / f"{self.name}.cu"
            built = build() if source in sources() else build(self.name)
            self.cdll = self.declare(ctypes.CDLL(str(built[source.name][0])))
        return getattr(self.cdll, function)
