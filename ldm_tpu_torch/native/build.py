"""Build the port's host batcher (.so) on demand — g++ only, no pybind11.

The twin of ``ldm_tpu/native/build.py``: the shared library is rebuilt iff
the source is newer than the cached .so (mtime check), written atomically
(tmp + rename) so concurrent imports can't load a half-written file.  It
lands as ``_libldm_native.so`` in the kernels' build directory
(``ops/build.py::build_dir``: ``build/ldm_tpu_torch/`` of the checkout,
git-ignored), not beside the source, where package walkers would take it
for an extension module.  ``LDM_TPU_NO_NATIVE=1`` disables the native path
entirely (``ldm_tpu_torch/native/__init__.py`` falls back to numpy)."""

from __future__ import annotations

import os
import subprocess
import tempfile

_SRC = os.path.join(os.path.dirname(__file__), "batcher.cpp")


def lib_path() -> str | None:
    """Path to the built library, building it if needed; None if the build
    toolchain is unavailable or the build fails (callers fall back)."""
    from ldm_tpu_torch.ops.build import build_dir

    tmp = None
    try:
        out = build_dir()
        out.mkdir(parents=True, exist_ok=True)
        lib = str(out / "_libldm_native.so")
        if os.path.exists(lib) and os.path.getmtime(lib) >= os.path.getmtime(_SRC):
            return lib
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out))
        os.close(fd)
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, _SRC, "-lpthread"]
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if r.returncode != 0:
            return None
        os.replace(tmp, lib)
        return lib
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        # a failed/raising build must not strand the mkstemp file (replace
        # moves it on success, so this is a no-op then)
        if tmp is not None and os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
