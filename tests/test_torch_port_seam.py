"""The seam between the port's hand-written kernels and the layers below
them: each ``ops/`` module (or probe) declares its own library's entry
points and counts its own launches; ``ops/build.py`` builds and loads by
source name and knows no entry point; ``utils/graphs.py`` replays the launch
counts without knowing any op.  All of it on the CPU, with no card and no
nvcc: the sources are read as text, the graph and the library are fakes.
"""

import ast
import contextlib
import ctypes
import importlib
import re
from pathlib import Path

import pytest
import torch

from ldm_tpu_torch.ops import build, launch_counts
from ldm_tpu_torch.utils import graphs, launches

PACKAGE = Path(build.__file__).resolve().parents[1]
SOURCES = sorted(build.CSRC.glob("*.cu"))
EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)', re.S)
BLOCK = re.compile(r'extern\s+"C"\s*\{')
DEFINED = re.compile(r"^int\s+(\w+)\s*\(([^)]*)\)\s*\{", re.M | re.S)
FLAGGED = re.compile(r"^#ifdef\s+\w+\s*$(.*?)^#endif", re.M | re.S)


def entry_points(text: str) -> dict:
    """{name: parameters} of the ``extern "C"`` functions a source defines:
    one at a time, or the functions of an ``extern "C" { ... }`` block."""
    found = EXTERN.findall(text)
    for m in BLOCK.finditer(text):
        depth, i = 1, m.end()
        while depth:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            i += 1
        found += DEFINED.findall(text[m.end():i])
    return {name: len([p for p in params.split(",") if p.strip() not in ("", "void")])
            for name, params in found}


def split_source(source: Path):
    """A source's entry points built by default, and those it defines only
    under an ``#ifdef`` (built by a probe that passes the flag)."""
    text = source.read_text()
    flagged = entry_points("".join(FLAGGED.findall(text)))
    plain = entry_points(FLAGGED.sub("", text))
    return plain, flagged


def package_modules():
    """(dotted name, text) of every module of the package."""
    for path in sorted(PACKAGE.rglob("*.py")):
        parts = path.relative_to(PACKAGE.parent).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts), path.read_text()


def declarations() -> dict:
    """{source stem: [(module, build.Library)]}: every library a module of
    the package declares."""
    out = {}
    for name, text in package_modules():
        if "build.Library(" in text:
            for lib in vars(importlib.import_module(name)).values():
                if isinstance(lib, build.Library):
                    out.setdefault(lib.name, []).append((name, lib))
    return out


@pytest.mark.parametrize("source", SOURCES, ids=lambda s: s.name)
def test_the_module_that_loads_a_source_declares_its_entry_points(source):
    """One module declares the library it loads with exactly the entry
    points its source defines, each with the prototype's number of
    parameters and an int result; a probe that builds the source with a flag
    (resnet_clocks) declares the flagged ones too."""
    plain, flagged = split_source(source)
    assert plain, f"{source.name} defines no entry point"
    found = declarations().get(source.stem, [])
    loaders = [m for m, lib in found if set(lib.entry_points) == set(plain)]
    assert len(loaders) == 1, (source.name, [m for m, _ in found])
    for module, lib in found:
        want = plain if module in loaders else {**plain, **flagged}
        assert set(lib.entry_points) == set(want), (module, source.name)
        for function, (argtypes, restype) in lib.entry_points.items():
            assert len(argtypes) == want[function], (module, function)
            assert restype is ctypes.c_int, (module, function)


def test_build_and_graphs_know_no_kernel():
    """``ops/build.py`` names no entry point and no source; ``utils/graphs.py``
    imports nothing from ``ldm_tpu_torch.ops``."""
    names = {n for s in SOURCES for n in entry_points(s.read_text())}
    text = Path(build.__file__).read_text()
    assert names and not [n for n in names if n in text]
    assert not [s.stem for s in SOURCES if s.stem in text]
    tree = ast.parse(Path(graphs.__file__).read_text())
    imported = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    imported += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert imported and not [m for m in imported if m and m.startswith("ldm_tpu_torch.ops")]
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
                and n.module == "ldm_tpu_torch" and any(a.name == "ops" for a in n.names)]


def test_only_the_declaring_module_names_an_entry_point_and_no_function_counts():
    """An entry point is named only in a module that declares it; no module
    keeps a count in an attribute of a function (``f.launches = 0``)."""
    owners = {}
    for found in declarations().values():
        for module, lib in found:
            for f in lib.entry_points:
                owners.setdefault(f, set()).add(module)
    for name, text in package_modules():
        for function in re.findall(r"\bldm_[a-z0-9_]+\b", text):
            if function in owners:
                assert name in owners[function], (name, function)
        for n in ast.walk(ast.parse(text)):
            targets = (n.targets if isinstance(n, ast.Assign)
                       else [n.target] if isinstance(n, ast.AugAssign) else [])
            for t in targets:
                if isinstance(t, ast.Attribute) and t.attr in ("launches", "calls",
                                                               "persistent_launches"):
                    assert getattr(t.value, "id", None) == "self", (name, ast.unparse(t))


@pytest.fixture
def counts():
    before = launches.snapshot()
    launches.restore({})
    yield
    launches.restore(before)


def test_registry_snapshot_since_restore_add(counts):
    launches.count("k")
    base = launches.snapshot()
    launches.count("k", 3)
    launches.count("k.sub")
    assert launches.since(base) == {"k": 3, "k.sub": 1}
    captured = launches.since(base)
    launches.restore(base)
    assert (launches.read("k"), launches.read("k.sub")) == (1, 0)
    for _ in range(2):
        launches.add(captured)
    assert (launches.read("k"), launches.read("k.sub")) == (7, 2)
    assert launches.since(launches.snapshot()) == {}


class FakeGraph:
    """A captured graph whose replay runs no Python, as a real one."""

    def replay(self):
        pass


def test_a_replayed_graph_counts_what_an_eager_loop_would(counts, monkeypatch):
    """StepGraph without a card: warm-up steps count, the capture counts
    nothing, and every replay adds what one step counts, sub-counts and
    counts no op declares included."""
    monkeypatch.setattr(graphs, "side_stream", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())

    def step():
        launches.count("linear_attention_fwd", 8)
        launches.count("linear_attention_fwd.persistent", 6)
        launches.count("softmax_attention.self")

    g = graphs.StepGraph(step, "cuda", warmup=3)
    want = {"linear_attention_fwd": 8, "linear_attention_fwd.persistent": 6,
            "softmax_attention.self": 1}
    assert g.launches == want
    for k, n in want.items():
        assert launches.read(k) == 3 * n
    for _ in range(5):
        g.replay()
    for k, n in want.items():
        assert launches.read(k) == 8 * n


def test_a_library_hash_covers_only_the_headers_its_source_includes(tmp_path, monkeypatch):
    """Transitive includes beside the source, and nothing else, go into a
    library's name: an edit to a header rebuilds only what includes it."""
    monkeypatch.setenv("LDM_TPU_TORCH_BUILD_DIR", str(tmp_path / "b"))
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "a.cu").write_text('#include <cstdint>\n#include "x.cuh"\nint a;\n')
    (csrc / "x.cuh").write_text('#pragma once\n  #  include "y.cuh"\n')
    (csrc / "y.cuh").write_text('#pragma once\n#include "x.cuh"\n')
    (csrc / "b.cu").write_text('#include "z.cuh"\n')
    (csrc / "z.cuh").write_text("#pragma once\n")
    a, b = csrc / "a.cu", csrc / "b.cu"
    assert build.includes(a) == [csrc / "x.cuh", csrc / "y.cuh"]
    assert build.includes(b) == [csrc / "z.cuh"]
    la, lb = build.lib_path(a), build.lib_path(b)
    (csrc / "y.cuh").write_text('#pragma once\n#include "x.cuh"\n// edited\n')
    assert build.lib_path(a) != la and build.lib_path(b) == lb
    (csrc / "z.cuh").write_text("#pragma once\n// edited\n")
    assert build.lib_path(b) != lb
    # the repo's own: the GroupNorm and Adam passes share no header with the attention
    for name in ("group_norm_silu.cu", "fused_adam_ema.cu"):
        assert build.CSRC / "linear_attention_common.cuh" not in build.includes(
            build.CSRC / name)


def test_the_production_set_leaves_the_probes_out():
    stems = {s.stem for s in build.sources()}
    probes = {s.stem for s in SOURCES} - stems
    assert probes == {"resnet_block_probe", "linear_attention_fwd_probe"}
    assert "linear_attention_fwd" in stems
    assert set(launch_counts()) == stems  # an op counts under its library's name
    with pytest.raises(FileNotFoundError):
        build.build("no_such_source")


def test_a_library_builds_what_it_loads_at_its_first_call(monkeypatch, tmp_path):
    """A production source's first call builds the production set, a
    probe's only that source; the entry points get their C signatures, and
    only declared ones are reachable."""
    asked = []

    def fake_build(*names):
        asked.append(names)
        srcs = [build.CSRC / f"{n}.cu" for n in names] if names else build.sources()
        return {s.name: (tmp_path / f"lib{s.stem}.so", "", 0.0) for s in srcs}

    class FakeCDLL:
        def __init__(self, path):
            self.path = path
            self.ldm_f = type("F", (), {"__call__": lambda self, x: x + 1})()

    monkeypatch.setattr(build, "build", fake_build)
    monkeypatch.setattr(ctypes, "CDLL", FakeCDLL)
    lib = build.Library("group_norm_silu", {"ldm_f": ([ctypes.c_int], ctypes.c_int)})
    assert lib.cdll is None and asked == []
    assert lib.ldm_f(1) == 2 and lib.ldm_f(2) == 3 and asked == [()]
    assert lib.cdll.path == str(tmp_path / "libgroup_norm_silu.so")
    assert (lib.ldm_f.argtypes, lib.ldm_f.restype) == ([ctypes.c_int], ctypes.c_int)
    with pytest.raises(AttributeError, match="no declared entry point"):
        lib.ldm_g
    build.Library("resnet_block_probe", {"ldm_f": ([], ctypes.c_int)}).ldm_f(0)
    assert asked == [(), ("resnet_block_probe",)]
