"""What the harness finds by name: ``BENCHMARK.json``, a cell's traffic file
(``workloads/<cell>.json``), a configuration's file (``configs/<config>.json``),
a traffic kind's generator (``traffic/<kind>.py``), an entry's code
(``entries/<entry>.py``) and a per-layer metric's reader
(``metrics/<metric>.py``).  A later cell, configuration, traffic kind or
metric is a new file and a new entry in ``BENCHMARK.json``; no file here
changes for it."""

from __future__ import annotations

import importlib.util
import json
import types
from pathlib import Path
from typing import Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root`` (the
    benchmark's folder; a test hands a temporary copy)."""

    def __init__(self, spec: Optional[dict] = None, root: Path = HERE):
        self.root = Path(root)
        self.spec = load_json(SPEC_FILE) if spec is None else spec

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def traffic(self, cell: str) -> dict:
        """The cell's traffic file: its entry, traffic kind and parameters."""
        return load_json(self.root / "workloads" / f"{cell}.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(ROOT / c["file"])  # a test's absolute path stays as is
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, traced: bool) -> list:
        """The metrics a run of ``cell`` reports: the end-to-end ones without
        the trace, the per-layer ones with it (each only where its
        ``workloads`` list names the cell, where it has one)."""
        group = self.spec["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def module(self, kind: str, name: str) -> types.ModuleType:
        """``<kind>/<name>.py`` of the benchmark's folder, loaded by path (a
        name may hold dots)."""
        path = self.root / kind / f"{name}.py"
        if not path.is_file():
            path = HERE / kind / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
