"""One run of one cell: what the entry fills in, and the result line.

An entry (``entries/<entry>.py``) builds the program from the cell's
configuration, warms up, drives the window and checks the outputs against
the plain reference.  It fills a :class:`Run`: the end-to-end values, the
counts the per-layer readers read, the trace, and the compared numbers with
their limits.  :func:`result` turns it into the run's result line.
"""

from __future__ import annotations

import dataclasses
import json
import math
import sys
from typing import Dict, List, Optional, Tuple

import torch

from benchmark.spec import Spec
from benchmark.tracing import Trace

# top-level module names no run may hold (the JAX package and its stack)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ldm_tpu")


@dataclasses.dataclass
class Check:
    """One compared number: the program's gap from the reference, and the
    largest gap that passes."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Run:
    cell: str
    workload: dict        # the cell's entry in BENCHMARK.json
    traffic: dict         # the cell's traffic file
    config: dict          # the configuration's file
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t_process: float      # host clock at process start
    gen: object = None    # the traffic kind's module (traffic/<kind>.py)
    # filled by the entry
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    window_s: float = 0.0
    units: int = 0                       # steps or batches in the window
    flops: float = 0.0                   # the reference's products over the window
    fwd_sites: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    bwd_sites: List[Tuple[int, int, int]] = dataclasses.field(default_factory=list)
    n_params: int = 0
    service: Dict[str, float] = dataclasses.field(default_factory=dict)
    trace: Optional[Trace] = None
    memory_peak_bytes: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    # the controls' readings at the program's own state (benchmark/controls.py):
    # which stand-ins to read, and (what, their answers, the reference's)
    stand_ins: Tuple[str, ...] = ()
    stood_in: List[tuple] = dataclasses.field(default_factory=list)

    @property
    def params(self) -> dict:
        return self.traffic.get("params", {})

    def note(self, text: str) -> None:
        """A line on standard error, before the checks."""
        print(text, file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def device_info(run: Run) -> dict:
    cuda = run.device.type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": int(run.memory_peak_bytes)}
    if run.traced and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.slice_s
    return info


def metrics(run: Run, spec: Spec) -> dict:
    out = {}
    for m in spec.metrics(run.cell, run.traced):
        if run.traced:
            value = spec.module("metrics", m["name"]).read(run)
        else:
            value = run.e2e.get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run: Run, spec: Spec) -> dict:
    line = {"correct": bool(run.checks) and all(c.ok for c in run.checks),
            "attempted": int(run.attempted), "failed": int(run.failed),
            "metrics": metrics(run, spec), "device": device_info(run)}
    if run.traced and run.trace is not None:
        line["breakdown"] = {"device_ops": run.trace.top_ops(),
                             "idle_gaps": [[n, s] for n, s in run.trace.gaps]}
    line["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return line


def emit(line: dict, checks: List[Check]) -> None:
    """The checks as the last lines on standard error, the result as the
    last line on standard output."""
    for c in checks:
        print(f"check {c.name}: {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)


def rel_gap(a: float, b: float, floor: float = 0.0) -> float:
    """|a - b| over the larger of |b| and ``floor``."""
    return abs(a - b) / max(abs(b), floor, 1e-30)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Tuple[float, str]:
    """The largest gap of a leaf's norm from the reference's, over the larger
    of the reference's norm of that leaf and of the median leaf; ``keep``
    names the leaves compared (all by default)."""
    names = [k for k in ref if keep is None or k in keep]
    norms = sorted(ref[k] for k in names)
    median = norms[len(norms) // 2]
    gaps = [(rel_gap(prog[k], ref[k], median), k) for k in names]
    return max(gaps)


def median_leaf(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> float:
    """The median over the leaves (``keep``, all by default) of the gaps
    :func:`worst_leaf` takes the largest of: steady from seed to seed where
    the worst leaf swings."""
    names = [k for k in ref if keep is None or k in keep]
    norms = sorted(ref[k] for k in names)
    median = norms[len(norms) // 2]
    gaps = sorted(rel_gap(prog[k], ref[k], median) for k in names)
    return gaps[len(gaps) // 2]


def moved_leaves(ref_grad: Dict[str, float], share: float = 1e-3) -> set:
    """The leaves whose first gradient in the reference is at least ``share``
    of the median leaf's: a leaf under it moves under Adam by rounding
    alone, and its change is not compared."""
    norms = sorted(ref_grad.values())
    median = norms[len(norms) // 2]
    return {k for k, v in ref_grad.items() if v >= share * median}
