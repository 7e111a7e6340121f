"""The controls come out as not correct, decided as a run is decided.

After a run has judged the program, each of its entry's controls stands in
the program's place on the same inputs (the reference in float8; for the
training cell also half of each batch left out, its late step from the
program's own state) and goes through the entry's own ``judge`` and
``harness.result``.  On the card, ``python -m pytest benchmark/tests -q -m
card`` (a few minutes on an H100) runs each cell so, a 10 s window on one
seed, and sees the program correct and every stand-in not.  (A state left
unchanged reads 1 in the changes, over their limits, by the measure
itself.)  ``python -m benchmark.controls`` gives the readings over more
seeds (``PERF.md``).  On the CPU, at a tiny size, the same path runs and
judges every compared number."""

from __future__ import annotations

import pytest

from benchmark import controls
from benchmark.spec import Spec
from benchmark.tests.tiny import tiny_spec

SPEC = Spec()
CELLS = [w["name"] for w in SPEC.spec["workloads"]]


def _read(spec, cell, seconds, device, at_size: bool):
    """``at_size``: the cell's own size, where every stand-in has to come
    out incorrect (a tiny copy's gaps are not the cell's)."""
    lines = controls.program(spec, cell, 3_900_000_001, seconds, device=device)
    entry = spec.module("entries", spec.traffic(cell)["entry"])
    assert [w for w, _ in lines] == ["program", *entry.CONTROLS]
    assert lines[0][1]["correct"] is True, lines[0][1]["checks"]
    for what, line in lines[1:]:
        assert set(line["checks"]) == set(spec.traffic(cell)["params"]["limits"]), what
        assert line["correct"] is False or not at_size, (what, line["checks"])


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_come_out_incorrect(cell, card):
    _read(SPEC, cell, 10.0, None, at_size=True)


@pytest.mark.parametrize("cell", CELLS)
def test_the_controls_are_judged_by_the_entries_own_comparison(cell, tmp_path):
    _read(tiny_spec(tmp_path), cell, 1.0, "cpu", at_size=False)
