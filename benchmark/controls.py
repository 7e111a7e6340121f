"""The controls of the comparison that decides ``correct``, read beside the
program's own readings, on the card at a cell's own size:

    python -m benchmark.controls --workload <cell> --seeds 1,...,12 --seconds <s>

Each seed is one whole run of the cell (its window ``--seconds`` long) in
this one process, so that a dozen seeds pay the imports and the kernels'
load once.  After the run has judged the program, the entry puts each of
its ``CONTROLS`` in the program's place on the same inputs: the reference
computed in float8 e4m3 (the precision below the configurations' bfloat16;
``reference/arith.py``), and for the training cell the planted fault of
half of each batch left out (the mean taken over the rest), its late step
from the program's own state after the window.  The entry's own ``judge``
holds each stand-in's answers against the float32 reference, as the run
held the program's, and ``harness.result`` decides ``correct``; a state
left unchanged reads 1 in the changes by the measure itself and needs no
run.  Each outcome is one JSON line: the seed, what stood in, ``correct``
and every compared number beside its limit.  The limits in
``workloads/<cell>.json`` lie between the two kinds of readings
(``PERF.md``).  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time

import torch

from benchmark import harness
from benchmark.spec import Spec

# the float32 settings a process starts with, which the program runs under
START_TF32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def make_run(spec: Spec, cell: str, seed: int, device) -> harness.Run:
    """A run of ``cell`` that only holds a stand-in's compared numbers."""
    workload = spec.workload(cell)
    traffic = spec.traffic(cell)
    return harness.Run(cell=cell, workload=workload, traffic=traffic,
                       config=spec.config(workload["config"]), seed=seed,
                       seconds=float(spec.spec["run_seconds"]), traced=False,
                       device=torch.device(device), t_process=time.perf_counter(),
                       gen=spec.module("traffic", traffic["kind"]))


def program(spec: Spec, cell: str, seed: int, seconds: float, device=None) -> list:
    """One whole run of ``cell`` on the card (on ``device`` without looking
    for one, where given) in this process: (what, result line) of the
    program and of each of the entry's controls on the same inputs.  The
    float32 settings that a process starts with are put back first: the
    previous run's reference turned TF32 off."""
    from benchmark import run as bench

    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = START_TF32
    entry = spec.module("entries", spec.traffic(cell)["entry"])
    out, runs = io.StringIO(), []
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                         "--trace", "0"], require_card=device is None, spec=spec,
                        device=device, stand_ins=entry.CONTROLS, runs=runs)
    if rc != 0:
        raise RuntimeError(f"the run of {cell} on seed {seed} exited {rc}")
    lines = [("program", json.loads(out.getvalue().strip().splitlines()[-1]))]
    for what, got, want in runs[0].stood_in:
        sub = make_run(spec, cell, seed, runs[0].device)
        entry.judge(sub, got, want)
        lines.append((what, harness.result(sub, spec)))
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.controls")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=10.0,
                    help="the window of each run of the program")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    for seed in (int(s) for s in args.seeds.split(",")):
        for what, line in program(spec, args.workload, seed, args.seconds):
            print(json.dumps({"cell": args.workload, "seed": seed, "what": what,
                              "correct": line["correct"], "checks": line["checks"],
                              "attempted": line["attempted"], "failed": line["failed"]}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
