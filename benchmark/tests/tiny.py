"""A copy of the benchmark's cells at a size the CPU runs in seconds: the
configurations cut to 8 channels and 16 px, T = 10, the program in float32
(``use_amp`` off: a tiny model's bfloat16 gaps are not the cell's, and in
float32 a sound run reads rounding alone, so a planted fault stands out
against the cell's limits), and small batches and windows; each cell's file
otherwise as committed."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from benchmark.spec import HERE, ROOT, Spec, load_json

PARAMS = {
    # 7 batches an epoch: the late step always lies in a later epoch than the
    # 6 checked steps
    "train": {"batch": 8, "train_images": 56, "trace_from": 2, "trace_units": 3},
    "sample": {"batch": 4, "check_images": 3, "trace_from": 2, "trace_units": 3},
    "serve": {"batch": 4, "rate_rps": 5, "max_images": 3, "check_requests": 3,
              "sampler_steps": 5, "trace_at_s": 0.3, "trace_s": 0.5,
              "counters_from_s": 0.0},
}


def tiny_program(prog: dict) -> dict:
    prog = copy.deepcopy(prog)
    prog["model"]["params"].update(channels=8, channel_multipliers=[1, 2])
    prog["data"]["image_size"] = 16
    prog["diffusion"]["params"]["n_steps"] = 10
    prog["batch_size"] = 8
    prog["use_amp"] = False
    if "autoencoder" in prog:
        prog["autoencoder"]["params"].update(channels=8, channel_multipliers=[1, 2])
        prog["model"]["params"]["channel_multipliers"] = [1]
    return prog


def tiny_spec(tmp: Path, spec: dict = None) -> Spec:
    """``spec`` (``BENCHMARK.json`` by default) with every configuration and
    cell file copied, cut, under ``tmp``."""
    tmp = Path(tmp)
    (tmp / "configs").mkdir(exist_ok=True)
    (tmp / "workloads").mkdir(exist_ok=True)
    spec = copy.deepcopy(spec or load_json(ROOT / "BENCHMARK.json"))
    for c in spec["configs"]:
        cfg = load_json(ROOT / c["file"])
        cfg["program"] = tiny_program(cfg["program"])
        f = tmp / "configs" / f"{c['name']}.json"
        f.write_text(json.dumps(cfg))
        c["file"] = str(f)
    for w in spec["workloads"]:
        src = HERE / "workloads" / f"{w['name']}.json"
        if src.exists():
            t = load_json(src)
            t["params"].update(PARAMS[t["entry"]])
            (tmp / "workloads" / f"{w['name']}.json").write_text(json.dumps(t))
    return Spec(spec, tmp)


def run_cell(spec: Spec, cell: str, capsys, seed: int = 2**31 + 17, trace: int = 0,
             seconds: float = 1.0) -> dict:
    """One run of ``cell`` on the CPU; its result line."""
    from benchmark import run

    capsys.readouterr()
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
                   "--trace", str(trace)], require_card=False, spec=spec, device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0, out[-5:]
    return json.loads(out[-1])

