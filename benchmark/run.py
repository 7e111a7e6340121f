"""The benchmark of ``ldm_tpu_torch`` on one NVIDIA card.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json``: set-up (the program built from
the cell's configuration file, its weights drawn on the card from the
seed, every shape of the cell warmed up), then the window of ``--seconds``,
then the outputs checked against the plain reference (``reference/``).  The
last line on standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics; with ``--trace 1``
its per-layer ones, read by ``metrics/<name>.py`` from a profiled slice of
the window), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines on
standard error).

Without a CUDA card the run prints no result and exits 2.  Builds and
kernel caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _cache_dirs() -> None:
    """Fixed cache directories inside the checkout, set before the program
    is imported."""
    build = ROOT / "build"
    os.environ["LDM_TPU_TORCH_BUILD_DIR"] = str(build / "ldm_tpu_torch")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv):
    ap = argparse.ArgumentParser(prog="python -m benchmark.run", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, require_card: bool = True, spec=None, device=None, stand_ins=(),
         runs=None) -> int:
    """One run; ``require_card=False`` (tests) runs on ``device`` (the CPU)
    without looking for a card.  ``stand_ins`` and ``runs`` are the
    controls' (``benchmark/controls.py``): the stand-ins the entry reads
    beside the program, and a list the run is appended to."""
    args = parse(argv)
    _cache_dirs()
    import torch

    from benchmark import harness
    from benchmark.spec import Spec

    spec = spec or Spec()
    workload = spec.workload(args.workload)
    if require_card:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n < workload["chips"]:
            print(f"benchmark: the cell needs {workload['chips']} CUDA card(s), found {n}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    traffic = spec.traffic(args.workload)
    run = harness.Run(cell=args.workload, workload=workload, traffic=traffic,
                      config=spec.config(workload["config"]), seed=args.seed,
                      seconds=args.seconds, traced=bool(args.trace),
                      device=torch.device(device or "cpu"), t_process=T_PROCESS,
                      gen=spec.module("traffic", traffic["kind"]), stand_ins=tuple(stand_ins))
    if runs is not None:
        runs.append(run)
    if run.device.type == "cuda":
        from benchmark.yardsticks import PEAK_BF16_FLOPS, PEAK_BYTES_S, power_limit

        run.note(f"card: {power_limit()}; peaks {PEAK_BF16_FLOPS:.4g} FLOP/s bf16, "
                 f"{PEAK_BYTES_S:.4g} B/s")
    spec.module("entries", traffic["entry"]).run(run)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: the run imported {found}", file=sys.stderr)
        return 3
    harness.emit(harness.result(run, spec), run.checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
