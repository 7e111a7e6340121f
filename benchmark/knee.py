"""The sweep that found the serving cell's fixed rate, on the card:

    python -m benchmark.knee --workload pixel-serve-ddim50-open --rates 20,25,30 --seconds 20

One service (the cell's set-up), then the cell's open loop at each rate in
turn: the 50th and 95th percentile latency, the images a second that came
back, and the requests still out when the last one was due (a backlog that
grows with the window is a rate over the knee).  One JSON line a rate.
The benchmark's runs never run this; the cell's file keeps the rate.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.entries import serve
from benchmark.spec import Spec
from benchmark.traffic.open_poisson import latencies


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.knee")
    ap.add_argument("--workload", default="pixel-serve-ddim50-open")
    ap.add_argument("--rates", required=True, help="requests a second, comma-separated")
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("knee: no CUDA card", file=sys.stderr)
        return 2
    spec = Spec()
    workload, traffic = spec.workload(args.workload), spec.traffic(args.workload)
    run = harness.Run(cell=args.workload, workload=workload, traffic=traffic,
                      config=spec.config(workload["config"]), seed=args.seed,
                      seconds=args.seconds, traced=False, device=torch.device("cuda", 0),
                      t_process=time.perf_counter(), gen=spec.module("traffic", traffic["kind"]))
    with tempfile.TemporaryDirectory() as workdir:
        service, gen, _ = serve.build(run, workdir)
        for rate in (float(r) for r in args.rates.split(",")):
            requests, t0, gave_up, late, _ = serve.window(run, service, gen, rate=rate)
            last_due = requests[-1].due_at if requests else t0
            out = sum(1 for r in requests if r.done is None or r.done > last_due)
            lat = latencies(requests, gave_up)
            done = [r for r in requests if r.images is not None]
            span = max(r.done for r in done) - t0 if done else float("nan")
            print(json.dumps({"rate_rps": rate, "requests": len(requests),
                              "images": sum(r.n for r in requests),
                              "img_per_s_back": sum(r.n for r in done) / span,
                              "p50_s": float(np.percentile(lat, 50)),
                              "p95_s": float(np.percentile(lat, 95)),
                              "out_at_last_due": out, **late}), flush=True)
        service.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
