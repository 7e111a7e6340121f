"""The serving cell: ``build_generation_service`` (DDIM, B slots a batch,
the batcher's ``max_delay_s``) started and fed by an open loop
(``traffic/open_poisson.py``) through ``GenerationService.submit``.

Set-up writes the seeded weights as a checkpoint under ``TMPDIR``, builds
and starts the service (its warm-up batch is the capture).  The window
sends the arrivals due in ``--seconds`` and waits for every reply, at most
``wait_s`` past the last one; ``serve_p95_s`` is the 95th percentile over
all requests of the window, each timed from when it was due, a failed or
missing one counting until the wait gave up.  The service's counters
(padded slots, batches, the batcher's host time) are read as their
difference from ``counters_from_s`` into the schedule until every reply
is in.  In the traced run, past the profiled slice the sender waits until
the card is idle and the profiler has stopped, and the rest of the schedule
moves back by that pause: no backlog forms, and the counters and the
latencies read the open loop as an untraced run offers it.

Compared (after the service stopped, the program freed): ``check_requests``
finished requests drawn from the seed, the one with the most images among
them, against the reference's DDIM from the same x_T and classes, packed to
uint8 the same way: the worst image's RMS difference in uint8 levels.

Params: ``batch``, ``sampler_steps``, ``max_delay_s``, the traffic's
(``rate_rps``, ``min_images``, ``max_images``), ``wait_s``,
``check_requests``, ``trace_at_s`` / ``trace_s`` (the profiled slice, early
in the window; the traced run then pauses its sender until the card is
idle), ``counters_from_s``, ``limits``.
"""

from __future__ import annotations

import os
import tempfile
import time

import numpy as np
import torch

from benchmark.entries import common
from benchmark.harness import Check
from benchmark.reference import diffusion as ref
from benchmark.reference.arith import Arith, tf32_off
from benchmark.reference.unet import RefUNet
from benchmark.tracing import Slice
from benchmark.weights import stream_seed

# what the controls put in the program's place (``benchmark/controls.py``)
CONTROLS = ("control_fp8",)
PICK = 33


def build(run, workdir: str):
    """The started service and the traffic, as set-up leaves them."""
    from ldm_tpu_torch.serving.builder import build_generation_service

    p = run.params
    prog = run.config["program"]
    d = prog["data"]
    shape = (d["image_size"], d["image_size"], d["image_channels"])
    traffic = run.gen.Traffic(p, run.seed, run.device, d.get("num_classes", 10))
    ckpt = os.path.join(workdir, "unet.pt")
    torch.save({k: v.cpu() for k, v in common.unet_weights(run).items()}, ckpt)
    service = build_generation_service(
        common.program_config(run, workdir), checkpoint=ckpt, sampler="ddim",
        ddim_steps=int(p["sampler_steps"]), batch_size=int(p["batch"]),
        max_delay_s=float(p["max_delay_s"]), device=run.device,
        x_init_fn=traffic.x_init(shape))
    os.remove(ckpt)
    return service.start(warmup=True), traffic, shape


def counters(service) -> dict:
    s = service.stats()
    return {"batches": s.batches, "padded_slots": s.padded_slots,
            "host_ms": s.host_ms_per_batch * s.batches}


def window(run, service, traffic, rate=None, seconds=None):
    """Send the schedule and wait; returns (requests, t0, gave_up, late,
    counted): ``counted`` is the service's counters from ``counters_from_s``
    into the window (None where the window is shorter)."""
    from benchmark.traffic.open_poisson import drive

    p = run.params
    seconds = run.seconds if seconds is None else seconds
    requests = traffic.schedule(seconds, rate)
    sl = Slice(run.device, sync=False) if run.traced else None
    count_from = float(p.get("counters_from_s", 0.0))
    counted, shift = {}, [0.0]
    if sl is not None:
        # the profiler starts and stops only with the card idle (started or
        # stopped while the service's threads launch, it stalls): it starts
        # here; the slice runs from ``trace_at_s`` into the window (past the
        # first batches' ramp from idle) for ``trace_s``; the sender then
        # waits for every reply, the profiler stops, and the rest of the
        # schedule moves back by the pause
        at, span = float(p.get("trace_at_s", 1.0)), float(p.get("trace_s", 1.5))
        sl.start(mark=False)

    def tick(now):
        if sl is not None and sl.open and not sl.started and now >= t0 + at:
            sl.mark()
        elif sl is not None and sl.open and sl.started and now >= sl.started + span:
            sl.cut()
            paused = time.perf_counter()
            give_up = paused + float(p.get("wait_s", 60.0))
            while any(r.sent is not None and r.done is None for r in requests):
                if time.perf_counter() > give_up:
                    break
                time.sleep(0.005)
            sl.stop()
            shift[0] = time.perf_counter() - paused
            run.note(f"traced run: the sender paused {shift[0]!r} s at {paused - t0!r} s "
                     f"into the window; the rest of the schedule moved back by as much")
            return shift[0]
        if not counted and now >= t0 + shift[0] + count_from:
            counted["from"] = counters(service)
        return None
    t0 = time.perf_counter() + 0.05
    late = drive(lambda c, n, s: service.submit(c, n, seed=s), requests, t0,
                 float(p.get("wait_s", 60.0)), tick)
    gave_up = time.perf_counter()
    if counted:
        after = counters(service)
        counted = {k: after[k] - counted["from"][k] for k in after}
    if sl is not None:
        if sl.open:
            sl.stop()
        run.trace = sl.reduce()
    return requests, t0, gave_up, late, counted or None


def run(run) -> None:
    from benchmark.traffic.open_poisson import latencies

    p = run.params
    b = int(p["batch"])
    with tempfile.TemporaryDirectory() as workdir:
        service, traffic, shape = build(run, workdir)
        common.reset_peak(run.device)
        win = common.Window(run)
        requests, t0, gave_up, late, counted = window(run, service, traffic)
        win.close()
        service.stop()
    common.read_peak(run)
    if counted is not None:
        run.service = dict(counted, batch_size=b)
    lat = latencies(requests, gave_up)
    run.attempted = len(requests)
    run.failed = sum(r.images is None for r in requests)
    run.e2e["serve_p95_s"] = float(np.percentile(lat, 95))
    steady = [x for x, r in zip(lat, requests) if r.due >= float(p.get("counters_from_s", 0))]
    run.note(f"open loop: {len(requests)} requests at {p['rate_rps']} /s, "
             f"{sum(r.n for r in requests)} images, {run.failed} failed; sender late "
             f"max {late['late_max_s']!r} s, mean {late['late_mean_s']!r} s; "
             f"p50 {float(np.percentile(lat, 50))!r} s; from the counters' start "
             f"p50 {float(np.percentile(steady, 50)) if steady else None!r} s, p95 "
             f"{float(np.percentile(steady, 95)) if steady else None!r} s; counters {counted}")
    del service
    common.free(run.device)

    done = [i for i, r in enumerate(requests) if r.images is not None]
    if not done:
        run.checks.append(Check("served_rms_levels", float("inf"),
                                p["limits"]["served_rms_levels"]))
        return
    chosen = choose(run, requests, done)
    got = torch.from_numpy(np.concatenate([r.images for r in chosen])).to(run.device).float()
    tf32_off()
    want = reference(run, traffic, chosen, shape, Arith("fp32"))
    judge(run, got, want)
    for what in run.stand_ins:  # the control, on these requests (benchmark/controls.py)
        run.stood_in.append((what, reference(run, traffic, chosen, shape, Arith("fp8")), want))


def choose(run, requests, done) -> list:
    """``check_requests`` of the finished requests (indices ``done``): the
    one with the most images, and the rest drawn from the seed."""
    rng = np.random.default_rng(stream_seed(run.seed, PICK))
    longest = max(done, key=lambda i: requests[i].n)
    others = [i for i in done if i != longest]
    n_more = min(int(run.params["check_requests"]) - 1, len(others))
    picks = [longest] + sorted(rng.choice(others, size=n_more, replace=False).tolist())
    return [requests[i] for i in picks]


def judge(run, got: torch.Tensor, want: torch.Tensor) -> None:
    """The worst image's RMS gap of ``got`` (served images, or a control's)
    from the float32 reference's ``want``, in uint8 levels, against its
    limit."""
    rms = (got - want).flatten(1).pow(2).mean(dim=1).sqrt().max().item()
    run.note(f"serve check: {got.shape[0]} images, worst RMS {rms!r} uint8 levels")
    run.checks.append(Check("served_rms_levels", rms, run.params["limits"]["served_rms_levels"]))


def reference(run, traffic, chosen, shape, arith: Arith) -> torch.Tensor:
    """The chosen requests' images as uint8 levels (float), the reference's
    DDIM in ``arith`` from the same x_T and classes."""
    prog = run.config["program"]
    mp, dc = prog["model"]["params"], prog["diffusion"]
    k = prog["data"].get("num_classes", 10)
    sched = ref.Schedule(dc["params"]["n_steps"], dc.get("schedule", "linear"),
                         dc.get("beta_start", 1e-4), dc.get("beta_end", 0.02), run.device)
    unet = RefUNet(common.unet_weights(run), mp, arith)
    fn = traffic.x_init(shape)
    x = torch.from_numpy(np.concatenate([fn([r.seed] * r.n, list(range(r.n)))
                                         for r in chosen])).to(run.device)
    y = torch.tensor([r.cls for r in chosen for _ in range(r.n)], device=run.device)
    with torch.no_grad():
        x0 = ref.ddim(sched, unet, x, y, k, float(dc["cfg_scale"]),
                      int(run.params["sampler_steps"]))
    return ref.to_uint8(x0)
