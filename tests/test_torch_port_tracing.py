"""The port's recorder and profiler ranges (``ldm_tpu_torch/utils/profiling.py``)
on the CPU: the ring's bound, windows by time, the switch, the ``profiled``
mark, the ranges as the profiler exports them; the records of the
generation service on both batcher paths and of the sampler's loop; the
benchmark's three readers of them on a hand-made run; the profile tools'
busy time as a union of intervals.

Each test gets a recorder of its own; one intra-op thread; every service is
stopped in a ``with`` and every wait has a timeout.
"""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ldm_tpu_torch import native
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.serving import GenerationService
from ldm_tpu_torch.utils import profiling

SHAPE = (4, 4, 1)
WAIT = 30  # seconds: every future.result


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rec(monkeypatch):
    """A fresh recorder in the module's place, so no other test's records
    show."""
    r = profiling.Recorder()
    monkeypatch.setattr(profiling, "RECORDER", r)
    monkeypatch.setattr(profiling, "record", r.add)
    monkeypatch.setattr(profiling, "records", r.records)
    return r


def zero_eps(x, t, y):
    return torch.zeros_like(x)


def class_sampler(classes, x_init, generator):
    return (classes.to(torch.float32) / 10.0)[:, None, None, None].expand(
        (classes.shape[0],) + SHAPE)


def sample(diffusion, steps=None):
    classes = torch.arange(2)
    gen = torch.Generator().manual_seed(0)
    if steps is None:
        return diffusion.sample(zero_eps, classes, SHAPE, cfg_scale=0.0, generator=gen)
    return diffusion.sample_ddim(zero_eps, classes, SHAPE, n_sample_steps=steps,
                                 cfg_scale=0.0, generator=gen)


# --- the recorder ------------------------------------------------------------

def test_a_ring_keeps_its_newest_records_up_to_its_bound():
    r = profiling.Recorder(maxlen=3)
    for i in range(5):
        r.add("x", i, False, i=i)
    assert [x["i"] for x in r.records("x")] == [2, 3, 4]
    assert r.records("y") == []
    assert profiling.RING >= 16 * 1200  # many serving windows of requests


def test_threads_recording_at_once_lose_nothing():
    """The service's threads and a reader share one recorder: 16 writers
    against a reader, the interpreter switching threads often."""
    import sys
    import threading

    r = profiling.Recorder()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def write(k):
            for i in range(1000):
                r.add("x", i, False, k=k)

        threads = [threading.Thread(target=write, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            r.records("x", 0.0)
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    got = r.records("x")
    assert len(got) == 16000
    assert all(sum(x["k"] == k for x in got) == 1000 for k in range(16))


def test_records_are_windowed_by_time_and_profiled_ones_left_out_unless_asked():
    r = profiling.Recorder()
    for t_s, marked in ((1.0, False), (2.0, False), (2.5, True), (3.0, False)):
        r.add("x", int(t_s * 1e9), marked, t_s=t_s)
    assert [x["t_s"] for x in r.records("x", 2.0, 3.0)] == [2.0]
    assert [x["t_s"] for x in r.records("x", 2.0, 3.0, profiled=True)] == [2.0, 2.5]
    assert [x["t_s"] for x in r.records("x", since_s=1.5)] == [2.0, 3.0]
    assert [x["t_s"] for x in r.records("x", until_s=2.0)] == [1.0]


def test_switched_off_nothing_is_recorded_and_no_range_is_made(rec):
    profiling.set_enabled(False)
    try:
        sample(GaussianDiffusion(4))
        with GenerationService(class_sampler, image_shape=SHAPE, num_classes=10,
                               batch_size=2, max_delay_s=0.01) as svc:
            svc.submit(1, n=3).result(timeout=WAIT)
        with profile(activities=[ProfilerActivity.CPU]):
            assert not profiling.profiler_on()
    finally:
        profiling.set_enabled(True)
    for name in ("sampler.run", "serve.batch", "serve.request"):
        assert rec.records(name, profiled=True) == []


def test_records_made_under_the_profiler_are_marked(rec):
    diffusion = GaussianDiffusion(4)
    sample(diffusion)
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.profiler_on()
        sample(diffusion)
    assert not profiling.profiler_on()
    runs = rec.records("sampler.run", profiled=True)
    assert [x["profiled"] for x in runs] == [False, True]
    assert len(rec.records("sampler.run")) == 1


def test_ranges_are_host_operations_in_the_profilers_export(rec, tmp_path):
    """The sampler's ranges, one pair a step on the calling thread: exported
    as ``cpu_op``, never as a user annotation, which the profiler would copy
    onto a card's timeline.  The service marks no ranges of its own."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sample(GaussianDiffusion(3))
        with GenerationService(class_sampler, image_shape=SHAPE, num_classes=10,
                               batch_size=2, max_delay_s=0.01, use_native=False) as svc:
            svc.submit(1, n=3).result(timeout=WAIT)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ours = [e for e in json.loads(path.read_text())["traceEvents"]
            if str(e.get("name", "")).startswith(("serve.", "sampler."))]
    assert {e["name"] for e in ours} == {"sampler.draw", "sampler.launch"}
    assert {e["cat"] for e in ours} == {"cpu_op"}
    assert sum(e["name"] == "sampler.launch" for e in ours) == 3
    cpu = torch.autograd.DeviceType.CPU
    kineto = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(("serve.", "sampler."))]
    assert kineto and all(e.device_type() == cpu and not e.is_user_annotation()
                          for e in kineto)


def test_a_range_the_profiler_starts_or_stops_inside_ends_quietly(rec):
    """A range begun where the profiler did not record this thread has
    nothing to end; one the profiler stopped inside (a noise callback may
    stop it) ends as well; the block around either goes on."""
    r = profiling.host_range("sampler.launch", True)
    r.__enter__()
    with profile(activities=[ProfilerActivity.CPU]):
        r.__exit__(None, None, None)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    r = profiling.host_range("sampler.draw", profiling.profiler_on())
    r.__enter__()
    prof.__exit__(None, None, None)
    r.__exit__(None, None, None)
    assert [e.name for e in prof.events()] == ["sampler.draw"]
    assert profiling.host_range("sampler.launch", False).__enter__() is None


# --- the program's records -----------------------------------------------------

@pytest.mark.parametrize("use_native", [True, False])
def test_the_service_records_each_batch_and_each_request(rec, use_native):
    if use_native and not native.available():
        pytest.skip("native library unavailable")
    with GenerationService(class_sampler, image_shape=SHAPE, num_classes=10, batch_size=4,
                           max_delay_s=0.01, use_native=use_native) as svc:
        futures = [svc.submit(c, n=n) for c, n in ((1, 3), (2, 6), (3, 1), (4, 2))]
        for f in futures:
            f.result(timeout=WAIT)
        s = svc.stats()  # a batch is counted and recorded before its requests resolve
    reqs = rec.records("serve.request")
    batches = rec.records("serve.batch")
    assert len(reqs) == 4
    for r in reqs:
        assert r["t_ns"] <= r["t_launch"] <= r["t_landed"] <= r["t_resolved"]
        assert r["profiled"] is False
        assert any(b["t_ns"] == r["t_launch"] and b["t_landed"] == r["t_landed"]
                   for b in batches)
    assert len(batches) == s.batches - 1  # the warm-up batch lands on the caller's thread
    assert s.images == 12
    for b in batches:
        assert b["t_ns"] <= b["t_landed"] and b["device_ms"] is None
    waits = sorted((r["t_launch"] - r["t_ns"]) * 1e-9 for r in reqs)
    assert s.queue_p50_s == waits[2] and s.queue_p95_s == waits[3]
    assert 0 < s.queue_p50_s <= s.latency_p50_s
    assert s.device_ms_per_batch == 0.0  # no card, no device times
    assert {"queue_p50_s", "queue_p95_s", "device_ms_per_batch"} <= set(s.as_dict())


def test_http_stats_shows_the_queue_wait_and_the_device_time(rec):
    import urllib.request

    from ldm_tpu_torch.serving import GenerationHTTPServer

    with GenerationService(class_sampler, image_shape=SHAPE, num_classes=10, batch_size=2,
                           max_delay_s=0.01) as svc, GenerationHTTPServer(svc) as server:
        svc.submit(1, n=3).result(timeout=WAIT)
        with urllib.request.urlopen(server.address + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
    assert stats["queue_p50_s"] > 0 and stats["queue_p95_s"] >= stats["queue_p50_s"]
    assert stats["device_ms_per_batch"] == 0.0
    assert stats["latency_p50_s"] >= stats["queue_p50_s"]


@pytest.mark.parametrize("steps", [None, 3])
def test_each_sampler_call_is_one_record_of_its_steps(rec, steps):
    diffusion = GaussianDiffusion(5)
    for _ in range(2):
        sample(diffusion, steps)
    runs = rec.records("sampler.run")
    assert len(runs) == 2
    for r in runs:
        assert r["steps"] == (5 if steps is None else 3)
        assert r["launch_ns"] > 0 and r["profiled"] is False
        assert (r["draw_ns"] > 0) == (steps is None)  # DDIM at eta 0 draws nothing


# --- the benchmark's readers ---------------------------------------------------

def reader(name):
    from benchmark.spec import Spec

    return Spec().module("metrics", name).read


def hand_made_run(counters_from_s=2.0):
    """A run whose window is [1010, 1015) s on the recorder's clock."""
    from benchmark.harness import Run

    run = Run(cell="c", workload={}, traffic={"params": {"counters_from_s": counters_from_s}},
              config={}, seed=1, seconds=5.0, traced=True, device=torch.device("cpu"),
              t_process=1000.0)
    run.e2e["setup_s"] = 10.0
    run.window_s = 5.0
    return run


def ns(seconds):
    return int(seconds * 1e9)


def test_serve_queue_ms_reads_the_windows_unprofiled_requests(rec):
    read = reader("serve.queue_ms")
    assert read(hand_made_run()) is None
    for t, wait_s, marked in ((1009.0, 9.0, False), (1011.0, 9.0, False),
                              (1012.5, 0.25, False), (1013.0, 0.75, False),
                              (1013.5, 9.0, True), (1015.5, 9.0, False)):
        profiling.record("serve.request", ns(t), marked, t_launch=ns(t + wait_s))
    assert read(hand_made_run()) == pytest.approx(500.0)
    assert read(hand_made_run(counters_from_s=0.0)) == pytest.approx((9.0 + 1.0) / 3 * 1e3)


def test_the_serve_readers_count_from_counters_from_s_after_a_traced_runs_pause(rec):
    """Requests under the profiler to 1010.5 s, the sender held 2 s, the
    schedule on from 1012.5 s: ``counters_from_s`` = 2 counts from 1014 s
    (the window's open, 1010, plus the pause), for the requests and for the
    batches alike."""
    for t, marked in ((1010.2, True), (1010.5, True), (1012.5, False), (1013.9, False),
                      (1014.6, False)):
        profiling.record("serve.request", ns(t), marked, t_launch=ns(t + (t - 1000) / 100))
        profiling.record("serve.batch", ns(t + 0.01), marked, t_landed=ns(t + 0.31),
                         device_ms=t - 1000)
    assert reader("serve.queue_ms")(hand_made_run()) == pytest.approx(146.0)
    assert reader("serve.stream_ms")(hand_made_run()) == pytest.approx(300.0 - 14.6)
    from_the_pause = hand_made_run(counters_from_s=0.0)
    assert reader("serve.queue_ms")(from_the_pause) == pytest.approx((125.0 + 139.0 + 146.0) / 3)


def test_serve_stream_ms_reads_device_timed_batches_only(rec):
    read = reader("serve.stream_ms")
    profiling.record("serve.batch", ns(1013.0), False, t_landed=ns(1013.5), device_ms=None)
    assert read(hand_made_run()) is None  # the CPU: no device times
    for t, landed_s, device_ms, marked in ((1011.0, 9.0, 100.0, False),
                                           (1012.0, 0.4, 250.0, False),
                                           (1014.0, 0.6, 250.0, False),
                                           (1014.5, 9.0, 1.0, True)):
        profiling.record("serve.batch", ns(t), marked, t_landed=ns(t + landed_s),
                         device_ms=device_ms)
    assert read(hand_made_run()) == pytest.approx(250.0)


def test_sample_launch_ms_per_step_weighs_calls_by_their_steps(rec):
    read = reader("sample.launch_ms_per_step")
    assert read(hand_made_run()) is None
    for t, steps, launch_ms, marked in ((1009.0, 10, 100.0, False), (1010.5, 10, 2.0, False),
                                        (1011.0, 30, 10.0, False), (1012.0, 10, 90.0, True)):
        profiling.record("sampler.run", ns(t), marked, steps=steps, launch_ns=ns(launch_ms / 1e3))
    assert read(hand_made_run()) == pytest.approx(12.0 / 40)


# --- the profile tools' busy time --------------------------------------------------

def fake_profile(events):
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    made = [types.SimpleNamespace(start_ns=lambda a=a: a, duration_ns=lambda a=a, b=b: b - a,
                                  device_type=lambda d=d: cpu if d == "cpu" else cuda,
                                  is_user_annotation=lambda u=u: u)
            for a, b, d, u in events]
    results = types.SimpleNamespace(events=lambda: made)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


def test_device_busy_is_the_union_of_device_intervals():
    prof = fake_profile([(0, 10, "cuda", False), (5, 15, "cuda", False),
                         (20, 30, "cuda", False), (22, 25, "cuda", False),
                         (0, 100, "cuda", True),    # an annotation copied onto the card
                         (40, 90, "cpu", False)])   # host work
    assert profiling.device_busy_s(prof) == pytest.approx(25e-9)
    assert profiling.device_busy_s(fake_profile([])) == 0.0
    assert np.isclose(profiling.device_busy_s(fake_profile([(3, 4, "cuda", False)])), 1e-9)
