"""A launched batch's wait behind the batches before it on the card, and for
its hand-back: the mean, over the window's batches launched from
``counters_from_s`` into the schedule, of (landed on the host less launch
start) less the batch's own time on the card, in ms (the program's
``serve.batch`` records, ``ldm_tpu_torch/utils/profiling.py``).  Batches
launched while the profiler ran are left out.  ``counters_from_s`` counts
from the window's open plus a traced run's pause, as ``serve.queue_ms``
finds it in the ``serve.request`` records.  None where no batch has a
device time (the CPU) or the program keeps no such records."""


def read(run):
    try:
        from ldm_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    t0 = run.t_process + run.e2e["setup_s"]
    reqs = records("serve.request", t0, t0 + run.window_s, profiled=True)
    held = max((r["t_ns"] for r in reqs if r["profiled"]), default=None)
    after = [r["t_ns"] for r in reqs if held is not None and r["t_ns"] > held]
    pause = (min(after) - held) * 1e-9 if after else 0.0
    since = t0 + pause + float(run.params.get("counters_from_s", 0.0))
    rs = [r for r in records("serve.batch", since, t0 + run.window_s)
          if r["device_ms"] is not None]
    if not rs:
        return None
    return sum((r["t_landed"] - r["t_ns"]) * 1e-6 - r["device_ms"] for r in rs) / len(rs)
