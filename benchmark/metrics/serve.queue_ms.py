"""A served request's wait in the queue: the mean, over the window's
requests submitted from ``counters_from_s`` into the schedule, of the launch
start of the batch that completed the request less its submission, in ms
(the program's ``serve.request`` records,
``ldm_tpu_torch/utils/profiling.py``).  Requests made while the profiler ran
are left out.  A traced run's sender holds while the profiler stops and
moves the rest of its schedule back by the pause, so ``counters_from_s``
counts from the window's open plus that pause, the gap between the last
request made under the profiler and the first after it (to within one gap
between requests): the span of the cell's ``ServiceStats`` counters.  None
where the program keeps no such records."""


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
    rs = [r for r in reqs if not r["profiled"] and r["t_ns"] >= since * 1e9]
    if not rs:
        return None
    return sum(r["t_launch"] - r["t_ns"] for r in rs) / len(rs) * 1e-6
