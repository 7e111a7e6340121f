"""The host's time to launch one sampler step: over the window's sampler
calls, the summed host time inside the steps' launches (a CUDA graph's
replay, or the eager step) over the summed steps, in ms (the program's
``sampler.run`` records, ``ldm_tpu_torch/utils/profiling.py``).  Calls made
while the profiler ran are left out; None where the program keeps no such
records."""


def read(run):
    try:
        from ldm_tpu_torch.utils.profiling import records
    except ImportError:
        return None
    t0 = run.t_process + run.e2e["setup_s"]
    rs = records("sampler.run", t0, t0 + run.window_s)
    steps = sum(r["steps"] for r in rs)
    if not steps:
        return None
    return sum(r["launch_ns"] for r in rs) / steps * 1e-6
