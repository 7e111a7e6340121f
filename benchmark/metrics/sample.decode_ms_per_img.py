"""The latent sampler's decode on the card, per image: over the window's
``sampler.decode`` records (``ldm_tpu_torch/utils/profiling.py``), the
device ms between the CUDA timing events around each decode over the
images decoded, in ms.  Decodes made while the profiler ran are left out;
None where the program keeps no such records or no decode has a device
time (the CPU)."""


def read(run):
    try:
        from ldm_tpu_torch.utils.profiling import event_ms, records
    except ImportError:
        return None
    t0 = run.t_process + run.e2e["setup_s"]
    timed = [(event_ms(r["events"]), r["images"])
             for r in records("sampler.decode", t0, t0 + run.window_s)]
    timed = [(ms, n) for ms, n in timed if ms is not None]
    if not timed:
        return None
    return sum(ms for ms, _ in timed) / sum(n for _, n in timed)
