"""The batcher thread's host milliseconds to assemble and launch one batch,
over the window's batches (``ServiceStats.host_ms_per_batch`` times the
batch count, its difference over the window)."""


def read(run):
    s = run.service
    if not s.get("batches"):
        return None
    return s["host_ms"] / s["batches"]
