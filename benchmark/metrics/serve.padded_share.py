"""The service's padded slots over the slots of the batches it ran in the
window (``ServiceStats`` counters, their difference over the window)."""


def read(run):
    s = run.service
    if not s.get("batches"):
        return None
    return 100.0 * s["padded_slots"] / (s["batches"] * s["batch_size"])
