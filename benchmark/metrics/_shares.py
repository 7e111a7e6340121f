"""What the per-layer readers share: a share of the whole window's
products of the bf16 peak, a kernel's share of its roofline over the
traced slice, and the device's idle share of the slice.  Each returns None
where the run has nothing to read (no trace, no such kernel in it)."""

from __future__ import annotations

from benchmark.yardsticks import PEAK_BF16_FLOPS, adam_ema_bound_s, la_bound_s


def mfu(run):
    """Over the window less the profiler's own start and stop, in which the
    card ran nothing of the window's work."""
    seconds = run.window_s - (run.trace.overhead_s if run.trace is not None else 0.0)
    if not run.flops or seconds <= 0:
        return None
    return 100.0 * run.flops / seconds / PEAK_BF16_FLOPS


def attention_roofline(run, kernel: str, backward: bool):
    tr = run.trace
    sites = run.bwd_sites if backward else run.fwd_sites
    if tr is None or not sites:
        return None
    seconds = tr.seconds(kernel)
    if seconds <= 0:
        return None
    bound = tr.units * sum(la_bound_s(b, n, c, backward) for b, n, c in sites)
    return 100.0 * bound / seconds


def adam_ema_roofline(run):
    tr = run.trace
    if tr is None or not run.n_params:
        return None
    seconds = tr.seconds("fused_adam_ema")
    if seconds <= 0:
        return None
    return 100.0 * tr.units * adam_ema_bound_s(run.n_params) / seconds


def idle(run):
    tr = run.trace
    if tr is None or tr.busy_s <= 0 or tr.slice_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.slice_s)
