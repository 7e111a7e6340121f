"""The traced slice of a run (``--trace 1``) and what is read from it.

``torch.profiler`` records the host and the card over one short slice of
the window, which opens and closes on a device sync.  From its events, in
memory (nothing is written to disk):

* the slice's wall time, from the host annotation around it, less the time
  the card sat idle while the profiler flushed its own buffers;
* every device operation (kernels, copies, fills) clipped to the slice; the
  busy time is the union of their intervals, so operations that overlap are
  counted once and the gaps between them are idle;
* each kernel's time by name, summed;
* the longest idle gaps, each named by the innermost host operation that
  was running at its middle.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import torch

SLICE = "benchmark.slice"
BUFFER = "Activity Buffer Request"  # the profiler flushing its own buffers


@dataclasses.dataclass
class Trace:
    slice_s: float
    busy_s: float
    units: int                                # steps (or batches) inside the slice
    kernels: List[Tuple[str, float]]          # (name, seconds) of every device op
    gaps: List[Tuple[str, float]]             # (host activity, seconds), longest first
    overhead_s: float = 0.0                   # the profiler's own start and stop

    def seconds(self, *names: str) -> float:
        """Device seconds of the operations whose name holds any of ``names``."""
        return sum(s for n, s in self.kernels if any(k in n for k in names))

    def top_ops(self, k: int = 10) -> List[List]:
        by: dict = {}
        for n, s in self.kernels:
            by[n] = by.get(n, 0.0) + s
        return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


class Slice:
    """Start and stop the profiler around a slice of a run; ``start`` and
    ``stop`` may be called from inside the program's loop (a callback), on
    the thread that started the profiler.  ``sync``: open and close on a
    device sync (a loop of steps); without, the slice cuts through whatever
    runs (a service's batches).  ``overhead_s`` is the host time the
    profiler's start and stop took, which no work of the window ran in;
    :meth:`reduce` reads the events after the window."""

    def __init__(self, device, sync: bool = True):
        self.device = device
        self.sync = sync
        self.prof = None
        self.events = None
        self.units = 0
        self.overhead_s = 0.0
        self.started = 0.0
        self._mark = None

    @property
    def open(self) -> bool:
        return self.prof is not None

    def _sync(self) -> None:
        if self.sync and torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self) -> None:
        """Start and stop the profiler once in set-up: the card's tracing
        library initialises here, not inside the window."""
        self.start()
        self.stop()
        self.events, self.overhead_s = None, 0.0

    def start(self, mark: bool = True) -> None:
        """Start the profiler; ``mark``: the slice begins here too (else at
        :meth:`mark`)."""
        from torch.profiler import ProfilerActivity, profile

        t = time.perf_counter()
        self._sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        if mark:
            self.mark()
        self.overhead_s += time.perf_counter() - t

    def mark(self) -> None:
        """Begin the slice (the profiler already records)."""
        from torch.profiler import record_function

        self._mark = record_function(SLICE)
        self._mark.__enter__()
        self.started = time.perf_counter()

    def cut(self) -> None:
        """End the slice here; the profiler keeps recording until
        :meth:`stop` (what runs between is not read)."""
        if self._mark is not None:
            self._mark.__exit__(None, None, None)
            self._mark = None

    def stop(self) -> None:
        self._sync()
        t = time.perf_counter()
        self.cut()
        self.prof.__exit__(None, None, None)
        self.events = self.prof.profiler.kineto_results.events()
        self.prof = None
        self.overhead_s += time.perf_counter() - t

    def reduce(self) -> Optional["Trace"]:
        """The slice's :class:`Trace`, None if it never closed."""
        if self.events is None:
            return None
        tr = reduce(self.events, self.units)
        tr.overhead_s = self.overhead_s
        return tr


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events, units: int, n_gaps: int = 10) -> Trace:
    """The :class:`Trace` of a slice from the profiler's events."""
    cpu_type = torch.autograd.DeviceType.CPU
    marks = [e for e in events if e.name() == SLICE and e.device_type() == cpu_type]
    t0 = marks[0].start_ns()
    t1 = t0 + marks[0].duration_ns()
    dev, host = [], []
    for e in events:
        a = e.start_ns()
        b = a + e.duration_ns()
        if e.name() == SLICE:  # the annotation, on the host and on the device's timeline
            continue
        if e.device_type() == cpu_type:
            host.append((a, b, e.name()))
            continue
        a, b = max(a, t0), min(b, t1)
        if b > a:
            dev.append((a, b, e.name()))
    busy = _union([(a, b) for a, b, _ in dev])
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    # the profiler's own stalls (its activity buffers) are no part of the run
    stalls = sum(max(0, min(b, hb) - max(a, ha)) for ha, hb, n in host if n == BUFFER
                 for a, b in idle)
    gaps = []
    for length, a, b in sorted(((b - a, a, b) for a, b in idle), reverse=True):
        mid = (a + b) // 2
        under = [(hb - ha, n) for ha, hb, n in host if ha <= mid <= hb]
        name = min(under)[1] if under else "no host operation"
        if name != BUFFER:
            gaps.append((name, length * 1e-9))
        if len(gaps) == n_gaps:
            break
    return Trace(slice_s=(t1 - t0 - stalls) * 1e-9,
                 busy_s=sum(b - a for a, b in busy) * 1e-9,
                 units=units,
                 kernels=[(n, (b - a) * 1e-9) for a, b, n in dev],
                 gaps=gaps)
