"""Tracing of the port (the twin of ``ldm_tpu/utils/profiling.py::trace``,
over ``torch.profiler`` where the JAX package uses ``jax.profiler``).

* :func:`trace` records the host's operators always and the card's kernels,
  copies and graph launches when a card is present, and writes one Chrome
  trace (``chrome://tracing``, Perfetto, TensorBoard's profile plugin) under
  the directory it is given.  ``Throughput``, the JAX module's other half,
  is in ``utils/logging.py``.
* The recorder keeps what the serving and sampler layers did, one record an
  event, in memory: process-wide (the service's threads and the sampler
  write to it without being handed anything) and bounded (one ring of
  :data:`RING` records a name).  Times are ``time.perf_counter_ns()``, the
  clock ``time.perf_counter`` reads in seconds.  Each record holds
  ``t_ns``, the moment it is windowed by, and ``profiled``: whether
  torch's profiler ran at some point while it was made (its timings then
  carry the profiler's cost).  On by default; :func:`set_enabled` turns
  records and ranges off.

  ============== =============================================================
  record         fields (``t_ns`` first)
  ============== =============================================================
  serve.request  ``t_ns`` submitted; ``t_launch`` the launch start of the
                 batch that completed it; ``t_landed`` that batch on the host;
                 ``t_resolved`` its future resolved
  serve.batch    ``t_ns`` launch start (a pinned buffer in hand);
                 ``t_landed`` on the host; ``device_ms`` the card's time from
                 the x_T upload to the copy out (the longest replica's; None
                 on the CPU)
  sampler.run    ``t_ns`` entered; ``steps``; ``launch_ns`` the host time of
                 the steps' launches (a graph's replay, or the eager step);
                 ``draw_ns`` of the steps' noise draws
  sampler.decode ``t_ns`` entered; ``images``; ``host_ns`` the host time of
                 the latent sampler's decode; ``events`` the CUDA timing
                 events before and after it (empty on the CPU), read by
                 :func:`event_ms` once the card has passed them
  ============== =============================================================

* Host-only ranges (:func:`host_range`): while the profiler runs, the
  sampler marks each step's ``sampler.draw`` and ``sampler.launch``, and
  the latent sampler its ``sampler.decode``, on its timeline as ``cpu_op`` events, which the profiler keeps on the host (a
  ``record_function`` annotation is copied onto the card's timeline too,
  where it reads as device work).  A profiler records the ranges of the
  thread that started it: the caller's sampling loop, not a service's
  batcher thread.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import Iterator, List, Optional

import torch

# records kept a name: a 51 s window of the serving benchmark makes about
# 1,200 requests and 250 batches, one of the latent sampler about 53 runs
RING = 1 << 15


class Recorder:
    """Rings of records by name; :attr:`enabled` is the one check a site
    makes."""

    def __init__(self, maxlen: int = RING):
        self.enabled = True
        self.maxlen = maxlen
        self._rings: dict = {}
        self._lock = threading.Lock()

    def add(self, name: str, t_ns: int, profiled: bool, **fields) -> None:
        if not self.enabled:
            return
        rec = dict(t_ns=t_ns, profiled=profiled, **fields)
        with self._lock:
            ring = self._rings.get(name)
            if ring is None:
                ring = self._rings[name] = collections.deque(maxlen=self.maxlen)
            ring.append(rec)

    def records(self, name: str, since_s: Optional[float] = None,
                until_s: Optional[float] = None, profiled: bool = False) -> List[dict]:
        """``name``'s records whose ``t_ns`` lies in [since_s, until_s)
        (``time.perf_counter`` seconds; open where None), oldest first;
        ``profiled``: keep those made while the profiler ran too."""
        lo = -float("inf") if since_s is None else since_s * 1e9
        hi = float("inf") if until_s is None else until_s * 1e9
        with self._lock:
            ring = list(self._rings.get(name, ()))
        return [r for r in ring if lo <= r["t_ns"] < hi and (profiled or not r["profiled"])]


RECORDER = Recorder()
record = RECORDER.add
records = RECORDER.records


def event_ms(events) -> Optional[float]:
    """The card's ms between a record's (start, end) CUDA timing events;
    None without events or before the card has passed the end."""
    if len(events) != 2 or not events[1].query():
        return None
    return events[0].elapsed_time(events[1])


def set_enabled(on: bool) -> None:
    """Records and ranges on (the default) or off."""
    RECORDER.enabled = bool(on)


# the profiler's process-wide flag (``_is_profiler_enabled``, set while a
# profiler started on any thread runs) and this thread's own check
_PROFILER = torch.autograd.profiler
_THIS_THREAD = torch.autograd._profiler_enabled


def profiler_on() -> bool:
    """Whether the recorder is on and torch's profiler runs, started on this
    thread or on another: a record made now is marked ``profiled``, and a
    range asked for now is made."""
    return RECORDER.enabled and (_PROFILER._is_profiler_enabled or _THIS_THREAD())


class _Range:
    __slots__ = ("_rf",)

    def __init__(self, name: str):
        self._rf = torch._C._profiler._RecordFunctionFast(name)

    def __enter__(self):
        self._rf.__enter__()

    def __exit__(self, *exc):
        try:
            self._rf.__exit__(None, None, None)
        except RuntimeError:
            pass  # no profiler recorded the start (another thread's, or started since)


_NO_RANGE = contextlib.nullcontext()


def host_range(name: str, on: bool):
    """A ``cpu_op`` range ``name`` on the profiler's host timeline around a
    block where ``on`` (:func:`profiler_on`, asked before the block), else
    nothing."""
    return _Range(name) if on else _NO_RANGE


def device_busy_s(prof) -> float:
    """Seconds in which the card ran something over a finished
    ``torch.profiler.profile``: the union of its device operations'
    intervals (kernels, copies, fills), so that operations which overlap
    count once and the gaps between them do not count.  Annotations the
    profiler copies onto the card's timeline are not operations."""
    cpu = torch.autograd.DeviceType.CPU
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() != cpu and not e.is_user_annotation())
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy * 1e-9


@contextlib.contextmanager
def trace(logdir: Optional[str]) -> Iterator[None]:
    """Profile the block and write its Chrome trace under ``logdir`` as
    ``trace_<pid>_<ns>.json`` (no-op if None or empty)."""
    if not logdir:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
