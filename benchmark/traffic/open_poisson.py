"""Open-loop Poisson arrivals: independent callers that send on their own
schedule whether or not earlier requests are done.

Poisson arrivals at ``rate_rps``, each request's image count uniform over
``min_images``..``max_images``: the gaps and the sizes are stratified (the
distributions' quantiles) and put in an order fixed by the cell's
``pattern_seed``, so every run offers the same work at the same moments
and the tail measures the system, not the luck of a draw.  From
``--seed``: each request's class, uniform over the classes, and its seed
(below 2**31, as the service keeps it); each slot's x_T from (request
seed, slot index).  ``drive`` sends the
schedule, timing every request from the moment it was due until its images
are back, and reports how late the sender ran.

Parameters: ``rate_rps``, ``min_images``, ``max_images``, ``pattern_seed``
(and whatever the entry reads).
"""

from __future__ import annotations

import threading
import time
from typing import List

import numpy as np

from benchmark.weights import stream_seed

ARRIVALS, X_T = 31, 32


class Request:
    __slots__ = ("due", "cls", "n", "seed", "due_at", "sent", "done", "images", "error")

    def __init__(self, due: float, cls: int, n: int, seed: int):
        self.due, self.cls, self.n, self.seed = due, cls, n, seed
        self.due_at = self.sent = self.done = None  # host clock
        self.images = self.error = None


class Traffic:
    def __init__(self, params: dict, seed: int, device, num_classes: int):
        self.params = params
        self.seed = int(seed)
        self.num_classes = int(num_classes)

    def schedule(self, seconds: float, rate: float = None) -> List[Request]:
        """The requests due in [0, seconds), in order: ``rate * seconds`` of
        them, their gaps the exponential's quantiles at (i + 1/2) / n and
        their sizes spread evenly over the range, both in the order that
        the cell's ``pattern_seed`` shuffles them; the seed draws the
        classes and the request seeds."""
        rate = float(self.params["rate_rps"] if rate is None else rate)
        order = np.random.default_rng(int(self.params["pattern_seed"]))
        lo, hi = int(self.params.get("min_images", 1)), int(self.params["max_images"])
        n = int(round(rate * seconds))
        q = (np.arange(n) + 0.5) / n
        due = np.cumsum(order.permutation(-np.log1p(-q) / rate))
        sizes = order.permutation(lo + np.arange(n) * (hi - lo + 1) // n)
        rng = np.random.default_rng(stream_seed(self.seed, ARRIVALS))
        classes = rng.integers(self.num_classes, size=n)
        seeds = rng.integers(2**31 - 1, size=n)
        return [Request(float(t), int(c), int(k), int(s))
                for t, c, k, s in zip(due, classes, sizes, seeds) if t < seconds]

    def x_init(self, shape):
        """The service's ``x_init_fn``: each slot's x_T from (seed, slot)."""
        def fn(seeds, idxs):
            return np.stack([np.random.default_rng([int(s) & 0xFFFFFFFF, int(i), X_T])
                             .standard_normal(shape, dtype=np.float32)
                             for s, i in zip(seeds, idxs)])
        return fn


def drive(submit, requests: List[Request], t0: float, wait_s: float, tick=None) -> dict:
    """Send each request at ``t0`` + its due time through ``submit(cls, n,
    seed)`` (which returns a future), then wait for all, at most ``wait_s``
    past the last due time.  Fills each request's ``due_at``, ``sent``,
    ``done``, ``images`` or ``error``; returns the sender's lateness.
    ``tick(now)``, if given, runs on this thread before each send; where it
    returns a number of seconds the sender held still, the rest of the
    schedule moves back by as much (a pause leaves no backlog)."""
    late = []
    left = threading.Semaphore(0)

    def landed(req):
        def cb(fut):
            req.done = time.perf_counter()
            exc = fut.exception()
            if exc is None:
                req.images = fut.result()
            else:
                req.error = repr(exc)
            left.release()
        return cb

    for req in requests:
        wait = t0 + req.due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        if tick is not None:
            t0 += tick(time.perf_counter()) or 0.0
            wait = t0 + req.due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
        req.due_at = t0 + req.due
        req.sent = time.perf_counter()
        late.append(req.sent - req.due_at)
        try:
            submit(req.cls, req.n, req.seed).add_done_callback(landed(req))
        except RuntimeError as e:
            req.done, req.error = time.perf_counter(), repr(e)
            left.release()
    deadline = t0 + (requests[-1].due if requests else 0.0) + wait_s
    for _ in requests:
        if not left.acquire(timeout=max(0.0, deadline - time.perf_counter())):
            break
    return {"late_max_s": max(late, default=0.0),
            "late_mean_s": float(np.mean(late)) if late else 0.0}


def latencies(requests: List[Request], gave_up: float) -> List[float]:
    """Each request's seconds from due to done; one that failed or never
    came back counts until ``gave_up``."""
    return [(r.done if r.images is not None else gave_up) - r.due_at for r in requests]
