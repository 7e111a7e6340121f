"""One step captured into a CUDA graph and replayed: the port's stand-in for
``jax.lax.scan`` (the samplers' loop) and ``jax.jit`` (the train step).

The JAX package hands XLA one program per sampler and one per train step,
and the host launches each once.  PyTorch launches every kernel from Python,
some hundreds a sampler step and over a thousand a train step, and at the
flagship's sizes the card waits for the host most of the time.  A
:class:`StepGraph` records the kernels of one step once and launches them all
with one call a step.

What a captured step may do: read and write tensors that exist before the
capture (its static buffers, the model's and the optimizer's state) and
allocate inside (from the graph's own pool).  What it may not: wait for the
device, read a Python number that changes from step to step (it would be
frozen at its value at capture), or draw from a ``torch.Generator`` made per
call.  Whatever of that a step needs is done eagerly around the replay.

The ops count their launches in Python (``utils/launches.py``), which a
replay does not run: the graph records what its capture counted and adds it
at every replay, so the counts stay what an eager loop would give.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Optional

import torch

from ldm_tpu_torch.utils import launches

WARMUP_STEPS = 3


def use_graphs(device, graph: Optional[bool], mesh=None) -> bool:
    """Whether a loop on ``device`` runs as a replayed graph: by default on a
    CUDA device and nowhere else; ``graph=True`` on another device raises (a
    caller who asks for the graph by name gets it or an error).  A step over
    a ``mesh`` whose collectives a graph cannot hold (gloo's stage CUDA
    tensors through the host) runs eagerly by design: by default, and
    ``graph=True`` raises."""
    device = torch.device(device)
    capturable = device.type == "cuda" and (mesh is None or mesh.captures_collectives)
    if graph is None:
        return capturable
    if graph and not capturable:
        why = (f"a CUDA device, got {device}" if device.type != "cuda"
               else f"collectives it can capture, got the {mesh.backend} backend")
        raise ValueError(f"a CUDA graph needs {why}")
    return bool(graph)


@contextlib.contextmanager
def side_stream(device):
    """Run the body on a stream of its own, ordered after the current
    stream's work and before what follows: where warm-up runs before a
    capture."""
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        yield
    current.wait_stream(side)


class StepGraph:
    """``fn`` captured once and replayed.

    ``fn()`` runs one step on tensors that outlive it and returns the
    tensors (any nesting of tuples; or None) that a caller reads after a
    replay; they are overwritten by the next one.  ``warmup`` calls of it run
    first on a side stream (lazy initialisation, the kernels' build, the
    allocator's first blocks must not fall into the capture), each preceded
    by ``reset()`` where one is given (a step that advances a counter must
    not run off its table while warming up); ``before_capture()`` runs last
    before the capture.  A capture that fails raises: nothing falls back to
    an eager loop.
    """

    def __init__(self, fn: Callable[[], Any], device, warmup: int = WARMUP_STEPS,
                 reset: Optional[Callable[[], None]] = None,
                 before_capture: Optional[Callable[[], None]] = None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
        t0 = time.perf_counter()
        with torch.cuda.device(device):
            with side_stream(device):
                for _ in range(warmup):
                    if reset is not None:
                        reset()
                    fn()
            if reset is not None:
                reset()
            if before_capture is not None:
                before_capture()
            before = launches.snapshot()
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = fn()
            # what one capture counted: added again at every replay
            self.launches = launches.since(before)
            launches.restore(before)  # a capture runs nothing
        self.capture_seconds = time.perf_counter() - t0  # host clock: warm-up and capture
        self.replays = 0

    def replay(self) -> Any:
        """Launch the step; returns ``fn``'s outputs (static: clone what must
        outlive the next replay)."""
        self.graph.replay()
        launches.add(self.launches)
        self.replays += 1
        return self.outputs

    def device_ms(self, replays: int = 10, before: Optional[Callable[[], None]] = None) -> float:
        """The device's time for one replay, in ms: CUDA events just around
        each of ``replays`` replays (``before()`` first, outside the events:
        a sampler's step counter is set back there), read after one wait at
        the end; the mean.  The replays are real steps and are counted."""
        pairs = []
        for _ in range(replays):
            if before is not None:
                before()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            self.replay()
            end.record()
            pairs.append((start, end))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / replays


def _batch_of(inputs: tuple, scan) -> tuple:
    """The step's inputs with its batch (the first two) as given, or
    ``scan``'s next, gathered on the device."""
    return inputs if scan is None else (*scan.next_batch(), *inputs[2:])


class GraphedStep:
    """A trainer's optimisation step, eager or as a replayed CUDA graph: the
    capture policy both trainers share.

    ``device_step(*inputs)`` is the step on device tensors alone (the batch
    first, as (x, y), then whatever else it reads) and returns a dict of
    device tensors; it moves ``state`` (a ``TrainState``).  A call gives it
    ``inputs`` and a ``scan``: None (the inputs are the batch) or the
    device-resident epoch whose ``next_batch()`` takes the place of the
    first two inputs inside the step.

    With ``enabled``, the first batch shape met is the graphs' shape: the
    first ``WARMUP_STEPS`` steps at it run eagerly on a side stream (the
    capture's warm-up, real steps), then every step at it is a replay of the
    graph captured for its ``scan`` on first use (one graph a batch source);
    a batch of another shape runs the eager step.  ``counts`` counts both
    kinds.  ``before_capture()`` runs just before each capture and again just
    after it (a model drops cached copies of its weights there)."""

    def __init__(self, device_step: Callable[..., dict], state, device, enabled: bool,
                 before_capture: Optional[Callable[[], None]] = None):
        self.device_step = device_step
        self.state = state
        self.device = torch.device(device)
        self.enabled = bool(enabled)  # a caller may switch it between steps
        self.before_capture = before_capture
        self.captured: dict = {}  # CapturedStep by batch source (None or an EpochScan)
        self.shape: Optional[tuple] = None
        self.warm_steps = 0
        self.counts = {"graphed": 0, "eager": 0}

    def __call__(self, inputs: tuple, scan=None) -> dict:
        if self.enabled:
            if self.shape is None:
                self.shape = tuple(inputs[0].shape)
            if tuple(inputs[0].shape) == self.shape:
                if self.warm_steps >= WARMUP_STEPS:
                    graph = self.captured.get(scan)
                    if graph is None:
                        graph = self.captured[scan] = CapturedStep(self, inputs, scan)
                    self.counts["graphed"] += 1
                    return graph.step(inputs)
                self.warm_steps += 1
                self.counts["eager"] += 1
                with side_stream(self.device):  # where warm-up for a capture runs
                    out = self.device_step(*_batch_of(inputs, scan))
                self.state.count_step()
                return out
        self.counts["eager"] += 1
        out = self.device_step(*_batch_of(inputs, scan))
        self.state.count_step()
        return out

    def clear(self) -> None:
        """Drop the captured steps (they hold the addresses of the state they
        were captured on) and warm up again before the next capture."""
        self.captured.clear()
        self.warm_steps = 0


class CapturedStep:
    """A :class:`GraphedStep`'s step as one CUDA graph, with fixed input
    buffers (clones of the first inputs) that each replay reads; with a
    ``scan`` the graph gathers its batch from the device-resident epoch (the
    scan's row counter advances at every replay) and the batch buffers go
    unused.

    Inside the capture the grads are set to None once, so the backward
    allocates them from the graph's pool and every replay writes them in
    place; the weights, the optimizer's state and any buffers the step moves
    are written in place, so re-initializing them in place keeps the graph
    good."""

    def __init__(self, owner: GraphedStep, inputs: tuple, scan=None):
        self.owner = owner
        self.scan = scan
        # contiguous: a () or broadcast input fills a buffer of the batch's shape
        self.buffers = [v.clone(memory_format=torch.contiguous_format) for v in inputs]
        self.graph = StepGraph(lambda: owner.device_step(*_batch_of(tuple(self.buffers), scan)),
                               owner.device, warmup=0, before_capture=owner.before_capture)
        if owner.before_capture is not None:
            owner.before_capture()  # what the capture made belongs to the graph's pool
        self.grads = [p.grad for p in owner.state.params()]

    def step(self, inputs: tuple) -> dict:
        """One replay on these inputs (without a scan, this batch too)."""
        first = 0 if self.scan is None else 2
        for buf, val in zip(self.buffers[first:], inputs[first:]):
            buf.copy_(val)
        out = self.graph.replay()
        state = self.owner.state
        state.count_replayed_step()
        params = state.params()
        if params[0].grad is not self.grads[0]:
            # an eager step or another graph put other tensors in .grad:
            # show this step's gradients again
            for p, g in zip(params, self.grads):
                p.grad = g
        # clones: the next replay overwrites the graph's outputs
        return {k: v.clone() for k, v in out.items()}

    def device_ms(self, replays: int = 10) -> float:
        """The device's time for one replay, in ms: ``replays`` real steps
        on the inputs the buffers hold (a scan's graph on its epoch's first
        row: the counter is set back before each replay), counted."""
        ms = self.graph.device_ms(replays, before=None if self.scan is None else
                                  self.scan.row.zero_)
        for _ in range(replays):
            self.owner.state.count_replayed_step()
        self.owner.counts["graphed"] += replays
        return ms
