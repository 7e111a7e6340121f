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

The kernel wrappers count their launches in Python, which a replay does not
run: the graph records how many launches of each wrapper its capture made and
adds them at every replay, so the counts stay what an eager loop would give.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Optional

import torch

from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.ops import resnet_block as rb

# every kernel wrapper that counts its launches in a ``launches`` attribute
COUNTED = (la.linear_attention_block, la.linear_attention_block_bwd, rb.resnet_block)
WARMUP_STEPS = 3


def use_graphs(device, graph: Optional[bool]) -> bool:
    """Whether a loop on ``device`` runs as a replayed graph: by default on a
    CUDA device and nowhere else; ``graph=True`` on another device raises (a
    caller who asks for the graph by name gets it or an error)."""
    device = torch.device(device)
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device, got {device}")
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
            before = [f.launches for f in COUNTED]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = fn()
            # the launches one capture made: added again at every replay
            self.launches = [f.launches - n for f, n in zip(COUNTED, before)]
            for f, n in zip(COUNTED, before):
                f.launches = n  # a capture runs nothing
        self.capture_seconds = time.perf_counter() - t0  # host clock: warm-up and capture
        self.replays = 0

    def replay(self) -> Any:
        """Launch the step; returns ``fn``'s outputs (static: clone what must
        outlive the next replay)."""
        self.graph.replay()
        for f, n in zip(COUNTED, self.launches):
            f.launches += n
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
