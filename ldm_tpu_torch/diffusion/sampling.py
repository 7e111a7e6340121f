"""The sampler loop that both generative processes run: the DDPM family's
ancestral, DDIM and DPM-Solver++ samplers (``diffusion/ddpm.py``) and the
rectified flow's Euler and Heun solvers (``diffusion/flow.py``).

A sampler is a :class:`Method`: a loop over a table of timesteps (and of
whatever per-step coefficients it needs) that lies on the device.  One step
reads its row of the tables and the running carry (x_t, and what a multistep
method keeps) from device tensors alone, so the same step function runs
eagerly (a Python loop, the only loop on the CPU) and as a CUDA graph
captured once and replayed once a step (:class:`SamplerGraph`), which is
what the JAX package's ``lax.scan`` is to its samplers.  A process says how
one step updates the carry (:meth:`SamplingProcess._update`); everything
else (x_T, the CFG labels, the loop, the graph and its cache) lives here.

CFG runs the conditional and unconditional passes as ONE forward on a 2B
batch.  Randomness is an input: ``x_init`` (x_T) and ``noise`` (the
per-step draws) can be given; what is not given is drawn from the
``torch.Generator`` the caller passes.  A step's noise is drawn eagerly into
a fixed buffer just before the step (a generator made per request cannot be
captured).

Both loops go through :func:`_run_steps`, which records each call as one
``sampler.run`` (``utils/profiling.py``: the host's time in the steps'
launches and in their noise draws) and, while torch's profiler runs, marks
each step's ``sampler.draw`` and ``sampler.launch`` on its host timeline.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ldm_tpu_torch.utils import profiling
from ldm_tpu_torch.utils.graphs import StepGraph, use_graphs

# the model: (x, t, y) -> its prediction (eps, or a flow's velocity).  `y` is
# int (B,); the unconditional pass uses the model's null label
# (UNet.null_label), which embeds to zero.
ModelFn = Callable[..., torch.Tensor]
# per-step noise: t -> the (B, H, W, C) N(0, I) draw for the step from t
NoiseFn = Callable[[int], torch.Tensor]
# one CFG prediction at (x, the (B,) timestep input): what an update calls
PredictFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# how many captured sampler steps a process keeps (each holds the
# activations of one or two UNet forwards at its batch size)
MAX_SAMPLER_GRAPHS = 4


def _run_steps(ts: np.ndarray, draw: Optional[Callable[[int], None]],
               launch: Callable[[int], None]) -> None:
    """A sampler's loop: for step ``i`` from timestep ``t``, ``draw(t)`` (the
    step's noise; None where the method draws none), then ``launch(i)``.
    Records the call as one ``sampler.run``: the host's nanoseconds in the
    launches and in the draws, summed over the steps."""
    t_enter = time.perf_counter_ns()
    draw_ns = launch_ns = 0
    profiled = False
    for i, t in enumerate(ts.tolist()):
        on = profiling.profiler_on()
        profiled |= on
        if draw is not None:
            a = time.perf_counter_ns()
            with profiling.host_range("sampler.draw", on):
                draw(t)
            draw_ns += time.perf_counter_ns() - a
        a = time.perf_counter_ns()
        with profiling.host_range("sampler.launch", on):
            launch(i)
        launch_ns += time.perf_counter_ns() - a
    profiling.record("sampler.run", t_enter, profiled, steps=len(ts), launch_ns=launch_ns,
                     draw_ns=draw_ns)


def _row(table: torch.Tensor, i: Union[int, torch.Tensor]) -> torch.Tensor:
    """Entry ``i`` of a 1-d table as a 0-d tensor; ``i`` a Python int (the
    eager loop) or a 0-d int64 tensor on the table's device (a captured
    step: indexing by it directly would read it on the host)."""
    if isinstance(i, int):
        return table[i]
    return table.index_select(0, i.reshape(1)).squeeze(0)


@dataclasses.dataclass(frozen=True)
class Method:
    """One sampler as the loop runs it: its name, the timesteps on the host
    (descending; what an injected ``noise`` is called with), the per-step
    tables on the device (the first is the model's timestep input), how many
    tensors its carry has, whether a step takes a noise draw, what tells two
    loops of the method apart (the graph cache's key), DDIM's eta, a flow
    solver's step dt, and the update of a method that brings its own (the
    signature of :meth:`SamplingProcess._update`; None: the process's)."""

    name: str
    ts: np.ndarray
    tables: Tuple[torch.Tensor, ...]
    n_carry: int
    draws: bool
    key: tuple
    eta: float = 0.0
    dt: float = 0.0
    update: Optional[Callable[..., Tuple[torch.Tensor, ...]]] = None


class SamplingProcess:
    """What the samplers of a process share: the CFG prediction, the loop,
    the graphs and the methods' tables, each made once.  A subclass sets
    ``n_steps`` and ``device``, calls ``super().__init__()`` and implements
    :meth:`_update`."""

    n_steps: int
    device: torch.device

    def __init__(self):
        self._graphs: dict = {}  # captured sampler steps, by SamplerGraph key
        # the samplers' methods by (name, arguments), their tables uploaded
        # once: a copy from pageable host memory waits for the stream, so a
        # caller that samples again and again (a service's batcher) would
        # wait for the device at every call
        self._methods: dict = {}
        # host seconds the last sample* call spent on warm-up and capture
        self.last_capture_seconds = 0.0

    def _update(self, method: Method, rows: Sequence[torch.Tensor],
                carry: Sequence[torch.Tensor], z: Optional[torch.Tensor],
                predict: PredictFn) -> Tuple[torch.Tensor, ...]:
        """One step of ``method``: its rows of the tables (the first already
        expanded to the (B,) timestep input), the carry, the step's noise
        draw (None if the method draws none) and ``predict``; returns the
        new carry."""
        raise NotImplementedError

    def _cfg_eps(self, model: ModelFn, xt: torch.Tensor, t_vec: torch.Tensor,
                 y_in: torch.Tensor, cfg_scale: float, use_cfg: bool) -> torch.Tensor:
        """One prediction of the model (eps, or a velocity), with CFG fused
        as a single 2B-batch forward: ``uncond + cfg * (cond - uncond)``."""
        if use_cfg:
            x_in = torch.cat([xt, xt], dim=0)
            t_in = torch.cat([t_vec, t_vec], dim=0)
            cond, uncond = model(x_in, t_in, y_in).chunk(2, dim=0)
            return uncond + cfg_scale * (cond.to(torch.float32) - uncond.to(torch.float32))
        return model(xt, t_vec, y_in)

    def _step(self, model: ModelFn, method: Method, tables: Sequence[torch.Tensor],
              carry: Sequence[torch.Tensor], i: Union[int, torch.Tensor],
              z: Optional[torch.Tensor], y_in: torch.Tensor, cfg_scale: float,
              use_cfg: bool) -> Tuple[torch.Tensor, ...]:
        """Step ``i`` of a sampler: its row of ``tables``, then the process's
        update.  Everything it reads is a device tensor, but ``i`` in the
        eager loop."""
        b = carry[0].shape[0]
        rows = [_row(tab, i) for tab in tables]
        rows[0] = rows[0].expand(b)

        def predict(x: torch.Tensor, t_vec: torch.Tensor) -> torch.Tensor:
            return self._cfg_eps(model, x, t_vec, y_in, cfg_scale, use_cfg)

        update = method.update or self._update
        return update(method, rows, carry, z, predict)

    def _loop(self, model: ModelFn, method: Method, classes: torch.Tensor,
              image_shape: Tuple[int, int, int], cfg_scale: float,
              null_label: Optional[int], x_init: Optional[torch.Tensor],
              noise: Optional[NoiseFn], generator: Optional[torch.Generator],
              graph: Optional[bool]) -> torch.Tensor:
        """x_T, the CFG labels, then ``method``'s steps: eagerly or as a
        replayed graph."""
        b = classes.shape[0]
        device = classes.device
        shape = (b,) + tuple(image_shape)
        needs_noise = method.draws and noise is None
        if (x_init is None or needs_noise) and generator is None:
            raise ValueError("pass a generator, or both x_init and noise")
        xt = (torch.randn(shape, generator=generator, device=device) if x_init is None
              else x_init.to(device, torch.float32))

        use_cfg = cfg_scale is not None and cfg_scale > 0
        if use_cfg:
            if null_label is None:
                raise ValueError("null_label is required when cfg_scale > 0")
            y_in = torch.cat([classes, torch.full_like(classes, null_label)])
        else:
            y_in = classes

        self.last_capture_seconds = 0.0
        if graph is None and noise is not None:
            graph = False  # injected per-step noise: the eager loop unless asked by name
        # a model over a mesh (the pipeline's apply) says whether a graph can
        # hold its collectives
        if use_graphs(device, graph, getattr(model, "mesh", None)):
            return self._graph_for(model, method, xt, y_in, cfg_scale, use_cfg).run(
                xt, y_in, noise, generator)

        carry = (xt,) + tuple(torch.zeros_like(xt) for _ in range(method.n_carry - 1))
        z = None

        def draw(t: int) -> None:
            nonlocal z
            z = (torch.randn(shape, generator=generator, device=device) if noise is None
                 else noise(t).to(device))

        def launch(i: int) -> None:
            nonlocal carry
            carry = self._step(model, method, method.tables, carry, i, z, y_in,
                               cfg_scale, use_cfg)

        _run_steps(method.ts, draw if method.draws else None, launch)
        return carry[0]

    def _graph_for(self, model, method: Method, xt, y_in, cfg_scale, use_cfg
                   ) -> "SamplerGraph":
        """The captured step for this model, method, batch shape and guidance:
        kept from an earlier call unless the model's kernel weights have
        changed since, else captured now."""
        key = (id(model), method.key, tuple(xt.shape), float(cfg_scale or 0.0), use_cfg)
        g = self._graphs.get(key)
        if g is None or g.stale():
            g = SamplerGraph(self, model, method, xt, y_in, cfg_scale, use_cfg)
            self._graphs.pop(key, None)
            self._graphs[key] = g
            while len(self._graphs) > MAX_SAMPLER_GRAPHS:
                self._graphs.pop(next(iter(self._graphs)))
            self.last_capture_seconds = g.graph.capture_seconds
        return g

    def sampler_graphs(self) -> list:
        """The captured sampler steps this process keeps, oldest first."""
        return list(self._graphs.values())

    def _table(self, values, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(values), dtype=dtype, device=self.device)

    def _method(self, key: tuple, make: Callable[[], Method]) -> Method:
        """The method for ``key`` (a sampler's name and arguments), made by
        ``make`` at the first call and kept."""
        method = self._methods.get(key)
        if method is None:
            method = self._methods[key] = make()
        return method


class SamplerGraph:
    """One sampler step as a CUDA graph, with the buffers it reads and
    writes: the carry, the step's noise, the CFG labels, the method's tables
    and the step counter that picks their row.  Captured for one (model,
    method, batch shape, cfg_scale, use_cfg): the guidance is baked in, as it
    is a static argument of the JAX package's jitted sampler."""

    def __init__(self, process: SamplingProcess, model, method: Method,
                 xt: torch.Tensor, y_in: torch.Tensor, cfg_scale, use_cfg: bool):
        self.method = method
        self.model = model  # kept alive: the cache's key is its id
        self.carry = [torch.zeros_like(xt) for _ in range(method.n_carry)]
        self.z = torch.zeros_like(xt) if method.draws else None
        self.y = y_in.clone()
        self.i = torch.zeros((), dtype=torch.int64, device=xt.device)
        self.tables = [t.clone() for t in method.tables]

        def step():
            new = process._step(model, method, self.tables, self.carry, self.i, self.z,
                                self.y, cfg_scale, use_cfg)
            for buf, val in zip(self.carry, new):
                buf.copy_(val)
            self.i += 1

        self.graph = StepGraph(step, xt.device, reset=self.i.zero_)
        # the model's kernel-layout weight copies that the capture read: held
        # here so their memory is not reused, and compared before a reuse
        state = getattr(model, "kernel_weights_state", None)
        self._weights_state = state
        self._weights_key, self._held = state() if state is not None else (None, None)

    def stale(self) -> bool:
        """The model's attention weights changed since the capture: the
        copies the graph reads are old."""
        return self._weights_state is not None and self._weights_state()[0] != self._weights_key

    @torch.inference_mode()  # the buffers were made under it, by the sampler
    def device_ms(self, replays: int = 10) -> float:
        """The device's time for one replayed step, in ms, on the buffers as
        the last run left them (the step counter set back before each)."""
        return self.graph.device_ms(replays, before=self.i.zero_)

    def run(self, xt: torch.Tensor, y_in: torch.Tensor, noise: Optional[NoiseFn],
            generator: Optional[torch.Generator]) -> torch.Tensor:
        self.carry[0].copy_(xt)
        for extra in self.carry[1:]:
            extra.zero_()
        self.y.copy_(y_in)
        self.i.zero_()

        def draw(t: int) -> None:  # this step's draw, eagerly, into the fixed buffer
            if noise is None:
                self.z.normal_(generator=generator)
            else:
                self.z.copy_(noise(t))

        _run_steps(self.method.ts, draw if self.z is not None else None,
                   lambda i: self.graph.replay())
        return self.carry[0].clone()
