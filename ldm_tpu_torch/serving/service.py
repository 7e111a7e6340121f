"""Dynamic-batching generation service over the port's sampler (the twin of
``ldm_tpu/serving/service.py``).

* **One sampler, one batch size.**  Requests are coalesced into the slots
  of one fixed batch; short batches are padded (the padding slots ride
  along and are dropped on the host).  On a CUDA device the sampler is the
  replayed graph of one step (``diffusion/ddpm.py``), captured once for that
  batch size and kept for the service's life.
* **Batching is invisible to clients.**  A slot's x_T comes from a CPU
  generator seeded from (request seed, slot index) alone, never from its
  position in whatever batch it rode in: with a deterministic sampler (DDIM
  at eta 0, DPM-Solver++) a request's images are the same however the
  batcher packed it.  The ancestral sampler's per-step noise comes from a
  generator seeded from (``base_seed``, batch counter), so its images do
  depend on the batch they rode in.
* **Host work overlaps device work.**  The batcher thread assembles a batch,
  uploads its x_T and labels, launches the sampler's steps, packs the
  result to uint8 on the device and queues a copy of it into one of four
  pinned host buffers, then records a CUDA event; it never waits for the
  device.  A fulfil thread waits on that event alone and scatters the
  images into the requests (a wait on the stream would queue behind the
  next batch's steps).  The hand-off queue holds at most 3 batches, so at
  most 4 buffers are in use; a buffer goes back to the pool once scattered.
* **Replicas over local devices.**  With ``devices`` (a list of local
  devices, the JAX service's ``mesh``) a batch's slots are split into one
  contiguous block a device, each sampled by its own replica (its own model
  and graph, at ``batch_size / len(devices)``) from its own slots' x_T: a
  slot's images are those of a one-device service at the replicas' batch
  size.  They equal the one-device service's at ``batch_size`` where the
  model's kernels compute a row the same at either size (the CPU); on an
  H100 cuDNN takes another bf16 algorithm for one of the UNet's 3x3 convs
  at half the batch, and a few values differ (ROADMAP queue 3, fault 8).
  The ancestral sampler's per-step noise is drawn per replica (salted by
  its index).
* **Graph capture and threads.**  ``start(warmup=True)`` captures the
  sampler on the calling thread before the workers start: a CUDA call from
  another thread during a capture would break it.  With ``warmup=False``
  the first batch captures on the batcher thread, while nothing is in
  flight on the fulfil thread.
* **What it records.**  Each batch (``serve.batch``: its launch on the host,
  its time on the card between CUDA timing events, when it landed) and each
  completed request (``serve.request``: submitted, its batch launched and
  landed, resolved) goes to the recorder of ``utils/profiling.py``, marked
  ``profiled`` where torch's profiler ran meanwhile.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ldm_tpu_torch.training.state import step_generator
from ldm_tpu_torch.utils import profiling

# the pinned host buffers a CUDA service copies its batches into: the
# fulfil queue's bound, plus the batch being scattered
FULFIL_QUEUE = 3
PINNED_BUFFERS = FULFIL_QUEUE + 1


def _p50_p95(sorted_values: Sequence[float]) -> Tuple[float, float]:
    n = len(sorted_values)
    return sorted_values[n // 2], sorted_values[min(n - 1, int(n * 0.95))]


def _try_resolve(future: Future, exc: Optional[BaseException] = None,
                 result=None) -> bool:
    """First resolution wins; a racing second resolver is a no-op.

    Futures are resolved from three threads (the batcher's failure sweep,
    the fulfil thread and the submitting client through ``_fail_if_died``):
    a bare check-then-set races, and a loser's ``InvalidStateError`` inside
    the failure sweep would abort it midway, orphaning every remaining
    future.  Returns True iff this call resolved the future.
    """
    try:
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)
        return True
    except InvalidStateError:
        return False


# sample_fn: (classes int64 (B,), x_init float32 (B, H, W, C), generator) ->
# images in [-1, 1], (B, H, W, C), on the service's device; with
# ``per_slot_keys`` a 4th argument, the slots' CPU generators.  The service
# packs its output to uint8 on the device.
SampleFn = Callable[..., torch.Tensor]
# x_init_fn: (seeds int32 (B,), slot indices int32 (B,)) -> x_T float32 (B, H, W, C)
XInitFn = Callable[[np.ndarray, np.ndarray], "np.ndarray | torch.Tensor"]


def slot_generator(seed: int, idx: int) -> torch.Generator:
    """A slot's CPU generator: a 64-bit seed mixed from (request seed, slot
    index) by ``SeedSequence``, so that two pairs cannot collide."""
    words = np.random.SeedSequence([int(seed), int(idx)]).generate_state(1, np.uint64)
    return torch.Generator().manual_seed(int(words[0]))


def slot_x_init(seeds: np.ndarray, idxs: np.ndarray, image_shape) -> Tuple[torch.Tensor, list]:
    """A batch's x_T (B, H, W, C) float32 on the host, each slot's the first
    draw of its :func:`slot_generator`, and the generators after it."""
    gens = [slot_generator(s, i) for s, i in zip(seeds.tolist(), idxs.tolist())]
    return torch.stack([torch.randn(tuple(image_shape), generator=g) for g in gens]), gens


def pack_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> uint8 on x's device, ``floor(clip((x + 1) / 2, 0, 1) * 255)``:
    bit for bit ``data.transforms.reverse_transform`` (the divisor and the
    factor are exact in fp32, and the cast truncates as numpy's does)."""
    return ((x.to(torch.float32) + 1.0) / 2.0).clamp_(0.0, 1.0).mul_(255.0).to(torch.uint8)


@dataclasses.dataclass
class ServiceStats:
    """Monotonic counters and the latency distribution, a snapshot by
    ``stats()``; ``host_ms_per_batch`` is the batcher thread's mean time to
    assemble and launch one batch (on a busy card its launches also wait
    for room in the stream's queue; the wait for a free pinned buffer is
    not in it).  ``queue_p50_s`` / ``queue_p95_s``: a completed request's
    wait from submission to the launch of the batch that completed it (the
    last 1,024); ``device_ms_per_batch``: the card's mean time a batch, from
    its x_T upload to its copy out (0 on the CPU).  They are the figures of
    the ``serve.request`` and ``serve.batch`` records, kept per service:
    the recorder is process-wide, so its rings mix every service of the
    process."""

    requests: int = 0
    images: int = 0
    batches: int = 0
    padded_slots: int = 0
    rejected: int = 0
    uptime_s: float = 0.0
    images_per_s: float = 0.0
    queue_depth: int = 0
    latency_p50_s: float = 0.0
    latency_p95_s: float = 0.0
    host_ms_per_batch: float = 0.0
    queue_p50_s: float = 0.0
    queue_p95_s: float = 0.0
    device_ms_per_batch: float = 0.0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Request:
    __slots__ = ("class_ids", "seed", "images", "remaining", "t_submit",
                 "profiled", "future", "rejected")

    def __init__(self, class_ids: np.ndarray, seed: int, image_shape):
        self.class_ids = class_ids
        # an int32 seed space, as the slot queue carries it
        self.seed = int(seed) & 0x7FFFFFFF
        self.rejected = False
        self.images = np.empty((len(class_ids),) + tuple(image_shape), np.uint8)
        self.remaining = len(class_ids)
        self.t_submit = time.perf_counter_ns()
        self.profiled = profiling.profiler_on()
        self.future: Future = Future()


class _Landing:
    """A batch's uint8 images on their way to the host: a pinned buffer and
    the events after the copies into it (CUDA, one a replica), or the images
    themselves; the host times of its launch and landing (``perf_counter_ns``)
    and, on a card, the timing events before each replica's x_T upload."""

    def __init__(self, images: np.ndarray, events=(), release=None, starts=()):
        self._images, self._events, self._release = images, list(events), release
        self._starts = list(starts)
        self.t_launch = self.t_landed = 0
        self.profiled = False

    def wait(self) -> np.ndarray:
        for event in self._events:
            event.synchronize()
        self.t_landed = time.perf_counter_ns()
        return self._images

    def device_ms(self) -> Optional[float]:
        """The longest replica's time on the card, from its x_T upload to its
        copy out (after :meth:`wait`); None without a card."""
        if not self._starts:
            return None
        return max(a.elapsed_time(b) for a, b in zip(self._starts, self._events))

    def release(self) -> None:
        """The buffer may be written again: its rows are scattered."""
        if self._release is not None:
            self._release()
            self._release = None


class GenerationService:
    """Coalesce concurrent generation requests into one fixed-batch sampler.

    Args:
      sample_fn: ``(classes, x_init, generator) -> images`` in [-1, 1].
      image_shape: (H, W, C) of one x_T.
      num_classes: valid class ids are [0, num_classes).
      batch_size: the one batch size (slots a batch).
      max_delay_s: how long the batcher waits to fill a batch before
        sampling it padded; the latency / throughput knob.
      base_seed: seeds the per-batch generator (the ancestral noise) with
        the batch counter, and is the base of the auto-seed stream of
        requests without a seed.
      out_shape: (H, W, C) of ``sample_fn``'s output where it differs from
        ``image_shape``.
      per_slot_keys: pass the slots' CPU generators (the ones their x_T
        came from) to ``sample_fn`` as a 4th argument, for samplers that
        draw noise inside the loop and must stay batching-invariant.
      use_native: the host C++ slot queue (``ldm_tpu_torch/native``) where
        it builds; the pure-Python batcher otherwise, behaviour-identical.
      device: where the sampler runs; ``sample_fn`` returns tensors there.
      devices: replicas over these local devices (``sample_fn`` then a list
        of as many, the i-th sampling on ``devices[i]``); ``batch_size`` must
        divide by their count.  The contract is per device batch: a service
        over n replicas at batch B gives each slot the image that a
        one-device service at batch B/n gives it (each replica samples its
        B/n slots as such a service would).  It need not be the image of a
        one-device service at B: a GPU's convolution libraries choose their
        algorithm by shape, and cuDNN's bf16 3x3 convolution sums in another
        order at another batch size (on an H100 2,376 of 30,720 values of a
        DDIM-50 request move by up to 10 of 255 between B=32 and B=64).  On
        the CPU it is that image too, as the JAX service's is on a TPU.
      x_init_fn: ``(seeds, slot indices) -> x_T``; by default each slot's
        x_T is drawn from :func:`slot_generator`.  Randomness is an input:
        a test hands in another package's draws here.
    """

    def __init__(
        self,
        sample_fn: SampleFn,
        *,
        image_shape: Tuple[int, int, int],
        num_classes: int,
        batch_size: int = 64,
        max_delay_s: float = 0.02,
        base_seed: int = 0,
        out_shape: Optional[Tuple[int, int, int]] = None,
        queue_limit: int = 4096,
        per_slot_keys: bool = False,
        use_native: bool = True,
        device="cpu",
        x_init_fn: Optional[XInitFn] = None,
        devices: Optional[Sequence] = None,
    ):
        if devices is None:
            self.sample_fns, self.devices = [sample_fn], [torch.device(device)]
        else:
            self.sample_fns, self.devices = list(sample_fn), [torch.device(d) for d in devices]
            if len(self.sample_fns) != len(self.devices) or not self.devices:
                raise ValueError(f"{len(self.sample_fns)} samplers for "
                                 f"{len(self.devices)} devices")
            if int(batch_size) % len(self.devices):
                raise ValueError(f"batch_size={batch_size} must divide by the number of "
                                 f"devices ({len(self.devices)})")
            device = self.devices[0]
        self.image_shape = tuple(image_shape)
        self.out_shape = tuple(out_shape) if out_shape is not None else self.image_shape
        self.num_classes = int(num_classes)
        self.batch_size = int(batch_size)
        self.max_delay_s = float(max_delay_s)
        self.base_seed = int(base_seed)
        self.per_slot_keys = per_slot_keys
        self.device = self.devices[0]
        self.x_init_fn = x_init_fn
        if self.batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        # the batch function; a test may replace it (to block or to fail)
        self._batched = self._sample_batch
        self._pinned: List[torch.Tensor] = []
        self._free: "queue.Queue[int]" = queue.Queue()
        if self.device.type == "cuda":
            shape = (self.batch_size,) + self.out_shape
            self._pinned = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                            for _ in range(PINNED_BUFFERS)]
            for k in range(PINNED_BUFFERS):
                self._free.put(k)
        # native slot queue: the per-slot host path (collect loop, batch
        # assembly, fulfil scatter) in C++ outside the GIL, one call a batch
        self._slotq = None
        if use_native:
            from ldm_tpu_torch import native

            if native.available():
                self._slotq = native.SlotQueue(int(np.prod(self.out_shape)), queue_limit)
                self._inflight: dict = {}  # req_id -> _Request
                self._next_req_id = 0
        self._queue: "queue.Queue[Tuple[_Request, int]]" = queue.Queue(queue_limit)
        # batcher -> fulfil-thread hand-off; its bound caps the batches in
        # flight (the batcher blocks when the fulfil side is 3 batches behind)
        self._fulfil_q: "queue.Queue" = queue.Queue(maxsize=FULFIL_QUEUE)
        # RLock: the enqueue runs under the lock (drain-exit serialisation)
        # and a failure injected from inside it re-enters for the sweep
        self._lock = threading.RLock()
        self._latencies: collections.deque = collections.deque(maxlen=1024)
        self._queue_waits: collections.deque = collections.deque(maxlen=1024)
        self._stats = ServiceStats()
        self._host_seconds = 0.0  # the batcher's host time in _batched, summed
        self._device_ms = 0.0     # the card's time of the landed batches, summed
        self._device_batches = 0  # ... and their count
        self._t_start = time.monotonic()
        self._auto_seed = 0
        self._batch_counter = 0
        self._stop = threading.Event()
        # _died: a worker hit an unrecoverable error (a graceful stop() sets
        # _stop too); _drained: the batcher's exit decision is taken (under
        # _lock, serialised against submit's enqueue): nobody collects after
        self._died = threading.Event()
        self._drained = False
        self._failure: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        self._fulfiller: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    @property
    def sample_fn(self) -> SampleFn:
        """The sampler of the one device (the first replica's)."""
        return self.sample_fns[0]

    @sample_fn.setter
    def sample_fn(self, fn: SampleFn) -> None:
        self.sample_fns[0] = fn

    def start(self, warmup: bool = True) -> "GenerationService":
        """Start the batching and fulfil workers; ``warmup``: sample one
        padded batch first, on this thread (on a card: the capture)."""
        if self._worker is not None:
            raise RuntimeError("service already started")
        if warmup:
            landing = self._dispatch([])
            landing.wait()
            landing.release()
        self._stop.clear()
        self._died.clear()
        self._drained = False
        self._worker = threading.Thread(
            target=self._run, name="ldm-torch-serving-batcher", daemon=True)
        self._fulfiller = threading.Thread(
            target=self._run_fulfil, name="ldm-torch-serving-fulfil", daemon=True)
        self._fulfiller.start()
        self._worker.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Drain the queue, fulfil everything in flight, stop the workers."""
        if self._worker is None:
            return
        self._stop.set()
        self._worker.join(timeout)
        if self._fulfiller is not None:
            self._fulfiller.join(timeout)
        self._worker = self._fulfiller = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # --------------------------------------------------------------- clients
    def submit(self, class_id, n: int = 1, seed: Optional[int] = None) -> Future:
        """Request ``n`` images; returns a Future of uint8 (n, H, W, C).

        ``class_id`` is one class for all n images, or a sequence of n ids.
        ``seed=None`` draws from the service's auto-seed stream (still
        deterministic for a fixed submission order).
        """
        if self._worker is None or self._stop.is_set():
            if self._failure is not None:
                raise RuntimeError(f"service failed: {self._failure!r}") from self._failure
            raise RuntimeError("service is not running")
        if n <= 0:
            raise ValueError(f"n must be positive, got {n}")
        if isinstance(class_id, (list, tuple, np.ndarray)):
            ids = np.asarray(class_id, np.int32)
            if ids.shape != (n,):
                raise ValueError(f"class_id sequence must have length n={n}")
        else:
            ids = np.full((n,), int(class_id), np.int32)
        if ids.min() < 0 or ids.max() >= self.num_classes:
            raise ValueError(f"class ids must be in [0, {self.num_classes}), got {ids.tolist()}")
        with self._lock:
            if seed is None:
                seed = self.base_seed + self._auto_seed
                self._auto_seed += 1
            self._stats.requests += 1
        req = _Request(ids, int(seed), self.out_shape)
        if self._slotq is not None:
            # registration and enqueue under _lock: serialised against the
            # batcher's drain-exit decision (_run_native), so either the
            # batcher sees these slots before it decides the queue is
            # drained, or _drained is set when _fail_if_died checks it
            with self._lock:
                req_id = self._next_req_id
                self._next_req_id += 1
                self._inflight[req_id] = req
                # one GIL-released call enqueues all n slots, all or nothing
                ok = self._slotq.submit(req_id, req.images, req.seed, ids)
            if not ok:
                with self._lock:
                    del self._inflight[req_id]
                    self._stats.rejected += 1
                _try_resolve(req.future, RuntimeError("service queue is full, request rejected"))
            else:
                self._fail_if_died(req, req_id)
            return req.future
        try:
            with self._lock:  # the same enqueue / drain-exit serialisation
                for i in range(n):
                    self._queue.put_nowait((req, i))
        except queue.Full:
            req.rejected = True  # slots already enqueued must not set_result
            with self._lock:
                self._stats.rejected += 1
            _try_resolve(req.future, RuntimeError("service queue is full, request rejected"))
        else:
            self._fail_if_died(req)
        return req.future

    def _fail_if_died(self, req: "_Request", req_id: Optional[int] = None):
        """Close the submit / failure race: if a worker failure swept the
        queues between submit()'s liveness check and the enqueue above, this
        request was registered after the sweep and nobody would resolve its
        future; fail it here instead of hanging the client.

        A graceful stop() racing the enqueue is another case: the batcher's
        drain loop keeps collecting until the queue is empty, so a request
        it will still see must not be failed.  The enqueue is serialised
        against the drain-exit decision by _lock, so ``_drained`` tells the
        two apart: not drained, the batcher will fulfil it; drained, its
        slots landed after the exit and are orphaned."""
        if not self._stop.is_set():
            return
        if not self._died.is_set():
            with self._lock:
                if not self._drained:
                    return  # graceful stop, the batcher still draining
        with self._lock:
            if req_id is not None and self._inflight.pop(req_id, None) is None:
                return  # the pipeline already fulfilled (or swept) it
        if req_id is None and req.future.done():
            return  # Python path: already fulfilled (or swept)
        req.rejected = True
        if req_id is not None and self._slotq is not None:
            try:
                self._slotq.cancel(req_id)
            except Exception:
                pass  # best effort: the queue may already be gone
        exc = self._failure
        _try_resolve(req.future, RuntimeError(
            f"service died during submission: {exc!r}" if exc
            else "service stopped during submission"))

    def stats(self) -> ServiceStats:
        with self._lock:
            s = dataclasses.replace(self._stats)
            lat = sorted(self._latencies)
            waits = sorted(self._queue_waits)
            host = self._host_seconds
            device, timed = self._device_ms, self._device_batches
        s.uptime_s = time.monotonic() - self._t_start
        s.images_per_s = s.images / s.uptime_s if s.uptime_s > 0 else 0.0
        s.queue_depth = self._slotq.depth() if self._slotq is not None else self._queue.qsize()
        if lat:
            s.latency_p50_s, s.latency_p95_s = _p50_p95(lat)
        if waits:
            s.queue_p50_s, s.queue_p95_s = _p50_p95(waits)
        if s.batches:
            s.host_ms_per_batch = host / s.batches * 1e3
        if timed:
            s.device_ms_per_batch = device / timed
        return s

    # ------------------------------------------------------------ one batch
    def _sample_batch(self, seeds: np.ndarray, idxs: np.ndarray, classes: np.ndarray,
                      counter: int) -> _Landing:
        """x_T of every slot, the sampler, the uint8 packing on the device
        and the copy towards the host; returns without waiting for the
        device (on a card).  A CUDA batch first takes a free pinned buffer:
        that wait is the backpressure of the 4 batches in flight and is not
        counted in ``host_ms_per_batch``."""
        cuda = self.device.type == "cuda"
        k = self._free.get() if cuda else None
        try:
            profiled = profiling.profiler_on()
            t0 = time.perf_counter_ns()
            landing = self._launch(seeds, idxs, classes, counter, k)
        except BaseException:
            if k is not None:
                self._free.put(k)
            raise
        t1 = time.perf_counter_ns()
        landing.t_launch, landing.profiled = t0, profiled
        with self._lock:
            self._host_seconds += (t1 - t0) * 1e-9
        return landing

    def _launch(self, seeds, idxs, classes, counter: int, k: Optional[int]) -> _Landing:
        if self.x_init_fn is None:
            x, gens = slot_x_init(seeds, idxs, self.image_shape)
        else:
            x = torch.from_numpy(np.array(self.x_init_fn(seeds, idxs), np.float32))
            gens = ([slot_generator(s, i) for s, i in zip(seeds.tolist(), idxs.tolist())]
                    if self.per_slot_keys else None)
        labels = torch.from_numpy(classes.astype(np.int64))
        n = len(self.devices)
        m = self.batch_size // n  # each replica's block of slots
        outs, starts, events = [], [], []
        with torch.inference_mode():  # thread-local: this thread's own
            for i, (fn, dev) in enumerate(zip(self.sample_fns, self.devices)):
                rows = slice(i * m, (i + 1) * m)
                xi, li = x[rows], labels[rows]
                if k is not None:  # from pinned memory: a pageable upload would wait
                    with torch.cuda.device(dev):
                        starts.append(torch.cuda.Event(enable_timing=True))
                        starts[-1].record()
                    xi = xi.pin_memory().to(dev, non_blocking=True)
                    li = li.pin_memory().to(dev, non_blocking=True)
                # the ancestral sampler's per-step noise: one stream a batch
                # (a replica)
                gen = step_generator(self.base_seed, counter, dev, *((i,) if n > 1 else ()))
                args = (li, xi, gen) + ((gens[rows],) if self.per_slot_keys else ())
                images = pack_uint8(fn(*args))
                if k is None:
                    outs.append(images.numpy())
                    continue
                with torch.cuda.device(dev):
                    self._pinned[k][rows].copy_(images, non_blocking=True)
                    event = torch.cuda.Event(enable_timing=True)
                    event.record()
                events.append(event)
        if k is None:
            return _Landing(np.ascontiguousarray(np.concatenate(outs)))
        return _Landing(self._pinned[k].numpy(), events, lambda: self._free.put(k), starts)

    # ---------------------------------------------------------------- worker
    def _next_counter(self, pads: int) -> int:
        with self._lock:
            counter = self._batch_counter
            self._batch_counter += 1
            self._stats.batches += 1
            self._stats.padded_slots += pads
        return counter

    def _dispatch(self, slots: Sequence[Tuple[_Request, int]]) -> _Landing:
        """Assemble one padded batch and sample it."""
        b = self.batch_size
        seeds = np.zeros((b,), np.int32)
        idxs = np.zeros((b,), np.int32)
        classes = np.zeros((b,), np.int32)
        for j, (req, i) in enumerate(slots):
            seeds[j] = req.seed
            idxs[j] = i
            classes[j] = req.class_ids[i]
        counter = self._next_counter(b - len(slots))
        return self._batched(seeds, idxs, classes, counter)

    def _fulfil(self, landing: _Landing, slots: Sequence[Tuple[_Request, int]]):
        """Wait for a finished batch on the host and resolve completed requests."""
        try:
            images = landing.wait()
            done = []
            for j, (req, i) in enumerate(slots):
                req.images[i] = images[j]
                req.remaining -= 1
                if req.remaining == 0 and not req.rejected:
                    done.append(req)
        finally:
            landing.release()
        self._landed(landing, len(slots), done)

    def _landed(self, landing: _Landing, count: int, done: Sequence[_Request]) -> None:
        """Count, record and resolve a batch of ``count`` slots that is on
        the host, and ``done``, the requests it completed: batches land in
        launch order on one stream, so a request's wait in the queue ends
        at the launch of the batch that carried its last slot."""
        device_ms = landing.device_ms()
        now = time.perf_counter_ns()
        with self._lock:
            self._stats.images += count
            if device_ms is not None:
                self._device_ms += device_ms
                self._device_batches += 1
            for req in done:
                self._latencies.append((now - req.t_submit) * 1e-9)
                self._queue_waits.append((landing.t_launch - req.t_submit) * 1e-9)
        profiled = landing.profiled or profiling.profiler_on()
        profiling.record("serve.batch", landing.t_launch, profiled,
                         t_landed=landing.t_landed, device_ms=device_ms)
        for req in done:
            profiling.record("serve.request", req.t_submit, profiled or req.profiled,
                             t_launch=landing.t_launch, t_landed=landing.t_landed,
                             t_resolved=time.perf_counter_ns())
            _try_resolve(req.future, result=req.images)

    def _collect(self) -> list:
        """Block for the first slot, then fill the batch until the deadline."""
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        slots = [first]
        deadline = time.monotonic() + self.max_delay_s
        while len(slots) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                try:  # deadline passed: take only what is already queued
                    slots.append(self._queue.get_nowait())
                    continue
                except queue.Empty:
                    break
            try:
                slots.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return slots

    def _fail(self, exc: BaseException, slots: Sequence[Tuple[_Request, int]]):
        """A worker hit an unrecoverable error: fail every affected future
        (the batch in hand and everything still queued) instead of leaving
        clients blocked on futures nobody will resolve."""
        # _failure and _died before _stop: a thread that sees _stop set also
        # sees that this was a death, not a clean stop()
        self._failure = exc
        self._died.set()
        self._stop.set()
        failed = {}
        for req, _ in slots:
            failed[id(req)] = req
        while True:  # drain the pending slots so their requests fail too
            try:
                req, _ = self._queue.get_nowait()
            except queue.Empty:
                break
            failed[id(req)] = req
        for req in failed.values():
            req.rejected = True  # a racing _fulfil must not set_result
            _try_resolve(req.future, RuntimeError(f"serving worker failed: {exc!r}"))

    # ----------------------------------------------- native (C++ slot queue)
    def _run_native(self):
        # _run's structure, but collect and assembly are ONE GIL-released
        # C++ call: its arrays are the batch function's inputs directly
        b = self.batch_size
        while True:
            count, seeds, idxs, classes, req_ids, slot_is = \
                self._slotq.collect(b, 0.05, self.max_delay_s)
            if count:
                # backpressure top-up: while the hand-off queue is full the
                # put() below would block anyway (the device is saturated),
                # so a padded batch now starts no earlier than a full one;
                # spend that time filling the pad slots instead
                while 0 < count < b and self._fulfil_q.full() and not self._stop.is_set():
                    count += self._slotq.collect_more(
                        (seeds, idxs, classes, req_ids, slot_is), count, b,
                        self.max_delay_s, self.max_delay_s)
                counter = self._next_counter(b - count)
                try:
                    out = self._batched(seeds, idxs, classes, counter)
                except Exception as e:  # a sampler or device error
                    self._fail_native(e, req_ids[:count])
                    self._fulfil_q.put(None)
                    return
                self._fulfil_q.put((out, count, req_ids, slot_is))
            elif self._stop.is_set():
                # the exit decision under _lock (serialised against
                # submit's enqueue): either a racing submit's slots are
                # visible here (keep draining) or _drained is set before its
                # _fail_if_died check runs.  The sentinel goes in outside
                # the lock: a full _fulfil_q would deadlock against the
                # fulfil thread's need for _lock
                with self._lock:
                    drained = self._slotq.depth() == 0
                    if drained:
                        self._drained = True
                if drained:
                    self._fulfil_q.put(None)  # sentinel: drain and exit
                    return

    def _fulfil_native(self, landing: _Landing, count, req_ids, slot_is):
        # wait for the batch, then one C++ scatter copies each row into its
        # request's buffer; Python work is per completed request only
        try:
            done = self._slotq.scatter(landing.wait(), count, req_ids, slot_is)
        finally:
            landing.release()
        with self._lock:
            reqs = [self._inflight.pop(r) for r in done if r in self._inflight]
        self._landed(landing, count, [req for req in reqs if not req.rejected])

    def _fail_native(self, exc: BaseException, batch_req_ids):
        # _fail's order: the death flags before _stop
        self._failure = exc
        self._died.set()
        self._stop.set()
        ids = {int(r) for r in batch_req_ids}
        ids.update(self._slotq.drain())  # queued and in-flight registry
        with self._lock:
            reqs = [self._inflight.pop(r) for r in ids if r in self._inflight]
        for req in reqs:
            req.rejected = True
            _try_resolve(req.future, RuntimeError(f"serving worker failed: {exc!r}"))

    def _run(self):
        # batcher thread: collect and launch only; finished batches go to
        # the fulfil thread, so batch k's launches overlap batch k-1's
        # transfer and resolution
        if self._slotq is not None:
            return self._run_native()
        while True:
            slots = self._collect()
            if slots:
                # backpressure top-up, the native path's policy
                while (len(slots) < self.batch_size and self._fulfil_q.full()
                       and not self._stop.is_set()):
                    try:
                        slots.append(self._queue.get(timeout=self.max_delay_s))
                    except queue.Empty:
                        pass
                try:
                    out = self._dispatch(slots)
                except Exception as e:  # a sampler or device error
                    self._fail(e, slots)
                    self._fulfil_q.put(None)
                    return
                self._fulfil_q.put((out, slots))
            elif self._stop.is_set():
                # the same lock-serialised exit decision as _run_native
                with self._lock:
                    drained = self._queue.empty()
                    if drained:
                        self._drained = True
                if drained:
                    self._fulfil_q.put(None)  # sentinel: drain and exit
                    return

    def _run_fulfil(self):
        native = self._slotq is not None
        while True:
            item = self._fulfil_q.get()
            if item is None:
                return
            try:
                if native:
                    self._fulfil_native(*item)
                else:
                    self._fulfil(*item)
            except Exception as e:  # a transfer or scatter error
                if native:
                    self._fail_native(e, item[2][:item[1]])
                else:
                    self._fail(e, item[1])
                # keep consuming, so the batcher never blocks on a full
                # hand-off queue; later batches fail fast above
