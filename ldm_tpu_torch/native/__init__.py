"""ctypes bindings for the port's native host-side pipeline (batcher.cpp).

The port's own copy of ``ldm_tpu/native`` (it imports nothing of the JAX
package); the surface and its contracts are the same:

* ``available()`` — True iff the .so built/loaded (g++ toolchain present and
  ``LDM_TPU_NO_NATIVE`` unset).
* ``gather_affine(images_u8, idx, div, mul, add)`` — fused gather + affine
  normalize, bitwise-equal to ``(images[idx].astype(f32)/div)*mul+add``.
* ``gather_labels(labels_i32, idx)`` — label gather.
* ``Prefetcher`` — a C++ worker thread assembling the NEXT batch while the
  caller waits on the device (ctypes releases the GIL for the whole call).
* ``SlotQueue`` — the serving batcher's slot queue, batch assembly and
  result scatter (serving/service.py).

Everything degrades gracefully: when the library is unavailable the callers
(data/loader.py, serving/service.py) keep their pure-Python path,
behavior-identical.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_lib = None
_lib_tried = False


def _load():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    if os.environ.get("LDM_TPU_NO_NATIVE") == "1":
        return None
    from ldm_tpu_torch.native.build import lib_path

    path = lib_path()
    if path is None:
        return None
    # AttributeError too: a stale .so lacking the newer symbols (mtime-based
    # rebuild fooled by clock skew / a copied tree) must degrade to the
    # pure-Python path, not crash available()'s callers.
    try:
        lib = ctypes.CDLL(path)
        _bind(lib)
    except (OSError, AttributeError):
        return None
    _lib = lib
    return _lib


def _bind(lib) -> None:
    i64, f32, i32, u8 = (
        ctypes.c_int64,
        ctypes.c_float,
        ctypes.c_int32,
        ctypes.c_uint8,
    )
    pf = ctypes.POINTER
    lib.ldm_gather_affine_u8.argtypes = [
        pf(u8), i64, pf(i64), i64, f32, f32, f32, pf(f32)
    ]
    lib.ldm_gather_affine_u8.restype = None
    lib.ldm_gather_i32.argtypes = [pf(i32), pf(i64), i64, pf(i32)]
    lib.ldm_gather_i32.restype = None
    lib.ldm_prefetcher_create.argtypes = [
        pf(u8), pf(i32), i64, i64, f32, f32, f32, ctypes.c_int
    ]
    lib.ldm_prefetcher_create.restype = ctypes.c_void_p
    lib.ldm_prefetcher_start_epoch.argtypes = [ctypes.c_void_p, pf(i64), i64]
    lib.ldm_prefetcher_start_epoch.restype = None
    lib.ldm_prefetcher_next.argtypes = [ctypes.c_void_p, pf(f32), pf(i32)]
    lib.ldm_prefetcher_next.restype = ctypes.c_int
    lib.ldm_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.ldm_prefetcher_destroy.restype = None
    lib.ldm_slotq_create.argtypes = [i64, i64]
    lib.ldm_slotq_create.restype = ctypes.c_void_p
    lib.ldm_slotq_submit.argtypes = [
        ctypes.c_void_p, i64, pf(u8), i32, pf(i32), i64
    ]
    lib.ldm_slotq_submit.restype = ctypes.c_int
    lib.ldm_slotq_collect.argtypes = [
        ctypes.c_void_p, i64, ctypes.c_double, ctypes.c_double,
        pf(i32), pf(i32), pf(i32), pf(i64), pf(i32),
    ]
    lib.ldm_slotq_collect.restype = i64
    lib.ldm_slotq_scatter.argtypes = [
        ctypes.c_void_p, pf(u8), i64, pf(i64), pf(i32), pf(i64)
    ]
    lib.ldm_slotq_scatter.restype = i64
    lib.ldm_slotq_cancel.argtypes = [ctypes.c_void_p, i64]
    lib.ldm_slotq_cancel.restype = None
    lib.ldm_slotq_drain.argtypes = [ctypes.c_void_p, pf(i64), i64]
    lib.ldm_slotq_drain.restype = i64
    lib.ldm_slotq_depth.argtypes = [ctypes.c_void_p]
    lib.ldm_slotq_depth.restype = i64
    lib.ldm_slotq_destroy.argtypes = [ctypes.c_void_p]
    lib.ldm_slotq_destroy.restype = None


def available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def _checked_idx(idx: np.ndarray, n: int) -> np.ndarray:
    """Canonicalize indices with numpy fancy-indexing semantics: negatives
    wrap, out-of-range raises — the C++ gather would OOB-read instead."""
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < -n or idx.max() >= n):
        raise IndexError(f"gather index out of range for axis of size {n}")
    return np.ascontiguousarray(np.where(idx < 0, idx + n, idx))


def gather_affine(
    images: np.ndarray, idx: np.ndarray, div: float, mul: float, add: float
) -> np.ndarray:
    """images: uint8 (N, ...) C-contiguous; idx: any int array (numpy
    semantics — negatives wrap, out-of-range raises IndexError)."""
    lib = _load()
    assert lib is not None
    assert images.dtype == np.uint8 and images.flags.c_contiguous
    idx = _checked_idx(idx, images.shape[0])
    item = int(np.prod(images.shape[1:], dtype=np.int64))
    out = np.empty((len(idx),) + images.shape[1:], np.float32)
    lib.ldm_gather_affine_u8(
        _ptr(images, ctypes.c_uint8), item, _ptr(idx, ctypes.c_int64),
        len(idx), div, mul, add, _ptr(out, ctypes.c_float),
    )
    return out


def gather_labels(labels: np.ndarray, idx: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    labels = np.ascontiguousarray(labels, dtype=np.int32)
    idx = _checked_idx(idx, labels.shape[0])
    out = np.empty(len(idx), np.int32)
    lib.ldm_gather_i32(
        _ptr(labels, ctypes.c_int32), _ptr(idx, ctypes.c_int64), len(idx),
        _ptr(out, ctypes.c_int32),
    )
    return out


class Prefetcher:
    """Threaded batch assembly over an in-memory uint8 dataset.

    Per epoch: ``start_epoch(order)`` with a flat index array (len a multiple
    of ``batch_size``), then ``next_batch()`` until it returns None.  Batches
    come out in order — identical content to the synchronous gather.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        div: float = 255.0,
        mul: float = 2.0,
        add: float = -1.0,
        capacity: int = 2,
    ):
        lib = _load()
        assert lib is not None
        assert images.dtype == np.uint8 and images.flags.c_contiguous
        # keep references: the C++ side reads these buffers from its thread
        self._images = images
        self._labels = np.ascontiguousarray(labels, dtype=np.int32)
        self._shape = images.shape[1:]
        self._batch = batch_size
        self._lib = lib
        self._h = lib.ldm_prefetcher_create(
            _ptr(images, ctypes.c_uint8),
            _ptr(self._labels, ctypes.c_int32),
            int(np.prod(self._shape, dtype=np.int64)), batch_size,
            div, mul, add, capacity,
        )

    def start_epoch(self, order: np.ndarray) -> None:
        order = _checked_idx(order, self._images.shape[0])
        n = (len(order) // self._batch) * self._batch
        self._lib.ldm_prefetcher_start_epoch(
            self._h, _ptr(order, ctypes.c_int64), n
        )

    def next_batch(self) -> Optional[dict]:
        img = np.empty((self._batch,) + self._shape, np.float32)
        lbl = np.empty(self._batch, np.int32)
        ok = self._lib.ldm_prefetcher_next(
            self._h, _ptr(img, ctypes.c_float), _ptr(lbl, ctypes.c_int32)
        )
        if not ok:
            return None
        return {"image": img, "label": lbl}

    def close(self) -> None:
        if self._h is not None:
            self._lib.ldm_prefetcher_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


class SlotQueue:
    """C++ slot queue + batch assembly + result scatter for the serving path
    (serving/service.py) — the per-SLOT host work (collect loop, assembly
    loop, fulfil scatter) runs outside the GIL in one ctypes call per batch
    instead of O(batch) Python operations.

    Contract mirrors the Python batcher exactly, except submission is
    all-or-nothing: a request whose slots would overflow ``queue_limit`` is
    rejected whole (the Python queue could enqueue a prefix then reject).
    The caller must keep each request's ``dst`` buffer alive until the
    request completes, fails, or is cancelled.
    """

    def __init__(self, item_bytes: int, queue_limit: int = 4096):
        lib = _load()
        assert lib is not None
        self._lib = lib
        self._item_bytes = int(item_bytes)
        self._h = lib.ldm_slotq_create(self._item_bytes, int(queue_limit))
        self._scratch = None  # idle-tick collect buffers, see collect()

    def submit(self, req_id: int, dst: np.ndarray, seed: int,
               class_ids: np.ndarray) -> bool:
        """Enqueue one request's ``len(class_ids)`` slots; False = rejected
        (queue full).  ``dst``: writable uint8 buffer of n*item_bytes."""
        assert dst.dtype == np.uint8 and dst.flags.c_contiguous
        assert dst.nbytes == len(class_ids) * self._item_bytes
        cls = np.ascontiguousarray(class_ids, np.int32)
        return bool(self._lib.ldm_slotq_submit(
            self._h, int(req_id), _ptr(dst, ctypes.c_uint8),
            np.int32(seed), _ptr(cls, ctypes.c_int32), len(cls),
        ))

    def collect(self, batch: int, first_wait_s: float, max_delay_s: float):
        """Block (GIL released) for up to ``first_wait_s`` for work, then
        fill up to ``batch`` slots within ``max_delay_s``.  Returns
        (count, seeds, idxs, classes, req_ids, slot_is) with the arrays
        zero-padded past count (the compiled sampler's pad slots), or
        ``(0, None, None, None, None, None)`` on timeout.

        Timeout ticks reuse ONE preallocated scratch set (the idle 50 ms
        loop would otherwise allocate five arrays per tick).  The retained
        set is NEVER exposed on a timeout (handing it out would alias arrays
        a caller might hold against the next successful collect's writes); only a
        collect that found work surrenders the arrays to the caller, and a
        fresh set is allocated for the next tick — the zero-init pad
        contract holds because timeout ticks never write the arrays."""
        sc = self._scratch
        if sc is None or len(sc[0]) != batch:
            sc = (np.zeros(batch, np.int32), np.zeros(batch, np.int32),
                  np.zeros(batch, np.int32), np.zeros(batch, np.int64),
                  np.zeros(batch, np.int32))
        seeds, idxs, classes, req_ids, slot_is = sc
        n = self._lib.ldm_slotq_collect(
            self._h, batch, float(first_wait_s), float(max_delay_s),
            _ptr(seeds, ctypes.c_int32), _ptr(idxs, ctypes.c_int32),
            _ptr(classes, ctypes.c_int32), _ptr(req_ids, ctypes.c_int64),
            _ptr(slot_is, ctypes.c_int32),
        )
        if not n:
            self._scratch = sc
            return 0, None, None, None, None, None
        self._scratch = None
        return int(n), seeds, idxs, classes, req_ids, slot_is

    def collect_more(self, into, offset: int, batch: int,
                     first_wait_s: float, max_delay_s: float) -> int:
        """Top up a partial batch in place: append up to ``batch - offset``
        further slots into the arrays a previous ``collect`` returned,
        starting at ``offset``.  Same C++ call as ``collect`` pointed at the
        tail of the arrays — used by the serving batcher to fill pad slots
        while its dispatch handoff is backpressured (waiting is free there:
        the device pipeline is already full).  Returns how many were added."""
        seeds, idxs, classes, req_ids, slot_is = into
        assert 0 <= offset < batch <= len(seeds)
        n = self._lib.ldm_slotq_collect(
            self._h, batch - offset, float(first_wait_s), float(max_delay_s),
            _ptr(seeds[offset:], ctypes.c_int32),
            _ptr(idxs[offset:], ctypes.c_int32),
            _ptr(classes[offset:], ctypes.c_int32),
            _ptr(req_ids[offset:], ctypes.c_int64),
            _ptr(slot_is[offset:], ctypes.c_int32),
        )
        return int(n)

    def scatter(self, images: np.ndarray, count: int, req_ids: np.ndarray,
                slot_is: np.ndarray) -> list:
        """Copy finished rows images[:count] into their requests' buffers;
        returns the req_ids that completed with this batch."""
        assert images.dtype == np.uint8 and images.flags.c_contiguous
        done = np.zeros(max(count, 1), np.int64)
        n = self._lib.ldm_slotq_scatter(
            self._h, _ptr(images, ctypes.c_uint8), int(count),
            _ptr(req_ids, ctypes.c_int64), _ptr(slot_is, ctypes.c_int32),
            _ptr(done, ctypes.c_int64),
        )
        return done[:n].tolist()

    def cancel(self, req_id: int) -> None:
        self._lib.ldm_slotq_cancel(self._h, int(req_id))

    def drain(self, cap: int = 1 << 20) -> list:
        """Failure path: forget everything; returns the affected req_ids."""
        out = np.zeros(cap, np.int64)
        n = self._lib.ldm_slotq_drain(self._h, _ptr(out, ctypes.c_int64), cap)
        return out[:n].tolist()

    def depth(self) -> int:
        return int(self._lib.ldm_slotq_depth(self._h))

    def close(self) -> None:
        if self._h is not None:
            self._lib.ldm_slotq_destroy(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass
