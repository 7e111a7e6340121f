"""The port's host C++ batcher (``ldm_tpu_torch/native``): each test of
``tests/test_native.py`` on the port's own library and loader, and the
fused gather held bit for bit against the JAX package's library.

Contract: the fused gather and normalise is bitwise equal to the numpy
expression it replaces, the prefetch ring yields the same batch stream as
the synchronous loader, and everything degrades to pure numpy when the
library is unavailable.
"""

import numpy as np
import pytest

from ldm_tpu_torch import native
from ldm_tpu_torch.data.datasets import Dataset
from ldm_tpu_torch.data.loader import DataLoader
from ldm_tpu_torch.data.transforms import scale_to_minus_one_one, scale_to_zero_one

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib unavailable (no g++?)"
)


def _dataset(n=50, h=8, c=3, seed=0):
    rng = np.random.default_rng(seed)
    return Dataset(
        images=rng.integers(0, 256, (n, h, h, c), dtype=np.uint8),
        labels=rng.integers(0, 10, (n,)).astype(np.int32),
        classes=list(range(10)),
        name="t",
    )


def test_gather_affine_bitwise_matches_numpy():
    ds = _dataset()
    idx = np.array([3, 0, 49, 7, 7], np.int64)
    for tf, aff in [
        (scale_to_minus_one_one, (255.0, 2.0, -1.0)),
        (scale_to_zero_one, (255.0, 1.0, 0.0)),
    ]:
        got = native.gather_affine(ds.images, idx, *aff)
        want = tf(ds.images[idx])
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)  # bitwise, not allclose


def test_gather_affine_bitwise_matches_the_jax_package_library():
    """The port's copy of batcher.cpp against the JAX package's build of its
    original, on the same arrays (both libraries build with g++)."""
    from ldm_tpu import native as jax_native

    if not jax_native.available():
        pytest.skip("the JAX package's native library is unavailable")
    ds = _dataset(n=64, h=16, seed=3)
    idx = np.random.default_rng(5).integers(-64, 64, 40)
    for aff in [(255.0, 2.0, -1.0), (255.0, 1.0, 0.0), (127.5, 1.0, -1.0)]:
        got = native.gather_affine(ds.images, idx, *aff)
        want = jax_native.gather_affine(ds.images, idx, *aff)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(native.gather_labels(ds.labels, idx),
                                  jax_native.gather_labels(ds.labels, idx))


def test_gather_labels_matches_numpy():
    ds = _dataset()
    idx = np.array([5, 5, 1, 0], np.int64)
    np.testing.assert_array_equal(
        native.gather_labels(ds.labels, idx), ds.labels[idx]
    )


def test_prefetcher_yields_ordered_identical_batches():
    ds = _dataset(n=64)
    pf = native.Prefetcher(ds.images, ds.labels, batch_size=16, capacity=3)
    try:
        for epoch_seed in (1, 2):  # two epochs through the SAME ring
            order = np.random.default_rng(epoch_seed).permutation(64)
            pf.start_epoch(order)
            got = []
            while (b := pf.next_batch()) is not None:
                got.append(b)
            assert len(got) == 4
            for i, b in enumerate(got):
                idx = order[i * 16 : (i + 1) * 16]
                np.testing.assert_array_equal(
                    b["image"], scale_to_minus_one_one(ds.images[idx])
                )
                np.testing.assert_array_equal(b["label"], ds.labels[idx])
    finally:
        pf.close()


def test_loader_native_and_numpy_paths_identical():
    """DataLoader(prefetch=2) == DataLoader(prefetch=0) == pure-numpy
    fallback, batch for batch — including the non-drop_last tail batch the
    ring can't serve."""
    ds = _dataset(n=53)

    def stream(prefetch, force_numpy=False):
        dl = DataLoader(ds, 16, shuffle=True, seed=9, drop_last=False,
                        prefetch=prefetch)
        if force_numpy:
            dl._native_affine = lambda: None  # simulate missing library
        return list(dl)

    a, b, c = stream(2), stream(0), stream(0, force_numpy=True)
    assert len(a) == len(b) == len(c) == 4
    assert a[-1]["image"].shape[0] == 53 - 3 * 16  # tail batch preserved
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x["image"], y["image"])
        np.testing.assert_array_equal(x["image"], z["image"])
        np.testing.assert_array_equal(x["label"], y["label"])
        np.testing.assert_array_equal(x["label"], z["label"])


def test_prefetch_loader_rebuilds_ring_on_dataset_swap():
    """A replaced dataset must not serve stale data: the C++ ring holds raw
    pointers into the previous arrays."""
    ds1, ds2 = _dataset(n=32, seed=1), _dataset(n=32, seed=2)
    dl = DataLoader(ds1, 8, shuffle=False, seed=0, prefetch=2)
    b1 = next(iter(dl))
    ring1 = dl._prefetcher
    dl.dataset = ds2
    b2 = next(iter(dl))
    assert dl._prefetcher is not ring1
    np.testing.assert_array_equal(
        b2["image"], scale_to_minus_one_one(ds2.images[:8])
    )
    assert not np.array_equal(b1["image"], b2["image"])


def test_gather_index_semantics_match_numpy():
    """Negatives wrap (numpy fancy-indexing parity); out-of-range raises
    instead of the raw C++ OOB read ."""
    ds = _dataset(n=10)
    idx = np.array([-1, 0, -10], np.int64)
    np.testing.assert_array_equal(
        native.gather_affine(ds.images, idx, 255.0, 2.0, -1.0),
        scale_to_minus_one_one(ds.images[idx]),
    )
    np.testing.assert_array_equal(
        native.gather_labels(ds.labels, idx), ds.labels[idx]
    )
    for bad in ([10], [-11]):
        with pytest.raises(IndexError):
            native.gather_affine(ds.images, np.array(bad), 255.0, 2.0, -1.0)


def test_prefetch_loader_abandoned_iterator_restarts_cleanly():
    """An abandoned mid-epoch iterator (early break / next(iter(dl))) must
    not poison the next epoch with stale slots or race the worker's gather
    (batcher.cpp waits out the gather window and drops stale batches on
    epoch restart)."""
    ds = _dataset(n=64)
    dl = DataLoader(ds, 8, shuffle=True, seed=11, prefetch=3)
    for _ in range(5):  # repeatedly abandon with batches still in flight
        next(iter(dl))
    ring = dl._prefetcher
    got = list(dl)  # then consume a full epoch off the SAME ring
    assert dl._prefetcher is ring and len(got) == 8
    # ground truth: a SYNCHRONOUS loader whose rng advanced the same number
    # of times yields the identical epoch, batch for batch — any stale slot
    # served from an abandoned epoch breaks this equality
    dl2 = DataLoader(ds, 8, shuffle=True, seed=11, prefetch=0)
    for _ in range(5):
        next(iter(dl2))
    want = list(dl2)
    assert len(want) == 8
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["label"], b["label"])


def test_prefetch_loader_rebuilds_on_transform_and_batch_change():
    """The ring bakes in (affine, batch_size) at creation — changing either
    after an epoch must rebuild, not silently serve stale-normalized or
    stale-sized batches ."""
    ds = _dataset(n=32)
    dl = DataLoader(ds, 8, shuffle=False, seed=0, prefetch=2)
    assert next(iter(dl))["image"].min() < 0  # [-1, 1] epoch
    ring = dl._prefetcher
    dl.transform = scale_to_zero_one
    b = next(iter(dl))
    assert dl._prefetcher is not ring
    np.testing.assert_array_equal(b["image"], scale_to_zero_one(ds.images[:8]))
    ring = dl._prefetcher
    dl.batch_size = 16
    b = next(iter(dl))
    assert dl._prefetcher is not ring and b["image"].shape[0] == 16
    # switching to a non-affine transform closes the ring and falls back
    dl.transform = lambda x: x.astype(np.float32)
    b = next(iter(dl))
    assert dl._prefetcher is None
    np.testing.assert_array_equal(b["image"], ds.images[:16].astype(np.float32))


def test_prefetch_loader_reuses_ring_across_epochs():
    ds = _dataset(n=32)
    dl = DataLoader(ds, 8, shuffle=True, seed=4, prefetch=2)
    e1, e2 = list(dl), list(dl)
    assert dl._prefetcher is not None
    ring = dl._prefetcher
    assert list(dl) and dl._prefetcher is ring  # one ring, many epochs
    # different epochs shuffle differently (the rng stream advances)
    assert not np.array_equal(e1[0]["label"], e2[0]["label"]) or not (
        np.array_equal(e1[0]["image"], e2[0]["image"])
    )


def test_slotq_collect_scatter_roundtrip():
    """SlotQueue: submit → collect (assembly arrays) → scatter (result
    fan-out) reproduces exactly what the Python batcher does per slot,
    including completion reporting and padding behavior."""
    if not native.available():
        pytest.skip("native library unavailable")
    item = 2 * 2  # (2,2,1) uint8 images
    q = native.SlotQueue(item_bytes=item, queue_limit=8)
    dst_a = np.zeros((3, 2, 2, 1), np.uint8)
    dst_b = np.zeros((2, 2, 2, 1), np.uint8)
    assert q.submit(100, dst_a, seed=7, class_ids=np.array([1, 2, 3]))
    assert q.submit(200, dst_b, seed=9, class_ids=np.array([4, 5]))
    assert q.depth() == 5
    # queue_limit is all-or-nothing per request
    assert not q.submit(300, np.zeros((4, 2, 2, 1), np.uint8), 0,
                        np.zeros(4, np.int32))
    n, seeds, idxs, classes, req_ids, slot_is = q.collect(8, 0.5, 0.0)
    assert n == 5 and q.depth() == 0
    assert seeds[:5].tolist() == [7, 7, 7, 9, 9]
    assert idxs[:5].tolist() == [0, 1, 2, 0, 1]
    assert classes[:5].tolist() == [1, 2, 3, 4, 5]
    assert req_ids[:5].tolist() == [100, 100, 100, 200, 200]
    # pad slots zeroed
    assert seeds[5:].tolist() == [0, 0, 0] and classes[5:].tolist() == [0, 0, 0]
    # batch image j = j everywhere
    imgs = np.stack([np.full((2, 2, 1), j, np.uint8) for j in range(8)])
    done = q.scatter(np.ascontiguousarray(imgs), n, req_ids, slot_is)
    assert sorted(done) == [100, 200]
    np.testing.assert_array_equal(dst_a[:, 0, 0, 0], [0, 1, 2])
    np.testing.assert_array_equal(dst_b[:, 0, 0, 0], [3, 4])
    # empty queue: collect times out with 0
    n2, *_ = q.collect(8, 0.01, 0.0)
    assert n2 == 0
    q.close()


def test_slotq_cancel_and_drain():
    if not native.available():
        pytest.skip("native library unavailable")
    q = native.SlotQueue(item_bytes=4, queue_limit=64)
    dst = np.zeros((2, 2, 2, 1), np.uint8)
    q.submit(1, dst, 0, np.array([0, 1]))
    q.submit(2, dst.copy(), 0, np.array([2, 3]))
    q.cancel(1)
    assert q.depth() == 2  # request 1's slots purged
    n, _, _, classes, req_ids, slot_is = q.collect(4, 0.5, 0.0)
    assert n == 2 and req_ids[:2].tolist() == [2, 2]
    # scatter referencing the cancelled request is skipped silently
    imgs = np.zeros((4, 2, 2, 1), np.uint8)
    bad_ids = np.array([1, 2], np.int64)
    done = q.scatter(imgs, 2, bad_ids, slot_is)
    assert done == []  # req 2 only got 1 of its 2 slots
    q.submit(3, np.zeros((1, 2, 2, 1), np.uint8), 0, np.array([5]))
    assert sorted(q.drain()) == [2, 3]
    assert q.depth() == 0
    q.close()

def test_slotq_collect_more_appends_at_offset():
    """collect_more tops up a partial collect in place: new slots land at
    [offset, offset+n), earlier entries untouched — the serving batcher's
    backpressure fill (service.py _run_native)."""
    if not native.available():
        pytest.skip("native library unavailable")
    q = native.SlotQueue(item_bytes=4, queue_limit=64)
    q.submit(1, np.zeros((2, 2, 2, 1), np.uint8), seed=7,
             class_ids=np.array([1, 2]))
    n, *arrays = q.collect(6, 0.5, 0.0)
    seeds, idxs, classes, req_ids, slot_is = arrays
    assert n == 2
    # nothing queued: collect_more times out empty, arrays untouched
    assert q.collect_more(tuple(arrays), n, 6, 0.01, 0.0) == 0
    q.submit(2, np.zeros((3, 2, 2, 1), np.uint8), seed=9,
             class_ids=np.array([4, 5, 6]))
    added = q.collect_more(tuple(arrays), n, 6, 0.5, 0.0)
    assert added == 3 and q.depth() == 0
    assert seeds.tolist() == [7, 7, 9, 9, 9, 0]
    assert classes.tolist() == [1, 2, 4, 5, 6, 0]
    assert req_ids.tolist() == [1, 1, 2, 2, 2, 0]
    assert idxs.tolist() == [0, 1, 0, 1, 2, 0]
    # capacity respected: only batch - offset slots fit
    q.submit(3, np.zeros((4, 2, 2, 1), np.uint8), seed=3,
             class_ids=np.array([7, 8, 9, 0]))
    assert q.collect_more(tuple(arrays), 5, 6, 0.5, 0.0) == 1
    assert req_ids.tolist() == [1, 1, 2, 2, 2, 3]
    assert seeds.tolist() == [7, 7, 9, 9, 9, 3]
    assert q.depth() == 3  # request 3's remaining slots stay queued
    q.close()


def test_slotq_timeout_ticks_reuse_scratch_arrays():
    """The serving batcher's idle 50 ms collect() loop must not
    allocate five fresh arrays per tick.  Timeout ticks
    reuse ONE retained scratch set; a successful collect surrenders it to
    the caller (fresh set next time) with the zero-pad contract intact."""
    if not native.available():
        pytest.skip("native library unavailable")
    q = native.SlotQueue(item_bytes=4, queue_limit=8)
    n1, s1, *_ = q.collect(4, 0.01, 0.0)
    assert n1 == 0 and s1 is None  # timeout exposes NO arrays (
    # returning the retained set would alias it against the next success)
    sc1 = q._scratch
    assert sc1 is not None
    n2, s2, *_ = q.collect(4, 0.01, 0.0)
    assert n2 == 0 and s2 is None
    assert q._scratch is sc1  # idle tick reused the retained scratch set
    q.submit(1, np.zeros((2, 2, 2, 1), np.uint8), seed=5,
             class_ids=np.array([1, 2]))
    n3, seeds3, _, classes3, req3, _ = q.collect(4, 0.5, 0.0)
    assert n3 == 2 and seeds3 is sc1[0]  # work rode out on the retained set
    assert seeds3.tolist() == [5, 5, 0, 0]  # pads still zero (never written)
    assert classes3[2:].tolist() == [0, 0]
    n4, s4, *_ = q.collect(4, 0.01, 0.0)
    assert n4 == 0 and s4 is None
    assert q._scratch[0] is not seeds3  # fresh set after the surrender
    n5, s5, *_ = q.collect(8, 0.01, 0.0)  # batch change reallocates
    assert n5 == 0 and s5 is None and len(q._scratch[0]) == 8
    q.close()


def test_loader_degrades_when_symbol_binding_fails(monkeypatch):
    """A stale .so lacking the newer ldm_slotq_* symbols must make
    available() return False (pure-Python fallback), not raise out of
    _load() and crash GenerationService/loader construction."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_lib_tried", False)
    monkeypatch.setattr(
        native, "_bind",
        lambda lib: (_ for _ in ()).throw(
            AttributeError("ldm_slotq_create: symbol not found")),
    )
    assert native._load() is None
    assert native.available() is False
    # monkeypatch teardown restores the pre-test _lib/_lib_tried cache
