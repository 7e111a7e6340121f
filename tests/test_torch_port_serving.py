"""The port's serving layer (``ldm_tpu_torch/serving``) on the CPU: the tests
of ``tests/test_serving.py`` with fake torch samplers (batcher semantics,
per-slot determinism, rejection, the races, the HTTP surface), in the native
slot-queue and the pure-Python batcher where the JAX test is; the JAX
``GenerationService`` and the port's over the same tiny UNet and the same
x_T; and the builder from a ``.pt``.  The mesh tests and the consistency
builder have no counterpart yet (ROADMAP queue 1, items 11-12).

Nothing here may hang: every result, join and HTTP call has a timeout and
every service is stopped in a ``finally`` (or a ``with``).
"""

import base64
import dataclasses
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ldm_tpu_torch import native
from ldm_tpu_torch.serving import GenerationHTTPServer, GenerationService
from ldm_tpu_torch.serving.service import pack_uint8, slot_generator

NUM_CLASSES = 10
SHAPE = (4, 4, 1)
WAIT = 30  # seconds: every future.result and join


def class_coded_sampler(classes, x_init, generator):
    """Every pixel of slot j is its class id, scaled into [-1, 1]."""
    v = (classes.to(torch.float32) + 0.5) / NUM_CLASSES * 2.0 - 1.0
    return v[:, None, None, None].expand((classes.shape[0],) + SHAPE)


def xinit_sampler(classes, x_init, generator):
    """The output depends only on the slot's x_T: DDIM at eta 0's structure."""
    return torch.tanh(x_init)


def expected_class_pixel(c: int) -> int:
    v = (c + 0.5) / NUM_CLASSES * 2.0 - 1.0
    return int(np.clip((v + 1.0) / 2.0, 0, 1) * 255)


def make_service(sampler=class_coded_sampler, **kw):
    kw.setdefault("image_shape", SHAPE)
    kw.setdefault("num_classes", NUM_CLASSES)
    kw.setdefault("batch_size", 4)
    kw.setdefault("max_delay_s", 0.05)
    return GenerationService(sampler, **kw)


def test_pack_uint8_equals_reverse_transform():
    from ldm_tpu_torch.data.transforms import reverse_transform

    x = np.random.default_rng(0).standard_normal((4, 8, 8, 3)).astype(np.float32) * 1.5
    x[0, 0, 0] = [-1.0, 1.0, 0.0]
    np.testing.assert_array_equal(pack_uint8(torch.from_numpy(x)).numpy(), reverse_transform(x))


def test_slot_generators_depend_on_seed_and_index_only():
    a = torch.randn(8, generator=slot_generator(5, 2))
    assert torch.equal(a, torch.randn(8, generator=slot_generator(5, 2)))
    for other in ((5, 3), (2, 5), (6, 2)):
        assert not torch.equal(a, torch.randn(8, generator=slot_generator(*other)))


@pytest.mark.parametrize("use_native", [True, False])
def test_routing_and_coalescing(use_native):
    """Concurrent requests each get their class's images, coalesced into
    fewer batches than requests; the slot-queue and Python batchers alike."""
    with make_service(batch_size=8, use_native=use_native) as svc:
        futures = {c: svc.submit(c, n=3) for c in range(5)}
        for c, fut in futures.items():
            imgs = fut.result(timeout=WAIT)
            assert imgs.shape == (3,) + SHAPE and imgs.dtype == np.uint8
            assert (imgs == expected_class_pixel(c)).all()
    s = svc.stats()
    assert s.requests == 5 and s.images == 15
    assert s.batches - 1 <= 5  # minus the warm-up batch
    assert s.latency_p50_s > 0 and s.host_ms_per_batch > 0


def test_mixed_class_request():
    with make_service() as svc:
        imgs = svc.submit([1, 7, 3], n=3).result(timeout=WAIT)
    assert [int(i[0, 0, 0]) for i in imgs] == [
        expected_class_pixel(1), expected_class_pixel(7), expected_class_pixel(3)]


def test_per_slot_determinism_across_batch_compositions():
    """The same (seed, n) request returns the same images whatever other
    traffic rode in its batches."""
    with make_service(xinit_sampler, batch_size=4) as svc:
        a = svc.submit(0, n=3, seed=123).result(timeout=WAIT)
    with make_service(xinit_sampler, batch_size=8) as svc2:
        noise = [svc2.submit(c % NUM_CLASSES, n=2, seed=c) for c in range(3)]
        b = svc2.submit(0, n=3, seed=123).result(timeout=WAIT)
        for f in noise:
            f.result(timeout=WAIT)
    np.testing.assert_array_equal(a, b)
    with make_service(xinit_sampler) as svc3:
        c = svc3.submit(0, n=3, seed=124).result(timeout=WAIT)
    assert not np.array_equal(a, c)


def test_requests_larger_than_batch_span_batches():
    with make_service(batch_size=4) as svc:
        imgs = svc.submit(2, n=11).result(timeout=WAIT)
    assert imgs.shape == (11,) + SHAPE
    assert (imgs == expected_class_pixel(2)).all()
    assert svc.stats().batches - 1 >= 3  # 11 slots, 4 a batch (and the warm-up)


def test_validation_and_lifecycle():
    svc = make_service()
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit(0)
    svc.start(warmup=False)
    try:
        with pytest.raises(ValueError, match="class ids"):
            svc.submit(NUM_CLASSES)
        with pytest.raises(ValueError, match="positive"):
            svc.submit(0, n=0)
        with pytest.raises(ValueError, match="length n"):
            svc.submit([1, 2], n=3)
        assert svc.submit(4, n=2).result(timeout=WAIT).shape == (2,) + SHAPE
    finally:
        svc.stop()
    with pytest.raises(RuntimeError, match="not running"):
        svc.submit(0)


@pytest.mark.parametrize("use_native", [True, False])
def test_queue_full_rejects_cleanly(use_native):
    svc = make_service(batch_size=1, queue_limit=1, use_native=use_native)
    blocker = threading.Event()
    batched = svc._batched

    def blocking(*args):  # hold the worker mid-batch so the queue backs up
        blocker.wait(WAIT)
        return batched(*args)

    svc._batched = blocking
    svc.start(warmup=False)
    try:
        first = svc.submit(0, n=1)
        time.sleep(0.2)  # the worker is now blocked inside its first batch
        fut = svc.submit(1, n=8)  # 8 slots into a 1-slot queue
        with pytest.raises(RuntimeError, match="queue is full"):
            fut.result(timeout=WAIT)
        blocker.set()
        assert first.result(timeout=WAIT).shape == (1,) + SHAPE
    finally:
        blocker.set()
        svc.stop()
    assert svc.stats().rejected == 1


@pytest.mark.parametrize("use_native", [True, False])
def test_worker_failure_fails_futures_not_hangs(use_native):
    """A sampler that raises fails every pending future promptly and marks
    the service dead, instead of leaving clients on futures nobody resolves."""
    svc = make_service(use_native=use_native)

    def exploding(*args):
        raise ValueError("device fell over")

    svc._batched = exploding
    svc.start(warmup=False)
    try:
        futs = [svc.submit(c % NUM_CLASSES, n=2) for c in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="worker failed"):
                f.result(timeout=10)
        deadline = time.monotonic() + 5
        while svc._failure is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="service failed"):
            svc.submit(0)
    finally:
        svc.stop()


@pytest.mark.parametrize("use_native", [True, False])
def test_stop_drains_inflight_work(use_native):
    svc = make_service(batch_size=2, use_native=use_native)
    svc.start(warmup=False)
    try:
        futs = [svc.submit(c % NUM_CLASSES, n=2) for c in range(6)]
    finally:
        svc.stop()
    for f in futs:
        assert f.done()
        assert f.result(timeout=5).shape == (2,) + SHAPE


# ------------------------------------------------------------------- HTTP


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_surface():
    with make_service() as svc, GenerationHTTPServer(svc) as server:
        url = server.address
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            assert json.loads(r.read()) == {"ok": True}

        code, out = _post(url + "/generate", {"class_id": 3, "n": 2, "seed": 7, "format": "npy"})
        assert code == 200 and len(out["images"]) == 2
        arr = np.load(io.BytesIO(base64.b64decode(out["images"][0])))
        assert arr.shape == SHAPE and (arr == expected_class_pixel(3)).all()

        code, out = _post(url + "/generate", {"class_id": 5, "format": "png"})
        assert code == 200 and len(out["images"]) == 1
        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(out["images"][0])))
        assert img.size == (SHAPE[1], SHAPE[0])
        assert np.asarray(img)[0, 0] == expected_class_pixel(5)

        with urllib.request.urlopen(url + "/stats", timeout=10) as r:
            stats = json.loads(r.read())
        assert stats["requests"] >= 2 and stats["images"] >= 3

        assert _post(url + "/generate", {"n": 1})[0] == 400  # no class_id
        assert _post(url + "/generate", {"class_id": 99})[0] == 400
        assert _post(url + "/generate", {"class_id": 0, "format": "gif"})[0] == 400
        assert _post(url + "/nope", {})[0] == 404


def test_http_npy_equals_submit():
    """The same request through POST /generate (npy) and submit()."""
    with make_service(xinit_sampler) as svc, GenerationHTTPServer(svc) as server:
        want = svc.submit([2, 8], n=2, seed=31).result(timeout=WAIT)
        code, out = _post(server.address + "/generate",
                          {"class_id": [2, 8], "n": 2, "seed": 31, "format": "npy"})
    assert code == 200
    got = np.stack([np.load(io.BytesIO(base64.b64decode(s))) for s in out["images"]])
    np.testing.assert_array_equal(got, want)


def test_http_concurrent_clients():
    """Client threads hammer the server; every response is right."""
    with make_service(batch_size=8) as svc, GenerationHTTPServer(svc) as server:
        url = server.address + "/generate"
        results = {}

        def client(c):
            results[c] = _post(url, {"class_id": c, "n": 2, "format": "npy"})

        threads = [threading.Thread(target=client, args=(c,)) for c in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert sorted(results) == list(range(6))
        for c, (code, out) in results.items():
            assert code == 200
            arr = np.load(io.BytesIO(base64.b64decode(out["images"][0])))
            assert (arr == expected_class_pixel(c)).all()
    assert svc.stats().batches - 1 <= 8  # coalesced, not 12 singleton batches


# ---------------------------------------------------- per-slot-key samplers


def slotkey_sampler(classes, x_init, generator, slot_gens):
    """A sampler that draws noise inside its loop from each slot's generator:
    batching-invariant only if the service really passes them."""
    extra = torch.stack([torch.randn(SHAPE, generator=g) for g in slot_gens])
    return torch.tanh(x_init + 0.5 * extra)


def test_per_slot_keys_batching_invariance():
    outs = {}
    for scenario in ("alone", "packed"):
        with make_service(slotkey_sampler, batch_size=8, per_slot_keys=True) as svc:
            if scenario == "packed":
                svc.submit(7, n=5, seed=999)  # rides in the same batch
            outs[scenario] = svc.submit(2, n=3, seed=5).result(timeout=WAIT)
    np.testing.assert_array_equal(outs["alone"], outs["packed"])


def test_native_and_python_paths_bit_identical():
    """The C++ slot-queue path and the Python batcher give the same images
    for the same (seed, n) request."""
    if not native.available():
        pytest.skip("native library unavailable")
    outs = []
    for use_native in (True, False):
        with make_service(xinit_sampler, batch_size=4, use_native=use_native) as svc:
            assert (svc._slotq is not None) == use_native
            outs.append(svc.submit(3, n=5, seed=42).result(timeout=WAIT))
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.parametrize("use_native", [True, False])
def test_backpressure_top_up_fills_pad_slots(use_native):
    """While the hand-off queue is full the batcher keeps filling a partial
    batch instead of shipping pad slots.  White box: the hand-off queue is
    pre-filled, so the batcher is inside the top-up loop when the second
    request lands."""
    if use_native and not native.available():
        pytest.skip("native library unavailable")
    svc = make_service(batch_size=4, max_delay_s=0.01, use_native=use_native)
    assert (svc._slotq is not None) == use_native
    for _ in range(svc._fulfil_q.maxsize):  # saturate the hand-off queue
        svc._fulfil_q.put("sentinel")
    batcher = threading.Thread(target=svc._run, daemon=True)
    svc._worker = batcher  # satisfies submit()'s liveness check
    try:
        svc.submit(1, n=2)
        batcher.start()
        time.sleep(0.2)  # the first collect window (10 ms) long over
        svc.submit(2, n=2)  # lands while the batcher tops up
        depth = svc._slotq.depth if use_native else svc._queue.qsize
        deadline = time.monotonic() + 5.0
        while depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert depth() == 0, "the top-up never drained the queued slots"
        for _ in range(3):  # unblock the batcher's put(): the sentinels, then the batch
            assert svc._fulfil_q.get(timeout=5) == "sentinel"
        item = svc._fulfil_q.get(timeout=5)
        assert (item[1] if use_native else len(item[1])) == 4
        s = svc.stats()
        assert s.batches == 1 and s.padded_slots == 0
    finally:
        svc._stop.set()
        assert svc._fulfil_q.get(timeout=5) is None  # the drain sentinel on exit
        batcher.join(timeout=5)
    assert not batcher.is_alive()


@pytest.mark.parametrize("use_native", [True, False])
def test_submit_racing_worker_death_fails_future(use_native):
    """A worker failure landing between submit()'s liveness check and its
    enqueue fails the future instead of hanging the client.  Injected
    deterministically: the enqueue primitive runs the sweep first."""
    with make_service(use_native=use_native) as svc:
        svc.submit(0, n=1).result(timeout=WAIT)  # the service is live
        boom = RuntimeError("boom")
        if svc._slotq is not None:
            real = svc._slotq.submit

            def racy(req_id, dst, seed, ids):
                svc._fail_native(boom, [])  # the sweep runs before the slots land
                return real(req_id, dst, seed, ids)

            svc._slotq.submit = racy
        else:
            real_put = svc._queue.put_nowait
            fired = []

            def racy_put(item):
                if not fired:
                    fired.append(1)
                    svc._fail(boom, [])  # the sweep drains before this slot lands
                real_put(item)

            svc._queue.put_nowait = racy_put
        fut = svc.submit(1, n=2)
        with pytest.raises(RuntimeError, match="died during submission|boom"):
            fut.result(timeout=5)


@pytest.mark.parametrize("use_native", [True, False])
def test_first_resolver_wins(use_native):
    """A failure sweep racing a fulfilled batch: each future is resolved
    once, by whichever came first, and the sweep goes on past it."""
    from ldm_tpu_torch.serving.service import _try_resolve

    with make_service(use_native=use_native) as svc:
        done = svc.submit(1, n=1).result(timeout=WAIT)
        fut = svc.submit(2, n=1)
        fut.result(timeout=WAIT)
    assert not _try_resolve(fut, RuntimeError("late"))
    assert not _try_resolve(fut, result=None)
    np.testing.assert_array_equal(fut.result(timeout=1)[0], np.full(SHAPE, expected_class_pixel(2)))
    assert done.shape == (1,) + SHAPE


# ------------------------------------------------------ real models, CPU


def tiny_config(tmp_path, port: bool):
    if port:
        from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig
    else:
        from ldm_tpu.config import Config, DataConfig, DiffusionConfig, ModelConfig
    return Config(
        project_name="serve", workdir=str(tmp_path), use_amp=False, seed=0,
        model=ModelConfig(params=dict(in_channels=3, out_channels=3, channels=8,
                                      channel_multipliers=[1, 2], num_classes=NUM_CLASSES)),
        diffusion=DiffusionConfig(n_steps=10, cfg_scale=3),
        data=DataConfig(dataset="SYNTHETIC", image_size=16, image_channels=3),
    )


REQUESTS = [(1, 3, 5), ([0, 4, 9], 3, 11), (7, 2, 3)]  # (class ids, n, seed)


def test_service_matches_the_jax_service(tmp_path):
    """The JAX GenerationService and the port's over the same tiny UNet
    (channels 8, 16px, T=10, DDIM 5 steps, eta 0, CFG 3, batch 4), the
    port given the JAX service's own x_T through ``x_init_fn``: the uint8
    images within 1 level, on at most 0.1% of the pixels (an fp32 sum in
    another order can move a value across a floor)."""
    import jax
    import jax.numpy as jnp

    from ldm_tpu.factory import build_model as jax_build_model
    from ldm_tpu.serving.builder import build_generation_service as jax_service
    from ldm_tpu.training import checkpoint as jax_ckpt
    from ldm_tpu_torch.serving.builder import build_generation_service
    from ldm_tpu_torch.utils.flax_import import unet_from_flax

    jcfg, pcfg = tiny_config(tmp_path / "jax", False), tiny_config(tmp_path / "port", True)
    jcfg.create_dirs()
    shape = (16, 16, 3)
    params = jax.jit(jax_build_model(jcfg).init)(
        jax.random.key(0), jnp.zeros((1,) + shape), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1,), jnp.int32))
    jax_ckpt.save_params(f"{jcfg.checkpoints}/diffusion_model_ema.msgpack", params)
    pt = str(tmp_path / "unet.pt")
    torch.save(unet_from_flax(jax.tree_util.tree_map(np.asarray, jax.device_get(params))), pt)

    @jax.jit
    def jax_x_init(seeds, idxs):  # the JAX service's draws (service.py:167-172)
        return jax.vmap(lambda s, i: jax.random.normal(
            jax.random.fold_in(jax.random.key(s), i), shape, jnp.float32))(seeds, idxs)

    kw = dict(sampler="ddim", ddim_steps=5, eta=0.0, batch_size=4, max_delay_s=0.01)
    outs = {}
    for name, svc in (
            ("jax", jax_service(jcfg, **kw)),
            ("port", build_generation_service(pcfg, pt, device="cpu", x_init_fn=lambda s, i:
                                              np.asarray(jax_x_init(s, i)), **kw))):
        with svc:
            futs = [svc.submit(c, n=n, seed=s) for c, n, s in REQUESTS]
            outs[name] = np.concatenate([f.result(timeout=120) for f in futs])
    a, b = outs["jax"].astype(np.int32), outs["port"].astype(np.int32)
    assert a.shape == b.shape == (8,) + shape
    diff = np.abs(a - b)
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()
    assert len(np.unique(a)) > 10  # images, not a constant


def test_builder_real_model_smoke(tmp_path):
    """A tiny UNet through the builder: a .pt in the run directory ->
    service -> images; the deterministic samplers (DDIM, DPM-Solver++, the
    distilled consistency sampler, and DDIM over a latent config's latents,
    decoded) are seed-reproducible."""
    from ldm_tpu_torch.config import ModelConfig
    from ldm_tpu_torch.factory import build_model
    from ldm_tpu_torch.serving.builder import build_generation_service, checkpoint_path

    cfg = tiny_config(tmp_path, True)
    cfg.create_dirs()
    torch.manual_seed(0)
    torch.save(build_model(cfg).state_dict(), checkpoint_path(cfg))

    with pytest.raises(FileNotFoundError):
        build_generation_service(cfg, checkpoint=str(tmp_path / "nope.pt"), device="cpu")
    with pytest.raises(ValueError, match="sampler must be"):
        build_generation_service(cfg, sampler="euler", device="cpu")
    with pytest.raises(FileNotFoundError, match="consistency_model_ema.pt"):
        build_generation_service(cfg, sampler="consistency", device="cpu")
    # the distilled student's weights where the distiller leaves them (here
    # the same UNet), and a latent config over a seeded random first stage
    torch.save(build_model(cfg).state_dict(), checkpoint_path(cfg, True, "consistency_model"))
    latent = dataclasses.replace(
        cfg, type="latent", project_name="serve_latent",
        model=ModelConfig(params=dict(in_channels=4, out_channels=4, channels=16,
                                      channel_multipliers=[1], num_classes=NUM_CLASSES)),
        autoencoder=ModelConfig(target="ldm_tpu.models.autoencoder.Autoencoder",
                                params=dict(in_channels=3, out_channels=3, channels=8,
                                            channel_multipliers=[1, 2], n_resnet_blocks=1,
                                            z_channels=4)),
        diffusion=dataclasses.replace(cfg.diffusion, schedule="sqrt_linear",
                                      latent_scaling_factor=0.8))
    latent.create_dirs()
    torch.save(build_model(latent).state_dict(), checkpoint_path(latent))

    for c, sampler in ((cfg, "ddim"), (cfg, "dpmpp"), (cfg, "consistency"), (latent, "ddim")):
        svc = build_generation_service(c, sampler=sampler, ddim_steps=2, batch_size=4,
                                       max_delay_s=0.01, device="cpu")
        assert svc.per_slot_keys == (sampler == "consistency")
        assert svc.image_shape == ((8, 8, 4) if c is latent else (16, 16, 3))
        with svc:
            a = svc.submit(1, n=2, seed=5).result(timeout=120)
            b = svc.submit(1, n=2, seed=5).result(timeout=120)
        assert a.shape == (2, 16, 16, 3) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_serve_cli_defaults_to_the_card():
    from ldm_tpu_torch.serve import parse_args

    args = parse_args(["configs/smoke_synthetic.yaml"])
    assert (args.device, args.sampler, args.ddim_steps, args.batch_size, args.max_delay_ms,
            args.ema, args.port) == ("cuda", "ddim", 50, 64, 20.0, True, 8080)
    assert parse_args(["c.yaml", "--device", "cpu", "--no-ema"]).device == "cpu"
