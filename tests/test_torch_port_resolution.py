"""The resolution axis of the port (``ldm_tpu_torch/perf/``: probes 43, 39,
39b and 41) held against the JAX probes' own functions on the CPU, at a
narrow width (channels 8, multipliers (1, 2)).

* Probe 43's step at 64 px (B=2): ``make_step`` of
  perf/probe43_128px_device.py (taken from the file by its syntax tree: the
  script runs its sweep when imported), plain and under ``jax.checkpoint``,
  against the port's trainer step fed the same weights and JAX's draws
  (loss rtol 1e-5; each gradient within 1e-4 of its leaf's largest entry,
  floored at 1e-2 of the model's largest: a leaf whose exact gradient
  vanishes carries rounding noise alone).  The JAX step returns no
  gradients: after one Adam step its first moment is 0.1 g.
* The port's recomputing step against its plain step, at 64 and 128 px
  (B=1), fp32: losses and gradients bit for bit.
* The attempt loop against a stubbed ``torch.cuda.OutOfMemoryError``: the
  ``fits: false`` row, the retry with the recompute, the verdict.
* Probe 39's ``features`` chunking against perf/probe39_res64.py's on the
  same array and the same featurizer, bit for bit; probe 39 end to end at
  64 px on a few dozen images (T=4), with the JAX probe's keys; probe 39b on
  its run directory, Phase C's images bit for bit.
* Probe 41 over two gloo processes at 32 and 64 px: the dp2_B2 and sp2_B2
  gradients within rtol 2e-4 / atol 1e-6; and from JAX's weights, dp2_B2's
  at 32 px against JAX's gradient of the JAX probe's loss on the same
  inputs (each leaf within 1e-4 of its largest entry, floored as above).
* The backward kernel's plan at (16384, 64) bf16 (the plan only).
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.data.transforms import scale_to_minus_one_one as jax_scale
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu.utils.torch_export import unet_state_dict_from_params
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.factory import build_classifier, load_config
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.perf import probe39_res64 as p39
from ldm_tpu_torch.perf import probe39b_res64_resume as p39b
from ldm_tpu_torch.perf import probe41_sp_resolution as p41
from ldm_tpu_torch.perf import probe43_128px_device as p43
from ldm_tpu_torch.utils.flax_import import unet_from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=[1, 2],
              with_time_emb=True, num_classes=10)
B = 2


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_probe_function(name: str, script: str, **scope):
    """The function ``name`` of a JAX probe script, compiled from its syntax
    tree alone (the scripts run their probes when imported), its globals
    ``scope``."""
    with open(os.path.join(ROOT, "perf", script)) as f:
        tree = ast.parse(f.read())
    node = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == name)
    exec(compile(ast.Module(body=[node], type_ignores=[]), script, "exec"), scope)
    return scope[name]


def leaves(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in unet_state_dict_from_params(
        jax.device_get(tree)).items()}


# --------------------------------------------------------------- probe 43
@pytest.fixture(scope="module")
def jax_steps():
    """JAX's probe-43 step at 64 px on the narrow UNet, plain and remat, and
    the draws of its first step."""
    model = FlaxUNet(**{**NARROW, "channel_multipliers": (1, 2)}, attention_impl="auto_grads")
    diffusion = JaxDiffusion(n_steps=p43.T_STEPS)
    make_step = jax_probe_function("make_step", "probe43_128px_device.py", jax=jax, jnp=jnp,
                                   model=model, diffusion=diffusion)
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 64, 64, 3)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    state = JaxState.create(params, make_optimizer(p43.LR), jax.random.key(1))
    images, labels = np.zeros((B, 64, 64, 3), np.float32), np.zeros((B,), np.int32)

    @jax.jit
    def draws(state):  # the step's own draws (probe43:63-66)
        k_noise, k_drop = jax.random.split(state.step_key())
        eps, _, t = diffusion.noise_batch(k_noise, images)
        return eps, t, jax.random.bernoulli(k_drop, 0.1, labels.shape)

    out = {}
    for remat in (False, True):
        new, loss = jax.jit(make_step(remat))(state, images, labels)
        out[remat] = (float(loss), leaves(jax.tree.map(lambda m: m / 0.1,
                                                         new.opt_state[0].mu)))
    eps, t, drop = draws(state)
    return params, out, {"t": torch.from_numpy(np.array(t)), "eps": torch.from_numpy(
        np.array(eps)), "drop": torch.from_numpy(np.array(drop))}


def port_trainer(tmp_path, params, remat: bool):
    cfg = p43.probe_config(64, str(tmp_path), model=NARROW, use_amp=False)
    model = UNet(**NARROW)
    model.load_state_dict(unet_from_flax(jax.device_get(params)), strict=True)
    trainer = p43.ProbeTrainer(cfg, model, GaussianDiffusion(p43.T_STEPS), None, None,
                               list(range(10)), device="cpu")
    trainer.remat = remat
    return trainer


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_probe43_step_matches_jax(jax_steps, tmp_path, remat):
    params, out, draws = jax_steps
    want_loss, want = out[remat]
    trainer = port_trainer(tmp_path, params, remat)
    loss = trainer.train_step(p43.zero_batch(trainer.config, B), **draws)["loss"].item()
    np.testing.assert_allclose(loss, want_loss, rtol=1e-5)
    floor = 1e-2 * max(float(np.abs(g).max()) for g in want.values())
    for name, p in trainer.model.named_parameters():
        scale = max(float(np.abs(want[name]).max()), floor)
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0, atol=1e-4 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("res", [64, 128])
def test_remat_step_is_the_plain_step(res):
    cfg = p43.probe_config(res, model=NARROW, use_amp=False)
    r = p43.compare_remat(cfg, 1, "cpu", steps=2)
    assert r["bitwise"], r
    assert r["loss_abs"] == 0.0 and r["grad_rel"] == 0.0
    assert r["losses"] == r["losses_remat"] and all(np.isfinite(r["losses"]))


def test_attempt_loop_on_a_stubbed_oom(monkeypatch):
    plain_step = p43.ProbeTrainer._device_step

    def step(self, x0, *rest):
        if x0.shape[0] >= 4 and not self.remat:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")
        return plain_step(self, x0, *rest)

    monkeypatch.setattr(p43.ProbeTrainer, "_device_step", step)
    cfg = p43.probe_config(16, model=NARROW, use_amp=False)
    lines = []
    out = p43.sweep(cfg, "cpu", batches=(1, 2, 4, 8), timed=1, log=lines.append, tag="cpu")
    rows = out["attempts"]
    assert [(r["batch"], r["remat"], r["fits"]) for r in rows] == [
        (1, False, True), (2, False, True), (4, False, False), (4, True, True)]
    assert rows[2]["error"].startswith("execute: OutOfMemoryError: CUDA out of memory")
    assert rows[3]["graphed"] is False and np.isfinite(rows[3]["loss"])
    assert out["max_fitting_batch_no_remat"] == 2
    assert out["verdict"] == "16px single-chip training FITS up to B=2 without remat"
    assert lines[-1] == f"probe43 verdict: {out['verdict']} [cpu]" and len(lines) == 5
    # the JAX probe's wording at its resolution
    assert p43.verdict(out, 128) == "128px single-chip training FITS up to B=2 without remat"
    assert p43.verdict({"attempts": [rows[2]]}) == (
        "128px single-chip training does NOT fit at any batch")


# --------------------------------------------------------------- probe 39
def test_probe39_features_chunking_is_the_jax_probes():
    torch.manual_seed(3)
    cfg = load_config(os.path.join(ROOT, p39.CONFIG))
    clf = build_classifier(dataclasses.replace(cfg, use_amp=False), 3, 10).eval()

    def feat_fn(_vars, chunk):  # the port's classifier, called as the JAX probe calls flax
        with torch.no_grad():
            return clf(torch.from_numpy(np.array(chunk)), features=True).numpy()

    jax_features = jax_probe_function("features", "probe39_res64.py", np=np, jnp=jnp,
                                      scale_to_minus_one_one=jax_scale, feat_fn=feat_fn,
                                      cvars=None)
    rng = np.random.default_rng(0)
    # a short last chunk; whole chunks; fewer images than a chunk (8x8: cheap)
    for n in (300, 512, 100):
        images = rng.integers(0, 256, (n, 8, 8, 3), dtype=np.uint8)
        want = jax_features(images)
        got = p39.features(clf, images, "cpu")
        assert got.shape == want.shape == (n, 512)
        assert np.array_equal(got, want), n


@pytest.fixture(scope="module")
def probe39_runs(tmp_path_factory):
    base = load_config(os.path.join(ROOT, p39.CONFIG))
    cfg = dataclasses.replace(
        base, workdir=str(tmp_path_factory.mktemp("probe39")), batch_size=4,
        model=dataclasses.replace(base.model, params=NARROW),
        data=dataclasses.replace(base.data, synthetic_size=40),
        diffusion=dataclasses.replace(base.diffusion, n_steps=4))
    with p43.deterministic():
        a = p39.run(cfg, epochs=1, n_fid=8, clf_epochs=1, clf_val=8, device="cpu", batch=4,
                    log=lambda _: None)
        b = p39b.run(cfg, n_fid=8, clf_epochs=1, clf_val=8, device="cpu", batch=4,
                     log=lambda _: None)
    return a, b


def test_probe39_end_to_end_at_64px(probe39_runs):
    a, _ = probe39_runs
    out = p39.json_rows(a)
    # the JAX probe's keys, its TPU anchors left out; the launches by phase
    assert set(out) == {"device", "n", "image_size", "t", "train", "classifier", "ddpm400",
                        "ddim50", "launches"}
    assert set(out["launches"]) == {"A", "B", "C_ddpm400", "C_ddim50"}
    assert (out["n"], out["image_size"], out["t"]) == (8, 64, 4)
    assert set(out["train"]) >= {"steps", "seconds", "steps_per_sec", "epochs_run",
                                 "final_val_loss"}
    assert out["train"]["steps"] == 9 and out["train"]["epochs_run"] == 1
    for name in ("ddpm400", "ddim50"):
        assert set(out[name]) == {"img_per_sec", "fid_pixel", "fid_classifier"}
        assert all(np.isfinite(v) for v in out[name].values())
        assert a["images"][name].shape == (8, 64, 64, 3) and a["images"][name].dtype == np.uint8


def test_probe39b_resumes_with_the_same_images(probe39_runs):
    a, b = probe39_runs
    out = p39.json_rows(b)
    assert out["train"]["steps"] == 9 and out["train"]["epochs_run"] == 1
    assert out["train"]["final_val_loss"] == p39.json_rows(a)["train"]["final_val_loss"]
    assert out["classifier"]["best_valid_loss"] == a["classifier"]["best_valid_loss"]
    for name in ("ddpm400", "ddim50"):
        assert np.array_equal(a["images"][name], b["images"][name]), name
        assert out[name]["fid_pixel"] == a[name]["fid_pixel"]


# --------------------------------------------------------------- probe 41
def test_probe41_dp_and_sp_gradients_agree():
    out = p41.run(sizes=(32, 64), device="cpu", check=(32, 64), timing_steps=1,
                  config=os.path.join(ROOT, p41.CONFIG), model=NARROW, log=lambda _: None)
    for size in ("32px", "64px"):
        row = out[size]
        for name, _, _ in p41.ROWS:
            assert row[name]["step_s"] > 0 and row[name]["peak_bytes"] == [None, None]
        assert np.isfinite(row["overhead_matched_batch"])
        check = out["grad_check"][size]
        assert check["ok"] and (check["rtol"], check["atol"]) == (2e-4, 1e-6)
        assert all(r["max_excess"] <= 0 for r in check["ranks"])


def test_probe41_dp_gradient_matches_jax(tmp_path):
    """dp2_B2's flat gradient at 32 px (two processes, the mean over the
    mesh; the check alone, no timed rows) against JAX's gradient of probe
    41's loss (perf/probe41:81-82, the mean squared error over the global
    batch) on the same numpy inputs and JAX's weights: each leaf within 1e-4
    of its largest entry, floored at 1e-2 of the model's largest."""
    model = FlaxUNet(**{**NARROW, "channel_multipliers": (1, 2)})
    params = jax.jit(model.init)(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                 jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    weights = str(tmp_path / "unet.pt")
    torch.save(unet_from_flax(jax.device_get(params)), weights)
    out = p41.run(sizes=(), device="cpu", check=(32,), config=os.path.join(ROOT, p41.CONFIG),
                  model=NARROW, weights=weights, keep_grads=True, log=lambda _: None)
    x, t, y, tgt = (jnp.asarray(v.numpy()) for v in p41.global_inputs(32, 2, "cpu"))
    grads = jax.jit(jax.grad(lambda p: jnp.mean((model.apply(p, x, t, y) - tgt) ** 2)))(params)
    want = leaves(grads)
    shapes = [(name, p.shape) for name, p in UNet(**NARROW).named_parameters()]
    flat = out["grad_check"]["32px"]["dp_grad"]
    assert flat.numel() == sum(int(np.prod(shape)) for _, shape in shapes)
    floor = 1e-2 * max(float(np.abs(g).max()) for g in want.values())
    for (name, shape), got in zip(shapes, flat.split([int(np.prod(s)) for _, s in shapes])):
        scale = max(float(np.abs(want[name]).max()), floor)
        np.testing.assert_allclose(got.reshape(shape).numpy(), want[name], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)


# ------------------------------------------------------ the backward's plan
def test_backward_plan_at_128px_is_tiled_over_8_ctas():
    plan = la.plan_bwd(16384, 64, torch.bfloat16)
    assert plan.path == "tiled" and plan.cs == 8 and plan.rows == 2048
    assert plan.smem_bytes <= la.SMEM_LIMIT
    fwd = la.plan_fwd(16384, 64, torch.bfloat16)
    assert fwd.cs == 8 and fwd.rows == 2048
