"""The port's bench (``ldm_tpu_torch/bench.py``, ``perf/flops.py``) on the CPU:
its FLOP counts against XLA's cost analysis of the JAX bench's own
computations (counted as the root ``bench.py`` counts them, recomputed here:
importing that file turns on a persistent compilation cache), the counts'
linearity in the batch, the reference-style step against the fused CFG step,
and its one JSON line in quick and full mode with the JAX bench's keys."""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu_torch import bench
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.autoencoder import Autoencoder
from ldm_tpu_torch.models.resnet import ResNetBase
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.perf import flops
from ldm_tpu_torch.ops import launch_counts

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (32, 32, 3)
COUNT_B = 4  # the JAX counts' batch (2B = 8 for the sampler's forward)
# the port counts products only; XLA also counts elementwise work (the
# normalisations, activations, the sampler's lerp): measured 0.9831 at
# channels 8 and 0.9955 at channels 16
SAMPLER_RATIO = (0.97, 1.0)
# a train step's XLA count also holds Adam, the EMA, the noising and the
# backward's elementwise work: measured 0.9687 at channels 8, B=4
TRAIN_RATIO = (0.95, 1.0)
TRAJ_ATOL = 1e-5  # fp32: the fused 2B forward and two B forwards


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cost_flops(fn, *args) -> float:
    ca = jax.jit(fn).lower(*args).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    return float(ca["flops"])


def _flax_unet(channels, multipliers):
    return FlaxUNet(in_channels=3, out_channels=3, channels=channels,
                    channel_multipliers=multipliers, num_classes=10, attention_impl="xla")


@pytest.mark.parametrize("channels,multipliers", [(8, (1, 2)), (16, (1, 2, 4))])
def test_sampler_count_against_xla_cost_analysis(channels, multipliers):
    """One CFG forward on 2B, per image: the root bench.py:81-117 way on the
    XLA-attention twin, against FlopCounterMode over the port's plain path
    at the same width."""
    model = _flax_unet(channels, multipliers)
    x = jnp.zeros((1,) + SHAPE, jnp.float32)
    i1 = jnp.zeros((1,), jnp.int32)
    params = jax.eval_shape(model.init, jax.random.key(0), x, i1, i1)
    b2 = 2 * COUNT_B
    want = _cost_flops(model.apply, params, jax.ShapeDtypeStruct((b2,) + SHAPE, jnp.float32),
                       jax.ShapeDtypeStruct((b2,), jnp.int32),
                       jax.ShapeDtypeStruct((b2,), jnp.int32)) / COUNT_B
    port = UNet(3, 3, channels, multipliers, num_classes=10)
    got = flops.sampler_flops_per_img_step(port, SHAPE, batch=COUNT_B)
    assert SAMPLER_RATIO[0] <= got / want <= SAMPLER_RATIO[1], (got, want, got / want)


def test_train_step_count_against_xla_cost_analysis():
    """The root bench.py:213-232 step (noising, label drop, eps-MSE,
    value_and_grad, Adam, EMA) on the XLA-attention twin at channels 8,
    against the port's forward and backward count."""
    model = _flax_unet(8, (1, 2))
    diffusion = JaxDiffusion(n_steps=1000)
    x = jnp.zeros((1,) + SHAPE, jnp.float32)
    i1 = jnp.zeros((1,), jnp.int32)
    params = jax.eval_shape(model.init, jax.random.key(0), x, i1, i1)
    state = jax.eval_shape(lambda p: JaxState.create(p, make_optimizer(5e-4), jax.random.key(1)),
                           params)
    images = np.zeros((COUNT_B,) + SHAPE, np.float32)
    labels = np.zeros((COUNT_B,), np.int32)

    def step(state):
        k_noise, k_drop = jax.random.split(state.step_key())
        eps, xt, t = diffusion.noise_batch(k_noise, images)
        y = jnp.where(jax.random.bernoulli(k_drop, 0.1), jnp.int32(10), labels)

        def loss_fn(p):
            return jnp.mean((eps - model.apply(p, xt, t, y)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss

    want = _cost_flops(step, state)
    got = flops.diffusion_step_flops(UNet(3, 3, 8, (1, 2), num_classes=10), COUNT_B, SHAPE)
    assert TRAIN_RATIO[0] <= got / want <= TRAIN_RATIO[1], (got, want, got / want)


def _tiny_counts(batch: int) -> dict:
    unet = UNet(3, 3, 8, (1, 2), num_classes=10)
    clf = ResNetBase(3, 10, n_blocks=(1, 1), n_channels=(8, 16))
    vae = Autoencoder(3, 4, 3, channels=8, channel_multipliers=(1, 2), n_resnet_blocks=1)
    return {"sampler": flops.sampler_flops_per_img_step(unet, SHAPE, batch) * batch,
            "diffusion_step": flops.diffusion_step_flops(unet, batch, SHAPE),
            "classifier_step": flops.classifier_step_flops(clf, batch, SHAPE),
            "vae_step": flops.vae_step_flops(vae, batch, SHAPE)}


@pytest.mark.parametrize("kind", ["sampler", "diffusion_step", "classifier_step", "vae_step"])
def test_counts_are_linear_in_the_batch(kind):
    """Every counted op is per item: a count at B is B times the count at 1,
    so the bench may count at a small batch and scale."""
    one, five = _tiny_counts(1)[kind], _tiny_counts(5)[kind]
    assert one > 0 and five == 5 * one


def test_reference_style_step_equals_the_fused_cfg_step():
    """The reference loop's step (two UNet calls, the lerp, p_sample), fed
    the same x_T and the same noise, traces the port's fused 2B CFG sampler
    over a whole T=4 trajectory (fp32)."""
    torch.manual_seed(0)
    model = UNet(3, 3, 8, (1, 2), num_classes=10).eval()
    diffusion = GaussianDiffusion(4)
    rng = np.random.default_rng(0)
    b, shape = 3, (16, 16, 3)
    x_init = torch.from_numpy(rng.standard_normal((b,) + shape).astype(np.float32))
    noise = {t: torch.from_numpy(rng.standard_normal((b,) + shape).astype(np.float32))
             for t in range(4)}
    classes = torch.tensor([1, 5, 9])
    null = torch.full_like(classes, model.null_label)
    fused = diffusion.sample(model, classes, shape, cfg_scale=bench.CFG_SCALE,
                             null_label=model.null_label, x_init=x_init,
                             noise=lambda t: noise[t], graph=False)
    xt = x_init
    with torch.inference_mode():
        for t in range(3, -1, -1):
            xt = bench.reference_style_step(model, diffusion, xt, t, classes, null, noise[t])
    assert not torch.equal(xt, x_init)
    np.testing.assert_allclose(xt.numpy(), fused.numpy(), rtol=0, atol=TRAJ_ATOL)


def jax_bench_keys() -> tuple:
    """The root bench.py's line, read from its source (not imported): the
    keys of ``main``'s ``out`` with ``_main_body``'s first ``out.update``
    (every mode), and those of its second (full mode only)."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}

    def keys(node):
        return {k.value for k in node.keys}

    (out,) = [n.value for n in ast.walk(funcs["main"]) if isinstance(n, ast.Assign)
              and getattr(n.targets[0], "id", None) == "out"]
    updates = sorted((n for n in ast.walk(funcs["_main_body"]) if isinstance(n, ast.Call)
                      and getattr(n.func, "attr", None) == "update"
                      and getattr(n.func.value, "id", None) == "out"), key=lambda n: n.lineno)
    every, full = (keys(u.args[0]) for u in updates)
    return keys(out) | every, full


def _line(capsys) -> dict:
    """The one JSON line the run printed, last, with nothing else in JSON."""
    lines = capsys.readouterr().out.strip().splitlines()
    parsed = []
    for line in lines:
        try:
            parsed.append(json.loads(line))
        except ValueError:
            pass
    assert len(parsed) == 1 and parsed[0] == json.loads(lines[-1])
    return parsed[0]


@pytest.fixture
def tiny_bench(monkeypatch, tmp_path):
    """The bench at a tiny width and depth on the CPU: a channels-8 UNet,
    T=4, B=4, train runs of 2 steps; the baseline file in ``tmp_path``."""
    def tiny_build(device):
        torch.manual_seed(0)
        return (UNet(3, 3, 8, (1, 2), num_classes=10).to(device).eval(),
                GaussianDiffusion(bench.T, device=device))

    monkeypatch.setattr(bench, "build", tiny_build)
    monkeypatch.setattr(bench, "T", 4)
    monkeypatch.setattr(bench, "TRAIN_STEPS", 2)
    monkeypatch.setattr(bench, "QUICK_BATCHES", (4,))
    monkeypatch.setattr(bench, "TRAIN_BATCH", 4)
    monkeypatch.setattr(bench, "BASELINE_FILE", str(tmp_path / "baseline.json"))
    monkeypatch.delenv(bench.REFERENCE_ENV, raising=False)
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json"), "rb") as f:
        before = f.read()
    yield tmp_path
    with open(os.path.join(ROOT, "BASELINE_MEASURED.json"), "rb") as f:
        assert f.read() == before


def test_quick_run_prints_one_line_with_the_jax_benchs_keys(tiny_bench, capsys):
    every, _ = jax_bench_keys()
    res = bench.main(["--quick", "--device", "cpu"])
    line = _line(capsys)
    assert line == res.line
    assert set(line) == every | {"power_limit_w", "quick"}
    assert line["device"] == "cpu" and line["power_limit_w"] is None and line["n_chips"] == 1
    assert line["batch"] == 4 and list(line["per_batch"]) == ["4"]
    assert line["value"] > 0 and line["train_steps_per_sec"] > 0
    per_img_step = flops.sampler_flops_per_img_step(bench.build("cpu")[0])
    want = per_img_step * bench.T * line["value"] / flops.H100_SXM_BF16_PEAK_FLOPS
    assert line["mfu"] == pytest.approx(want, rel=1e-12) and 0 < line["train_mfu"] < 1
    assert line["vs_reference_style_same_chip"] is None and line["vs_baseline"] is None
    # the CPU launches no kernel; the counts are read around the timed runs
    assert res.launches == {row: dict.fromkeys(launch_counts(), 0.0)
                            for row in ("sampler_b4", "train_step")}
    assert not (tiny_bench / "baseline.json").exists()  # quick mode writes nothing


def test_a_failed_row_costs_one_null_and_one_error(tiny_bench, capsys, monkeypatch):
    def boom(*args, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(bench, "bench_train_step", boom)
    bench.main(["--quick", "--device", "cpu"])
    line = _line(capsys)
    assert line["errors"] == {"train_step": "RuntimeError: boom"}
    assert line["train_steps_per_sec"] is None and line["train_mfu"] is None
    assert line["value"] > 0 and line["mfu"] > 0


def test_full_line_and_the_baseline_file(tiny_bench, capsys, monkeypatch):
    """Full mode with every timed row replaced by a fixed reading: the line
    has every key of the JAX bench's, the reference's CPU baselines are null
    with errors naming the missing checkout, and the same-card baseline is
    written to the bench's own file, which a quick run then reads."""
    def reading(rate, mfu=None):
        return bench.Reading(float(rate), mfu, dict.fromkeys(launch_counts(), 0.0))

    monkeypatch.setattr(bench, "bench_scan_sampler",
                        lambda m, d, b, flops_per_img_step=None, shape=None: reading(b, 0.5))
    monkeypatch.setattr(bench, "bench_train_step", lambda *a, **kw: reading(7, 0.25))
    monkeypatch.setattr(bench, "bench_classifier_train", lambda device: reading(11, 0.125))
    monkeypatch.setattr(bench, "bench_vae_train", lambda device: reading(13, 0.0625))
    monkeypatch.setattr(bench, "bench_latent_sampling", lambda device: reading(17))
    monkeypatch.setattr(bench, "_bench_scanned", lambda fn, reps, b, device: reading(reps * b))
    monkeypatch.setattr(bench, "bench_reference_style", lambda m, d, b: b / 8)
    missing = str(tiny_bench / "no_reference")
    bench.main(["--device", "cpu", "--reference", missing])
    line = _line(capsys)
    every, full = jax_bench_keys()
    assert set(line) == every | full | {"power_limit_w", "errors"}
    cpu_rows = {"baseline_torch_cpu_sampler", "baseline_torch_cpu_classifier",
                "baseline_torch_cpu_vae"}
    assert set(line["errors"]) == cpu_rows
    assert all(missing in e for e in line["errors"].values())
    assert line["batch"] == 256 and line["value"] == 256.0 and line["mfu"] == 0.5
    assert line["vs_baseline"] is None and line["vs_reference_style_same_chip"] == 8.0
    assert line["classifier_vs_reference_cpu"] is None
    assert line["vae_train_imgs_vs_reference_cpu"] is None
    nulls = {k for k, v in line.items() if v is None}
    assert nulls == {"vs_baseline", "classifier_vs_reference_cpu",
                     "vae_train_imgs_vs_reference_cpu", "power_limit_w"}  # the CPU has none
    assert line["ddim50_images_per_sec_per_chip"] == 4 * 256
    with open(tiny_bench / "baseline.json") as f:
        kept = json.load(f)
    assert kept["reference_style_images_per_sec_per_chip"] == 32.0
    assert kept["device"] == "cpu" and kept["power_limit_w"] is None
    assert "reference_torch_cpu_images_per_sec" not in kept

    bench.main(["--quick", "--device", "cpu"])
    line = _line(capsys)
    assert line["vs_reference_style_same_chip"] == 4 / 32  # B=4 at rate 4 over the file's 32


def test_no_card_fails_the_line_not_the_process(tiny_bench, capsys):
    """Asked for the card where there is none, the bench falls back to
    nothing: one line with the error and no reading."""
    res = bench.main(["--quick"])
    line = _line(capsys)
    assert set(line["errors"]) == {"fatal"} and "cuda" in line["errors"]["fatal"]
    assert line["value"] is None and res.launches == {}
