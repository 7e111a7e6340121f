"""The port's augmentation protocol (ldm_tpu_torch/experiments/augmentation.py
and ``python -m ldm_tpu_torch.main``): its helpers against the JAX
package's, exactly, and the whole protocol on the CPU at a tiny size for both
generator families, with the negative control, the checkpoint rerun and two
runs of one seed equal bit for bit."""

import dataclasses
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from ldm_tpu.data.datasets import Dataset as JaxDataset
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.diffusion.flow import RectifiedFlow as JaxFlow
from ldm_tpu.experiments import augmentation as jax_aug
from ldm_tpu_torch import main as port_main
from ldm_tpu_torch.config import config_from_dict
from ldm_tpu_torch.data.datasets import Dataset
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.experiments import augmentation as aug

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGETS = {"pixel": "ldm_tpu.diffusion.ddpm.GaussianDiffusion",
           "flow": "ldm_tpu.diffusion.flow.RectifiedFlow"}
TINY_CLASSIFIER = dict(n_blocks=(1, 1), n_channels=(8, 16))
KEYS = {"exp1", "exp2", "exp3", "exp4", "exp5"}


def raw_config(family, workdir):
    """A tiny protocol config: UNet channels 8, multipliers [1, 2], 8px
    grayscale synthetic data (320 samples: 144 generator-train images, 9
    steps of 16, and 16 validation images, one batch), T=10."""
    return {
        "project_name": f"tiny_{family}", "workdir": str(workdir), "batch_size": 16,
        "epochs": 1, "use_amp": False, "seed": 0, "sample_every": 0,
        "diffusion": {"target": TARGETS[family], "cfg_scale": 3, "params": {"n_steps": 10}},
        "model": {"params": {"in_channels": 1, "out_channels": 1, "channels": 8,
                             "channel_multipliers": [1, 2], "num_classes": 10}},
        "data": {"dataset": "SYNTHETIC", "image_size": 8, "image_channels": 1,
                 "synthetic_size": 320},
    }


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the protocol is thousands of small CPU ops, and
    test workers that share the cores, each with a full OpenMP team, slow
    each other down by orders of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(family, workdir, **kw):
    """The tiny protocol on the CPU: 3 images a class, the tiny classifier,
    the family's Phase C sampler at 4 steps (the flow's Heun; the pixel
    DDPM's ancestral loop runs its T=10 whatever the steps)."""
    cfg = config_from_dict(raw_config(family, workdir))
    return cfg, aug.run_augmentation_experiment(
        cfg, n_per_class=3, sample_batch=16, classifier_epochs=1, ddim_steps=4,
        classifier_arch=TINY_CLASSIFIER, device="cpu", **kw)


def test_experiments_and_mixes_are_the_jax_ones():
    assert aug.EXPERIMENTS == jax_aug.EXPERIMENTS
    rng = np.random.default_rng(0)
    real = (rng.integers(0, 256, (30, 4, 4, 1)).astype(np.uint8),
            rng.integers(0, 10, 30).astype(np.int32))
    synth = (rng.integers(0, 256, (20, 4, 4, 1)).astype(np.uint8),
             np.repeat(np.arange(10, dtype=np.int32), 2))
    for name, fr, fs in aug.EXPERIMENTS:
        seed = 7 + sum(ord(c) for c in name)
        got = aug._mix(Dataset(*real, list(range(10))), Dataset(*synth, list(range(10))),
                       fr, fs, seed)
        want = jax_aug._mix(JaxDataset(*real, list(range(10))),
                            JaxDataset(*synth, list(range(10))), fr, fs, seed)
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)
        assert aug._exp_seed(7, name) == seed


SAMPLER_ARGS = [(None, None), ("dpmpp", None), ("dpmpp", 7), ("ddim", None), ("ddpm", None),
                ("ddim", 12)]


@pytest.mark.parametrize("family", ["pixel", "flow"])
@pytest.mark.parametrize("sampler,steps", SAMPLER_ARGS)
def test_phase_c_defaults_and_the_break_are_the_jax_ones(family, sampler, steps):
    """Stand-in trainers that carry each package's process: the same Phase C
    sampler and steps, and the same broken-set arguments."""
    port = types.SimpleNamespace(diffusion=RectifiedFlow(10) if family == "flow"
                                 else GaussianDiffusion(10))
    jax_dt = types.SimpleNamespace(diffusion=JaxFlow(10) if family == "flow"
                                   else JaxDiffusion(10))
    got = aug.phase_c_sampler_default(port, sampler, steps)
    assert got == jax_aug.phase_c_sampler_default(jax_dt, sampler, steps)
    assert (aug.negative_control_break(port, 3.0, *got)
            == jax_aug.negative_control_break(jax_dt, 3.0, *got))


@pytest.mark.parametrize("family", ["pixel", "flow"])
def test_tiny_protocol_end_to_end(family, tmp_path):
    """The whole protocol with the negative control, then Phases C+ again
    from the Phase A checkpoint: the experiments' keys, the synthetic set's
    size, the FIDs, and the launches and seconds by phase."""
    cfg, res = run(family, tmp_path, negative_control=True)
    assert set(res.test_f1) == KEYS | {"exp2_broken"}
    assert all(0.0 <= v <= 1.0 for v in res.test_f1.values())
    assert res.synthetic_size == 30
    for v in (res.fid_pixel, res.fid_classifier, res.fid_pixel_broken,
              res.fid_classifier_broken):
        assert v is not None and np.isfinite(v) and v >= 0.0
    assert set(res.seconds) == {"A", "C", "C_broken", *KEYS, "exp2_broken"}
    assert isinstance(res.diffusion_trainer.diffusion,
                      RectifiedFlow if family == "flow" else GaussianDiffusion)
    assert res.classifier_trainer.state.step > 0

    ckpt = f"{cfg.checkpoints}/best_state.pt"
    assert os.path.exists(ckpt)
    _, again = run(family, tmp_path, diffusion_checkpoint=ckpt)
    assert set(again.test_f1) == KEYS and again.synthetic_size == 30
    assert again.diffusion_trainer.state.step == res.diffusion_trainer.state.step


@pytest.mark.parametrize("family", ["pixel", "flow"])
def test_one_seed_gives_the_same_results(family, tmp_path):
    """Two runs of one seed: every F1 and FID equal, bit for bit."""
    _, a = run(family, tmp_path / "a", negative_control=True)
    _, b = run(family, tmp_path / "b", negative_control=True)
    assert a.test_f1 == b.test_f1
    assert (a.fid_pixel, a.fid_classifier, a.fid_pixel_broken, a.fid_classifier_broken) == (
        b.fid_pixel, b.fid_classifier, b.fid_pixel_broken, b.fid_classifier_broken)


def test_generator_config_and_parallel_flags_raise(tmp_path, monkeypatch):
    """A generator config must be a latent one (the latent generator itself:
    tests/test_torch_port_latent.py).  The parallel flags reach the trainers
    (their runs: tests/test_torch_port_parallel.py and _multiprocess.py):
    ``--distributed`` without the environment raises, and ``--mesh`` with a
    model-axis placement raises: the diffusion trainer runs ``tp`` (at
    model = 1 it shards nothing), the classifier trains with replicated
    parameters alone."""
    import torch.distributed as dist

    cfg = config_from_dict(raw_config("pixel", tmp_path))
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw_config("pixel", tmp_path)))
    with pytest.raises(ValueError, match="must be a latent config"):
        aug.run_augmentation_experiment(cfg, generator_config=str(path), device="cpu")
    for var in ("LDM_TPU_COORDINATOR", "LDM_TPU_NUM_PROCESSES", "LDM_TPU_PROCESS_ID",
                "LDM_TPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="LDM_TPU_COORDINATOR"):
        port_main.main([str(path), "--device", "cpu", "--distributed"])
    tp = tmp_path / "tp.yaml"
    tp.write_text(yaml.safe_dump(dict(raw_config("pixel", tmp_path), param_sharding="tp")))
    try:
        with pytest.raises(ValueError, match="classifier trains data-parallel with replicated"):
            port_main.main([str(tp), "--device", "cpu", "--mesh"])
    finally:  # --mesh made a group of this process alone
        if dist.is_initialized():
            dist.destroy_process_group()


def test_main_module_prints_the_json(tmp_path):
    """``python -m ldm_tpu_torch.main <tiny.yaml> --device cpu`` (the
    flow family; the default classifier, ResNet-18) prints root main.py's
    JSON."""
    raw = raw_config("flow", tmp_path)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    r = subprocess.run([sys.executable, "-m", "ldm_tpu_torch.main", str(path), "--device",
                        "cpu", "--per-class", "2", "--classifier-epochs", "1",
                        "--ddim-steps", "2"], cwd=ROOT, capture_output=True, text=True,
                       timeout=600, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout[r.stdout.index("{\n"):])
    assert set(out) == {"test_f1", "synthetic_size", "fid_pixel", "fid_classifier"}
    assert set(out["test_f1"]) == KEYS and out["synthetic_size"] == 20


def test_result_json_adds_the_broken_fids():
    res = aug.AugmentationResult(test_f1={"exp1": 0.5}, synthetic_size=3, fid_pixel=1.0,
                                 fid_classifier=2.0)
    assert set(port_main.result_json(res)) == {"test_f1", "synthetic_size", "fid_pixel",
                                               "fid_classifier"}
    broken = dataclasses.replace(res, fid_pixel_broken=3.0, fid_classifier_broken=4.0)
    assert port_main.result_json(broken)["fid_classifier_broken"] == 4.0


def test_debug_nans_is_a_finite_check_of_the_epoch_loss(tmp_path):
    """``debug_nans`` raises on a NaN or infinite epoch loss; without it the
    value passes through."""
    from ldm_tpu_torch.utils.seed import check_finite

    cfg = config_from_dict(raw_config("pixel", tmp_path))
    on = dataclasses.replace(cfg, debug_nans=True)
    assert check_finite("loss", 0.5, on) == 0.5
    assert np.isnan(check_finite("loss", float("nan"), cfg))
    for bad in (float("nan"), float("inf")):
        with pytest.raises(FloatingPointError, match="debug_nans"):
            check_finite("loss", bad, on)
