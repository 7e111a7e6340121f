"""The port's training plumbing: the batch noising against the JAX package's,
checkpoint round trips, the EarlyStopping twin against ldm_tpu's, and the
``python -m ldm_tpu_torch.train`` entry point on a tiny config (CPU)."""

import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.training.early_stopping import EarlyStopping as JaxEarlyStopping
from ldm_tpu_torch import train
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.training import checkpoint as ckpt
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.training.early_stopping import EarlyStopping

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = dict(in_channels=1, out_channels=1, channels=8, channel_multipliers=[1, 2],
             num_classes=10)


def tiny_config(workdir, **kw):
    return Config(project_name="tiny", workdir=str(workdir), batch_size=4, use_amp=False,
                  model=ModelConfig(params=MODEL), diffusion=DiffusionConfig(n_steps=10),
                  data=DataConfig(dataset="SYNTHETIC", image_size=8, image_channels=1), **kw)


def tiny_trainer(cfg):
    torch.manual_seed(0)
    return DiffusionTrainer(cfg, UNet(**MODEL), GaussianDiffusion(cfg.diffusion.n_steps),
                            None, None, list(range(10)), device="cpu")


def batch(seed):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, (4, 8, 8, 1)).astype(np.float32),
            "label": rng.integers(0, 10, 4).astype(np.int32)}


def test_noise_batch_matches_jax_with_the_same_draws():
    """x_t = sqrt(ab_t) x0 + sqrt(1 - ab_t) eps from the JAX draws of t, eps;
    and the port's own draws: t in [0, T), eps of x0's shape."""
    key = jax.random.key(3)
    x0 = np.random.default_rng(0).uniform(-1, 1, (5, 8, 8, 3)).astype(np.float32)
    eps, xt, t = JaxDiffusion(400).noise_batch(key, jnp.asarray(x0))
    port = GaussianDiffusion(400)
    e2, xt2, t2 = port.noise_batch(torch.from_numpy(x0), t=torch.from_numpy(np.array(t)),
                                   eps=torch.from_numpy(np.array(eps)))
    np.testing.assert_allclose(xt2.numpy(), np.asarray(xt), atol=1e-6)
    assert t2.dtype == torch.int64 and torch.equal(e2, torch.from_numpy(np.array(eps)))
    g = torch.Generator().manual_seed(1)
    e3, xt3, t3 = port.noise_batch(torch.from_numpy(x0), generator=g)
    assert e3.shape == x0.shape and t3.shape == (5,)
    assert int(t3.min()) >= 0 and int(t3.max()) < 400
    with pytest.raises(ValueError, match="generator"):
        port.noise_batch(torch.from_numpy(x0), t=t3)


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Save after two steps, restore into a fresh trainer: every tensor and
    the step are bitwise equal, and the next step from either is the same."""
    cfg = tiny_config(tmp_path)
    a = tiny_trainer(cfg)
    for s in range(2):
        a.train_step(batch(s))
    a.early_stopping(0.5, a.state)
    path = a.save_latest()
    assert ckpt.latest_checkpoint(cfg.checkpoints) == path

    b = tiny_trainer(cfg)
    assert b.resume_latest()
    assert b.state.step == a.state.step == 2
    assert b.early_stopping.val_loss_min == 0.5
    sa, sb = a.state.state_dict(), b.state.state_dict()
    for part in ("model", "ema"):
        for k, v in sa[part].items():
            assert torch.equal(v, sb[part][k]), (part, k)
    for pid, st in sa["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["optimizer"]["state"][pid][k]), (pid, k)

    ma, mb = a.train_step(batch(9)), b.train_step(batch(9))
    assert torch.equal(ma["loss"], mb["loss"])
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_checkpoint_write_is_atomic(tmp_path, monkeypatch):
    """A save that fails mid-write leaves the previous file whole."""
    path = str(tmp_path / "state.pt")
    ckpt.atomic_save({"step": 1}, path)

    def broken(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        ckpt.atomic_save({"step": 2}, path)
    assert ckpt.load_state(path) == {"step": 1}
    assert os.listdir(tmp_path) == ["state.pt"]


@pytest.mark.parametrize("min_delta_rel", [0.0, 0.05])
def test_early_stopping_twin_makes_the_jax_decisions(min_delta_rel):
    losses = [1.0, 0.9, 0.9, 0.88, 0.95, float("nan"), 0.5, 0.49, 0.49, 0.6, 0.7, 0.8]
    ours = EarlyStopping(patience=3, min_delta_rel=min_delta_rel, save_fn=lambda s: saved.append(s))
    theirs = JaxEarlyStopping(patience=3, min_delta_rel=min_delta_rel,
                              save_fn=lambda s: want_saved.append(s))
    saved, want_saved = [], []
    for i, v in enumerate(losses):
        ours(v, i)
        theirs(v, i)
        assert (ours.counter, ours.early_stop, ours.val_loss_min) == (
            theirs.counter, theirs.early_stop, theirs.val_loss_min), i
    assert saved == want_saved
    assert ours.early_stop


def test_train_entry_point_runs_two_epochs(tmp_path):
    """The training entry point on SYNTHETIC data: ``main(argv)`` trains two
    epochs (the loss falls; checkpoints, a sample grid and the metrics JSONL
    are written), then ``python -m ldm_tpu_torch.train --resume`` restores
    the step."""
    cfg = tmp_path / "tiny.yaml"
    cfg.write_text(f"""
project_name: tiny
workdir: {tmp_path / 'runs'}
batch_size: 16
epochs: 2
lr: 0.001
use_amp: False
sample_every: 1
diffusion:
  n_steps: 10
model:
  params: {json.dumps(MODEL)}
data:
  dataset: SYNTHETIC
  image_channels: 1
  image_size: 16
  synthetic_size: 80
""")
    argv = [str(cfg), "--device", "cpu"]
    res = train.main(argv)
    assert res.trainer.state.step == 8 and res.resumed_from is None
    run = tmp_path / "runs" / "pixel" / "tiny"
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    losses = [r_["diffusion_model train_loss"] for r_ in recs if "diffusion_model train_loss" in r_]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert losses[1] < losses[0]
    for f in ("state.pt", "best_state.pt", "diffusion_model.pt", "diffusion_model_ema.pt"):
        assert (run / "checkpoints" / f).is_file(), f
    grid = np.load(run / "results" / "sample_step1.npy")
    assert grid.dtype == np.uint8 and grid.ndim == 3
    assert json.loads((run / "summary.json").read_text())["diffusion_model train_loss.min"] == min(losses)

    env = dict(os.environ, LDM_TPU_NO_NATIVE="1", OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "ldm_tpu_torch.train", *argv, "--resume", "--epochs", "0"]
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "resumed from step 8" in r.stdout  # 2 epochs of int(0.9 * 80) // 16 = 4 steps
