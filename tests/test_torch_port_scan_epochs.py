"""The port's device-resident epoch (``ldm_tpu_torch/training/scan_epochs.py``)
on the CPU: its scaling table against the JAX package's two expressions,
the epoch against the per-batch loop fed the same order (bit for bit), the
fall-back rule of ``build_epoch_scan`` and the shuffle stream of a resumed run.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ldm_tpu.data import transforms as jax_transforms
from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu_torch.data.datasets import synthetic_dataset
from ldm_tpu_torch.data.loader import DataLoader
from ldm_tpu_torch.data.transforms import scale_to_minus_one_one, scale_to_zero_one
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.training.scan_epochs import EpochScan, build_epoch_scan, scale_table

MODEL = dict(in_channels=1, out_channels=1, channels=8, channel_multipliers=[1, 2],
             num_classes=10)
B = 8


def test_scale_table_equals_both_jax_expressions():
    """The 256 entries bit for bit: the JAX loader's transform and the JAX
    scan's on-device expression (scan_epochs.py:95)."""
    values = np.arange(256, dtype=np.uint8)
    table = scale_table()
    assert table.dtype == np.float32 and table.shape == (256,)
    np.testing.assert_array_equal(table, jax_transforms.scale_to_minus_one_one(values))
    on_device = jnp.asarray(values).astype(jnp.float32) / 255.0 * 2.0 - 1.0
    np.testing.assert_array_equal(table, np.asarray(on_device))


def test_next_batch_equals_the_host_gather():
    ds = synthetic_dataset(40, 16, 3)
    scan = EpochScan(ds.images, ds.labels, B, "cpu")
    scan.start_epoch(seed=3, epoch=2)
    order = scan.permutation(3, 2)
    assert sorted(order.reshape(-1).tolist()) == sorted(set(order.reshape(-1).tolist()))
    for row in order:
        scan.take()
        x, y = scan.next_batch()
        np.testing.assert_array_equal(x.numpy(), scale_to_minus_one_one(ds.images[row]))
        np.testing.assert_array_equal(y.numpy(), ds.labels[row])
    with pytest.raises(RuntimeError, match="start_epoch"):
        scan.take()
    assert not np.array_equal(scan.permutation(3, 2), scan.permutation(3, 3))


def config(tmp_path, **kw):
    return Config(project_name="scan", workdir=str(tmp_path), batch_size=B, use_amp=False,
                  model=ModelConfig(params=MODEL), diffusion=DiffusionConfig(n_steps=10),
                  data=DataConfig(dataset="SYNTHETIC", image_size=16, image_channels=1), **kw)


DATA = synthetic_dataset(32, 16, 1)  # 4 batches an epoch


def trainer(cfg, loader):
    torch.manual_seed(0)
    return DiffusionTrainer(cfg, UNet(**MODEL), GaussianDiffusion(10), loader, None,
                            list(range(10)), device="cpu")


class OrderedBatches:
    """The per-batch loop's input: the scan's order, gathered on the host
    as the loader gathers (not an in-memory loader: the trainer keeps its
    per-batch loop for it)."""

    def __init__(self, scan: EpochScan, seed: int, state):
        self.scan, self.seed, self.state = scan, seed, state

    def __iter__(self):
        epoch = self.state.step // self.scan.n_batches
        for row in self.scan.permutation(self.seed, epoch):
            yield {"image": scale_to_minus_one_one(DATA.images[row]),
                   "label": DATA.labels[row].astype(np.int32)}


def assert_same_state(a: DiffusionTrainer, b: DiffusionTrainer):
    assert a.state.step == b.state.step
    for part in ("model", "ema"):
        sa, sb = getattr(a.state, part).state_dict(), getattr(b.state, part).state_dict()
        for k, v in sa.items():
            assert torch.equal(v, sb[k]), (part, k)


def test_epoch_equals_the_per_batch_loop_bit_for_bit(tmp_path):
    """Two epochs of a tiny UNet: the device-resident epoch and the
    per-batch loop fed the same order give the same losses and weights."""
    cfg = config(tmp_path)
    scanned = trainer(cfg, DataLoader(DATA, B, seed=cfg.seed))
    scan = scanned.epoch_scan
    assert scan is not None and scan.n_batches == 4
    looped = trainer(dataclasses.replace(cfg, scan_epochs=False), None)
    looped.train_loader = OrderedBatches(scan, cfg.seed, looped.state)
    assert looped.epoch_scan is None
    for epoch in range(2):
        loss_scan, loss_loop = scanned._train_epoch(), looped._train_epoch()
        assert loss_scan == loss_loop, epoch
        assert scanned._last_grad_norm == looped._last_grad_norm
        assert_same_state(scanned, looped)
    assert scanned.state.step == 8
    assert scanned.step_counts == looped.step_counts == {"graphed": 0, "eager": 8}


def test_resumed_run_draws_the_same_next_permutation(tmp_path):
    """A run resumed after epoch 1 shuffles epoch 2 as the uninterrupted
    run does, and ends with the same weights."""
    cfg = config(tmp_path)
    straight = trainer(cfg, DataLoader(DATA, B, seed=cfg.seed))
    straight._train_epoch()
    straight.save_latest()
    straight._train_epoch()
    resumed = trainer(cfg, DataLoader(DATA, B, seed=cfg.seed))
    assert resumed.resume_latest() and resumed.state.step == 4
    resumed._train_epoch()
    assert torch.equal(resumed.epoch_scan.idx, straight.epoch_scan.idx)
    assert torch.equal(straight.epoch_scan.idx,
                       torch.from_numpy(straight.epoch_scan.permutation(cfg.seed, 1)))
    assert_same_state(straight, resumed)


@pytest.mark.parametrize("case", ["disabled", "no_loader", "no_dataset", "transform",
                                  "no_drop_last", "no_full_batch"])
def test_build_epoch_scan_falls_back(case):
    loader = DataLoader(DATA, B)
    enabled = True
    if case == "disabled":
        enabled = False
    elif case == "no_loader":
        loader = None
    elif case == "no_dataset":
        loader = OrderedBatches(None, 0, None)
    elif case == "transform":
        loader = DataLoader(DATA, B, transform=scale_to_zero_one)
    elif case == "no_drop_last":
        loader = DataLoader(DATA, B, drop_last=False)
    else:
        loader = DataLoader(DATA.subset(np.arange(B - 1)), B)
    assert build_epoch_scan(loader, "cpu", enabled=enabled) is None
    standard = build_epoch_scan(DataLoader(DATA, B), "cpu")
    assert isinstance(standard, EpochScan) and standard.n_batches == 4
