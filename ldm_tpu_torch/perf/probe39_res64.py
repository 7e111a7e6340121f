"""Probe 39: the reference's resolution axis, 64x64 at T=400, end to end
(the port of the JAX package's perf/probe39_res64.py).

    python -m ldm_tpu_torch.perf.probe39_res64 [epochs] [--config PATH]
        [--n-fid 2048] [--device cuda|cpu] [--out probe39.json]

The reference's report compares three configurations: 32x32 at T=400,
64x64 at T=400, 32x32 at T=1000.  This runs the second with
configs/protocol_hard_64.yaml (protocol_hard.yaml at image_size 64, 25,000
synthetic images):

A. the flagship UNet trains on the hard synthetic set at 64x64 through
   ``DiffusionTrainer`` (train / validation split by a permutation from the
   config's seed), replayed CUDA graphs on a card;
B. the exp1 ResNet-18 classifier trains on real 64x64 hard data (8 epochs,
   a 5,000-image validation set) and its best state is loaded: the feature
   space of the classifier FID;
C. ``N_FID`` images are sampled at B=64, CFG 3, with the ancestral sampler
   (T=400) and with DDIM-50, each batch from a generator seeded from (777,
   the batch's index), as the JAX probe folds the batch index into key 777
   (torch cannot replay ``jax.random``: the images are not JAX's); img/s,
   pixel FID and classifier FID against 2,048 real images (seed 777).

The classifier's features are taken in chunks of 256, a short last chunk
padded with the first images, as the JAX probe takes them.  ``run`` takes
the sizes a caller cuts (the config's ``synthetic_size``, the epochs, the
classifier's epochs and validation set, ``n_fid``); the JSON has the JAX
probe's keys with the card in ``device``.  No number of the JAX probe's
JSON is carried over (its 32 px anchors are TPU readings of another probe).
Prints one line a sampler, with the card's name and power limit; writes JSON
only to ``--out``.  perf/probe39b_res64_resume.py runs phases B-C again
from a run directory this leaves.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.datasets import synthetic_dataset_hard
from ldm_tpu_torch.data.loader import DataLoader
from ldm_tpu_torch.data.transforms import scale_to_minus_one_one
from ldm_tpu_torch.factory import build_classifier, build_diffusion, build_model, load_config
from ldm_tpu_torch.ops.fid import fid_from_features, pixel_fid
from ldm_tpu_torch.perf.common import counting, device_tag
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.training.resnet_trainer import ResNetTrainer
from ldm_tpu_torch.training.state import step_generator
from ldm_tpu_torch.utils.seed import apply_runtime_flags

CONFIG = "configs/protocol_hard_64.yaml"
N_FID = 2048
B = 64  # the sampling batch: 64 px activations are 4x the 32 px protocol's
SIZE = 64
CLF_NAME = "resnet64_exp1"
CLF_EPOCHS = 8
CLF_VAL = 5000
CHUNK = 256
SEED = 777
CFG_SCALE = 3.0
SAMPLERS = [("ddpm400", "ddpm", {}), ("ddim50", "ddim", {"ddim_steps": 50})]


def splits(config: Config):
    """The hard set at 64 px and its (train, validation) split."""
    n_total = config.data.synthetic_size
    ds = synthetic_dataset_hard(n_total, SIZE, 3, seed=0)
    n_val = int(n_total * config.data.val_split)
    perm = np.random.default_rng(config.seed).permutation(n_total)
    return ds.subset(perm[n_val:]), ds.subset(perm[:n_val])


def diffusion_trainer(config: Config, device) -> DiffusionTrainer:
    """Phase A's trainer: the UNet from the config's seed, the split's loaders."""
    train_ds, val_ds = splits(config)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_model(config, device)
    return DiffusionTrainer(
        config, model, build_diffusion(config, device),
        DataLoader(train_ds, config.batch_size, seed=config.seed),
        DataLoader(val_ds, config.batch_size, seed=config.seed + 1),
        classes=list(range(10)), device=device)


def classifier_config(config: Config, epochs: int = CLF_EPOCHS) -> Config:
    return dataclasses.replace(config, loss_fn="cross-entropy", epochs=epochs,
                               project_name=config.project_name + "_classifier")


def classifier_trainer(config: Config, device, epochs: int = CLF_EPOCHS,
                       n_val: int = CLF_VAL) -> ResNetTrainer:
    """Phase B's trainer: exp1's ResNet-18 on the hard set (seed 1) with a
    held-out validation set (seed 2)."""
    clf_cfg = classifier_config(config, epochs)
    n_total = config.data.synthetic_size
    clf_ds = synthetic_dataset_hard(n_total, SIZE, 3, seed=1)
    clf_val = synthetic_dataset_hard(n_val, SIZE, 3, seed=2, train=False)
    return ResNetTrainer(
        clf_cfg, build_classifier(clf_cfg, 3, 10, device=device),
        DataLoader(clf_ds, clf_cfg.batch_size, seed=7),
        DataLoader(clf_val, clf_cfg.batch_size, seed=8),
        classes=list(range(10)), name=CLF_NAME, device=device)


@torch.no_grad()
def features(model, images_u8: np.ndarray, device, chunk: int = CHUNK) -> np.ndarray:
    """The classifier's pooled features of uint8 images, in chunks of
    ``chunk``; a short last chunk is padded with the first images (so every
    call has the chunk's shape) and the padding's rows are dropped."""
    model.eval()
    x = scale_to_minus_one_one(images_u8)
    outs = []
    for i in range(0, len(x), chunk):
        part = x[i: i + chunk]
        if len(part) < chunk:
            part = np.concatenate([part, x[: chunk - len(part)]])
        outs.append(model(torch.as_tensor(part).to(device), features=True).float().cpu().numpy())
    return np.concatenate(outs)[: len(x)]


def phase_c(trainer: DiffusionTrainer, clf_model, device, n_fid: int = N_FID, batch: int = B,
            warm: bool = False, log: Callable[[str], None] = print, tag: str = "") -> dict:
    """Phase C: ``n_fid`` images a sampler at ``batch``, CFG 3, from the EMA
    weights, batch i from the generator of (777, i); img/s, pixel FID and
    classifier FID against the real set of seed 777.  ``warm``: one batch
    from a generator of seed 0 first, outside the timing (probe 39b's
    warm-up).  Returns the rows, the images and the kernels' launches by
    sampler (the warm-up's included)."""
    real = synthetic_dataset_hard(n_fid, SIZE, 3, seed=SEED).images
    f_real = features(clf_model, real, device)
    classes = np.arange(batch, dtype=np.int32) % 10
    rows, images, launches = {}, {}, {}
    for name, method, kw in SAMPLERS:
        imgs = []
        with counting(launches, f"C_{name}"):
            if warm:
                trainer.sample(classes, cfg_scale=CFG_SCALE, method=method,
                               generator=torch.Generator(device=device).manual_seed(0), **kw)
            t0 = time.perf_counter()
            for i in range(n_fid // batch):
                imgs.append(trainer.sample(classes, cfg_scale=CFG_SCALE, method=method,
                                           generator=step_generator(SEED, i, device), **kw))
            dt = time.perf_counter() - t0  # sample() returns host arrays: the wait is in it
        imgs = np.concatenate(imgs)
        rows[name] = {"img_per_sec": len(imgs) / dt,
                      "fid_pixel": float(pixel_fid(real, imgs)),
                      "fid_classifier": float(fid_from_features(
                          f_real, features(clf_model, imgs, device)))}
        images[name] = imgs
        log(f"probe39 {name} 64px B={batch} CFG {CFG_SCALE:g}: {rows[name]} [{tag}]")
    return {"rows": rows, "images": images, "launches": launches}


def run(config: Config, epochs: Optional[int] = None, n_fid: int = N_FID,
        clf_epochs: int = CLF_EPOCHS, clf_val: int = CLF_VAL, device="cuda",
        batch: int = B, log: Callable[[str], None] = print, tag: str = "") -> dict:
    """Phases A-C on ``config`` (``epochs`` overrides its epoch count); the
    JAX probe's JSON with the kernels' launches by phase (``launches``),
    plus ``images`` (Phase C's, by sampler) and the trainers under
    ``trainer`` and ``classifier_trainer``."""
    device = torch.device(device)
    if epochs is not None:
        config = dataclasses.replace(config, epochs=epochs)
    trainer = diffusion_trainer(config, device)
    log(f"probe39 training the 64x64 UNet: {len(trainer.train_loader.dataset)} images, "
        f"{config.epochs} epochs at most [{tag}]")
    launches = {}
    t0 = time.perf_counter()
    with counting(launches, "A"):
        hist = trainer.train()
    train_s = time.perf_counter() - t0
    steps = int(trainer.state.step)
    log(f"probe39 trained: {steps} steps in {train_s:.1f} s ({steps / train_s:.2f} steps/s), "
        f"val {hist['val_loss'][-1]:.5f} [{tag}]")

    clf = classifier_trainer(config, device, clf_epochs, clf_val)
    with counting(launches, "B"):
        clf_hist = clf.train()
    clf.load_best()

    out = {"device": tag or str(device), "n": n_fid, "image_size": SIZE,
           "t": config.diffusion.n_steps,
           "train": {"steps": steps, "seconds": train_s, "steps_per_sec": steps / train_s,
                     "epochs_run": len(hist["val_loss"]),
                     "final_val_loss": hist["val_loss"][-1]},
           "classifier": classifier_summary(clf_hist, clf_epochs)}
    c = phase_c(trainer, clf.model, device, n_fid, batch, log=log, tag=tag)
    out.update(c["rows"])
    out["launches"] = launches | c["launches"]
    out["images"] = c["images"]
    out["trainer"], out["classifier_trainer"] = trainer, clf
    return out


def classifier_summary(hist: dict, epochs: int) -> dict:
    """The classifier's row: its name and epochs, the best validation F1 and
    loss of its run."""
    valid = hist["valid"]
    return {"name": CLF_NAME, "epochs": epochs, "epochs_run": len(valid),
            "best_valid_f1": max(v["f1_micro"] for v in valid),
            "best_valid_loss": min(v["loss"] for v in valid)}


def json_rows(out: dict) -> dict:
    """``out`` without the images and trainers: what ``--out`` holds."""
    return {k: v for k, v in out.items()
            if k not in ("images", "trainer", "classifier_trainer")}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("epochs", nargs="?", type=int, help="override the config's epochs")
    ap.add_argument("--config", default=CONFIG)
    ap.add_argument("--n-fid", type=int, default=N_FID)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write the result here as JSON")
    a = ap.parse_args(argv)
    tag = device_tag(a.device)
    config = load_config(a.config)
    apply_runtime_flags(config)  # cuDNN's deterministic algorithms, as the entry points
    out = json_rows(run(config, a.epochs, a.n_fid, device=a.device, tag=tag))
    print(json.dumps(out))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
