"""The synthetic-data augmentation experiment (port of
ldm_tpu/experiments/augmentation.py, the protocol of the reference's main.py).

1. The train set is split 50/50, one half for the generator and one for the
   classifier, each half 90/10 into train and validation.
2. Phase A: the class-conditional generator (pixel DDPM or rectified flow;
   with ``generator_config`` the latent family, a DDPM over a frozen VAE's
   latents) trains on half 1, or its state is loaded (``diffusion_checkpoint``).
3. Phase C: a synthetic set of ``n_per_class`` images a class at CFG scale
   ``cfg_scale``, each family with its default sampler
   (:func:`phase_c_sampler_default`); pixel FID of it against the real half.
4. exp1-exp5: ONE ResNet trainer retrained from scratch on five real /
   synthetic mixes (:data:`EXPERIMENTS`), its padded epoch and captured step
   reused through ``reset`` / ``set_train_data``; the test F1 of each, and
   classifier FID from exp1's best model.
5. With ``negative_control``: a deliberately broken synthetic set
   (:func:`negative_control_break`), its FIDs, and exp2 retrained on it
   (``exp2_broken``), which a quality measure that can fail must score worse.

Randomness: the splits and mixes draw from ``np.random.default_rng`` with
the JAX package's seeds, so they are the JAX package's, bit for bit.  Phase
C's chunk ``i`` draws its x_T (and noise) from a ``torch.Generator`` seeded
from (seed, ``0x6E0 + i``), the port's stand-in for ``fold_in(state.key,
0x6E0 + i)``; the generator's and the classifier's steps draw as their
trainers do.  With one seed two runs give the same F1s and FIDs, bit for bit
(on a card with ``utils.seed.apply_runtime_flags``); they cannot equal the
JAX package's, whose draws torch cannot replay.

``result.seconds`` holds each phase's wall time, and ``result.launches`` the
kernel launches each phase made, by kernel (``utils.graphs.COUNTED``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.datasets import Dataset, get_dataset
from ldm_tpu_torch.data.loader import DataLoader, split_train_val
from ldm_tpu_torch.data.transforms import scale_to_minus_one_one
from ldm_tpu_torch.diffusion.flow import RectifiedFlow
from ldm_tpu_torch.factory import (
    build_classifier,
    build_diffusion,
    build_model,
    compute_dtype,
    load_config,
)
from ldm_tpu_torch.models.resnet import ResNetBase
from ldm_tpu_torch.ops.fid import fid_from_features, pixel_fid
from ldm_tpu_torch.models.latent import SD_SCALING
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.training.latent_trainer import (
    LatentDiffusionTrainer,
    build_ldm,
    load_autoencoder,
    resolve_latent_scaling,
)
from ldm_tpu_torch.training.resnet_trainer import ResNetTrainer
from ldm_tpu_torch.training.state import step_generator
from ldm_tpu_torch.utils.graphs import COUNTED
from ldm_tpu_torch.utils.images import save_images
from ldm_tpu_torch.utils.logging import MetricsLogger

# (name, fraction of the real half, fraction of the synthetic set)
EXPERIMENTS: List[Tuple[str, float, float]] = [
    ("exp1", 1.0, 0.0),
    ("exp2", 0.0, 1.0),
    ("exp3", 0.5, 0.5),
    ("exp4", 0.1, 0.9),
    ("exp5", 0.9, 0.1),
]
GENERATE_SALT = 0x6E0  # Phase C's chunk i: the JAX package's fold_in(key, 0x6E0 + i)


@dataclasses.dataclass
class AugmentationResult:
    test_f1: Dict[str, float]
    synthetic_size: int
    fid_pixel: Optional[float] = None
    fid_classifier: Optional[float] = None
    fid_pixel_broken: Optional[float] = None
    fid_classifier_broken: Optional[float] = None
    seconds: Dict[str, float] = dataclasses.field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = dataclasses.field(default_factory=dict)
    # the synthetic set and the trainers, for a caller that measures further
    synthetic: Optional[Dataset] = dataclasses.field(default=None, repr=False)
    diffusion_trainer: Optional[DiffusionTrainer] = dataclasses.field(default=None, repr=False)
    classifier_trainer: Optional[ResNetTrainer] = dataclasses.field(default=None, repr=False)


class _Phases:
    """Wall seconds and kernel launches by phase; the launches are the
    counts of the wrappers that count them, read around the phase."""

    def __init__(self, device: torch.device):
        self.device = device
        self.seconds: Dict[str, float] = {}
        self.launches: Dict[str, Dict[str, int]] = {}

    def run(self, name: str, fn, *args, **kw):
        before = [f.launches for f in COUNTED]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = {f.__name__: f.launches - n for f, n in zip(COUNTED, before)}
        return out


def _mix(real: Dataset, synth: Dataset, fr: float, fs: float, seed: int) -> Dataset:
    """The leading fractions of the (shuffled) real and synthetic sets,
    concatenated."""
    rng = np.random.default_rng(seed)
    parts_img, parts_lab = [], []
    if fr > 0:
        idx = rng.permutation(len(real))[: int(fr * len(real))]
        parts_img.append(real.images[idx])
        parts_lab.append(real.labels[idx])
    if fs > 0:
        idx = rng.permutation(len(synth))[: int(fs * len(synth))]
        parts_img.append(synth.images[idx])
        parts_lab.append(synth.labels[idx])
    return Dataset(np.concatenate(parts_img), np.concatenate(parts_lab), real.classes, "mix")


def protocol_splits(config: Config, strict_data: bool = False):
    """The protocol's data: the train set split 50/50 (generator half,
    classifier half), each half 90/10 into train and validation, and the test
    set; ``((diff_tr, diff_va), (clf_tr, clf_va), test)``."""
    d = config.data

    def dataset(train: bool) -> Dataset:
        return get_dataset(d.dataset, d.data_path, d.image_size, train=train,
                           debugging=config.debugging,
                           allow_synthetic_fallback=not strict_data,
                           synthetic_size=d.synthetic_size,
                           synthetic_variant=d.synthetic_variant)

    full, test = dataset(True), dataset(False)
    perm = np.random.default_rng(config.seed).permutation(len(full))
    half = len(full) // 2
    ds_diff = full.subset(perm[:half])
    ds_clf = full.subset(perm[half: 2 * half])
    return (split_train_val(ds_diff, 0.1, config.seed),
            split_train_val(ds_clf, 0.1, config.seed + 1), test)


def _exp_seed(seed: int, name: str) -> int:
    """A stable per-experiment seed (``hash`` varies across processes)."""
    return seed + sum(ord(c) for c in name)


def generate_synthetic_dataset(
    trainer: DiffusionTrainer,
    num_classes: int,
    n_per_class: int,
    batch_size: int = 128,
    cfg_scale: float = 3.0,
    save_dir: Optional[str] = None,
    classes: Optional[List[int]] = None,
    sampler: str = "ddpm",
    ddim_steps: int = 50,
    ode_direction: float = 1.0,
    decode_scale_override: float = 0.0,
) -> Dataset:
    """``n_per_class`` images a class with CFG, in chunks of ``batch_size``
    across classes: the tail chunk is padded to ``batch_size`` (label 0) and
    trimmed, so one captured sampler step serves every chunk."""
    classes = classes if classes is not None else list(range(num_classes))
    labels = np.repeat(np.asarray(classes, np.int32), n_per_class)
    images = np.empty((len(labels),) + tuple(trainer.output_image_shape), np.uint8)
    for i in range(0, len(labels), batch_size):
        chunk = labels[i: i + batch_size]
        pad = batch_size - len(chunk)
        y = np.concatenate([chunk, np.zeros((pad,), np.int32)]) if pad else chunk
        gen = step_generator(trainer.config.seed, GENERATE_SALT + i, trainer.device,
                             GENERATE_SALT)
        out = trainer.sample(y, cfg_scale=cfg_scale, generator=gen, method=sampler,
                             ddim_steps=ddim_steps, ode_direction=ode_direction,
                             decode_scale_override=decode_scale_override)
        images[i: i + len(chunk)] = out[: len(chunk)]
    ds = Dataset(images, labels, classes, "synthetic")
    if save_dir:
        for c in classes:
            idx = np.where(labels == c)[0]
            save_images([images[j] for j in idx],
                        [os.path.join(save_dir, str(c), f"sample_{k}.png")
                         for k in range(len(idx))])
    return ds


def phase_c_sampler_default(dt, sampler: Optional[str],
                            ddim_steps: Optional[int]) -> Tuple[str, int]:
    """Phase C's sampler and steps by family: a flow generates with Heun-25
    (the "dpmpp" slot; a named ``dpmpp`` without steps gets 25 too), every
    other family with the ancestral DDPM loop.  Explicit arguments win."""
    if isinstance(getattr(dt, "diffusion", None), RectifiedFlow):
        if sampler is None:
            sampler = "dpmpp"
        if sampler == "dpmpp" and ddim_steps is None:
            ddim_steps = 25
    elif sampler is None:
        sampler = "ddpm"
    return sampler, 50 if ddim_steps is None else ddim_steps


def negative_control_break(dt, cfg_scale: float, sampler: str, ddim_steps: int) -> dict:
    """The sampling arguments of the deliberately broken set, each family's
    own failure: the latent family decodes at Stable Diffusion's 0.18215
    instead of its calibrated scale; a flow integrates its ODE the wrong way
    (``ode_direction = -1``); both with the same sampler, steps and CFG
    otherwise.  The pixel DDPM samples unguided with 5 DDIM steps."""
    if isinstance(dt, LatentDiffusionTrainer):
        return dict(cfg_scale=cfg_scale, sampler=sampler, ddim_steps=ddim_steps,
                    decode_scale_override=SD_SCALING)
    if isinstance(getattr(dt, "diffusion", None), RectifiedFlow):
        return dict(cfg_scale=cfg_scale, sampler=sampler, ddim_steps=ddim_steps,
                    ode_direction=-1.0)
    return dict(cfg_scale=0.0, sampler="ddim", ddim_steps=5)


def run_augmentation_experiment(
    config: Config,
    n_per_class: Optional[int] = None,
    sample_batch: int = 128,
    save_png: bool = False,
    classifier_epochs: Optional[int] = None,
    classifier_arch: Optional[dict] = None,
    logger: Optional[MetricsLogger] = None,
    strict_data: bool = False,
    sampler: Optional[str] = None,
    ddim_steps: Optional[int] = None,
    negative_control: bool = False,
    diffusion_checkpoint: Optional[str] = None,
    generator_config: Optional[str] = None,
    device="cuda",
    graphs: Optional[bool] = None,
) -> AugmentationResult:
    """The protocol on ``device``; ``graphs`` goes to both trainers (None:
    replayed CUDA graphs on a card; False: the eager steps).
    ``generator_config``: a latent config whose family (its UNet, schedule,
    frozen VAE and training settings) takes Phases A and C, on the same
    generator half at this config's batch size."""
    device = torch.device(device)
    logger = logger or MetricsLogger(config.dirpath)
    config.create_dirs()
    d = config.data
    phases = _Phases(device)

    # ---- data: 50/50 split, then 90/10 train/val each ------------------------
    (diff_tr, diff_va), (clf_tr, clf_va), test = protocol_splits(config, strict_data)
    ds_diff_size = len(diff_tr) + len(diff_va)
    classes = test.classes
    num_classes = len(classes)
    test_loader = DataLoader(test, config.batch_size, shuffle=False, drop_last=False)

    # ---- Phase A: the generator --------------------------------------------
    diff_train_loader = DataLoader(diff_tr, config.batch_size, seed=config.seed)
    diff_val_loader = DataLoader(diff_va, config.batch_size, seed=config.seed + 1)
    gen_cfg = config if not generator_config else load_config(generator_config)
    if generator_config and gen_cfg.type != "latent":
        raise ValueError(f"generator_config must be a latent config, got type={gen_cfg.type!r}")
    with torch.random.fork_rng(devices=[]):  # seeded init, the caller's RNG untouched
        torch.manual_seed(gen_cfg.seed)
        model = build_model(gen_cfg).to(device)
    if generator_config:
        ae = load_autoencoder(gen_cfg, device)
        scaling = resolve_latent_scaling(gen_cfg, ae, diff_train_loader)
        dt = LatentDiffusionTrainer(
            gen_cfg, build_ldm(gen_cfg, model, ae, scaling, device), diff_train_loader,
            diff_val_loader, classes, device=device, logger=logger, graphs=graphs)
    else:
        dt = DiffusionTrainer(
            config, model, build_diffusion(config, device), diff_train_loader,
            diff_val_loader, classes, device=device, logger=logger, graphs=graphs)
    if diffusion_checkpoint:
        phases.run("A", dt.load_state, diffusion_checkpoint)
    else:
        phases.run("A", dt.train)

    # ---- Phase C: the synthetic set ----------------------------------------
    sampler, ddim_steps = phase_c_sampler_default(dt, sampler, ddim_steps)
    if n_per_class is None:
        n_per_class = max(1, ds_diff_size // num_classes)
    cfg_scale = config.diffusion.cfg_scale
    synth = phases.run(
        "C", generate_synthetic_dataset, dt, num_classes, n_per_class,
        batch_size=sample_batch, cfg_scale=cfg_scale,
        save_dir=os.path.join(config.results, "synthetic") if save_png else None,
        classes=classes, sampler=sampler, ddim_steps=ddim_steps)

    # ---- sample quality: pixel FID, synthetic vs the real half -------------
    n_fid = min(len(clf_tr), len(synth), 2048)
    # the synthetic set is class-ordered: a shuffled slice covers every class
    fid_rng = np.random.default_rng(config.seed + 0xF1D)
    synth_fid = synth.images[fid_rng.permutation(len(synth))[:n_fid]]
    real_fid = clf_tr.images[:n_fid]
    fid_pixel = pixel_fid(real_fid, synth_fid)
    logger.log({"fid_pixel_synth_vs_real": fid_pixel}, step=0)
    fid_classifier = None

    # ---- negative control: a broken sampler must score worse --------------
    fid_pixel_broken = fid_classifier_broken = None
    broken_fid = broken = None
    if negative_control:
        broken = phases.run(
            "C_broken", generate_synthetic_dataset, dt, num_classes, n_per_class,
            batch_size=sample_batch, classes=classes,
            **negative_control_break(dt, cfg_scale, sampler, ddim_steps))
        rng_b = np.random.default_rng(config.seed + 0xB40)
        n_fid_b = min(len(broken), n_fid)
        broken_fid = broken.images[rng_b.permutation(len(broken))[:n_fid_b]]
        fid_pixel_broken = pixel_fid(real_fid[:n_fid_b], broken_fid)
        logger.log({"fid_pixel_broken_vs_real": fid_pixel_broken}, step=0)

    # ---- exp1..exp5: the classifier on real / synthetic mixes --------------
    clf_cfg = dataclasses.replace(
        config, loss_fn="cross-entropy", epochs=classifier_epochs or config.epochs,
        project_name=config.project_name + "_classifier")
    mixes = {name: _mix(clf_tr, synth, fr, fs, seed=_exp_seed(config.seed, name))
             for name, fr, fs in EXPERIMENTS}
    pad_train_to = max(len(ds) for ds in mixes.values())
    if classifier_arch:
        clf = ResNetBase(img_channels=d.image_channels, out_channels=num_classes,
                         dtype=compute_dtype(clf_cfg), device=device, **classifier_arch)
    else:
        clf = build_classifier(clf_cfg, d.image_channels, num_classes, device=device)
    rt = ResNetTrainer(
        clf_cfg, clf, DataLoader(mixes["exp1"], config.batch_size, seed=config.seed),
        DataLoader(clf_va, config.batch_size, seed=config.seed + 1), classes,
        test_loader=test_loader, logger=logger, name="resnet_exp1",
        pad_train_to=pad_train_to, device=device, graphs=graphs)

    def experiment(name: str, train_ds: Dataset, seed: int) -> Dict[str, float]:
        rt.reset(seed=seed, name=f"resnet_{name}")
        rt.set_train_data(train_ds)
        rt.train()
        stats = rt.test()
        logger.log({f"{name} test_f1": stats["f1_micro"],
                    f"{name} test_f1_macro": stats["f1_macro"]}, step=0)
        return stats

    results: Dict[str, float] = {}
    for name, _, _ in EXPERIMENTS:
        results[name] = phases.run(name, experiment, name, mixes[name],
                                   _exp_seed(config.seed, name))["f1_micro"]
        if name == "exp1":
            # classifier FID: the 100%-real classifier's pooled embeddings
            f_real = rt.features(scale_to_minus_one_one(real_fid))
            f_fake = rt.features(scale_to_minus_one_one(synth_fid))
            fid_classifier = fid_from_features(f_real, f_fake)
            logger.log({"fid_classifier_synth_vs_real": fid_classifier}, step=0)
            if broken_fid is not None:
                f_broken = rt.features(scale_to_minus_one_one(broken_fid))
                fid_classifier_broken = fid_from_features(f_real[: len(f_broken)], f_broken)
                logger.log({"fid_classifier_broken_vs_real": fid_classifier_broken}, step=0)

    if negative_control and broken is not None and clf_cfg.scan_epochs:
        # the F1-level control: exp2 retrained on the broken set (same size,
        # same budget) must score clearly below exp2
        train_ds = broken if len(broken) <= pad_train_to else broken.subset(
            np.arange(pad_train_to))
        results["exp2_broken"] = phases.run(
            "exp2_broken", experiment, "exp2_broken", train_ds,
            config.seed + 0xB41)["f1_micro"]

    return AugmentationResult(
        test_f1=results, synthetic_size=len(synth), fid_pixel=fid_pixel,
        fid_classifier=fid_classifier, fid_pixel_broken=fid_pixel_broken,
        fid_classifier_broken=fid_classifier_broken, seconds=phases.seconds,
        launches=phases.launches, synthetic=synth, diffusion_trainer=dt,
        classifier_trainer=rt)
