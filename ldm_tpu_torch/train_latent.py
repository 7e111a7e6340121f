"""Latent diffusion entry point of the port (scripts/train_latent_diffusion.py).

config -> frozen VAE (the ``autoencoder:`` block and ``ae_checkpoint``) ->
data loaders -> latent scaling (``auto``: calibrated on the training data) ->
LatentDiffusionModel (the ``model:`` block is the latent UNet) ->
LatentDiffusionTrainer -> train().

    python -m ldm_tpu_torch.train_latent configs/latent_diffusion_hard.yaml \\
        [--epochs N] [--device cuda] [--eager] [--strict-data]

``ae_checkpoint`` is the ``autoencoder.pt`` that ``python -m
ldm_tpu_torch.train_autoencoder`` writes; where it names a ``.msgpack`` (the
JAX package's file) the ``.pt`` of the same stem is read, the port having
no flax reader; empty, the first stage is a seeded random init.  The
resolved scaling factor goes to ``<checkpoints>/latent_scaling.json``.  On
a CUDA device (the default) the train step (the VAE's encode included) and
the sampler step run as CUDA graphs captured once and replayed.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.loader import create_dataloaders
from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.training.latent_trainer import (
    LatentDiffusionTrainer,
    build_ldm,
    load_autoencoder,
    resolve_latent_scaling,
)
from ldm_tpu_torch.utils.cli import add_runtime_args, runtime_setup
from ldm_tpu_torch.utils.seed import apply_runtime_flags, set_seed


class Run(NamedTuple):
    trainer: LatentDiffusionTrainer
    history: dict


def build_trainer(config: Config, device, strict_data: bool = False,
                  eager: bool = False) -> LatentDiffusionTrainer:
    device = torch.device(device)
    ae = load_autoencoder(config, device)
    train_loader, val_loader, _test, classes = create_dataloaders(
        config, allow_synthetic_fallback=not strict_data)
    scaling = resolve_latent_scaling(config, ae, train_loader)
    if config.diffusion.latent_scaling_factor == "auto":
        print(f"calibrated latent_scaling_factor = {scaling:.5f} (1/std of latents)")
    with torch.random.fork_rng(devices=[]):  # seeded init, the caller's RNG untouched
        torch.manual_seed(config.seed)
        unet = build_model(config)
    ldm = build_ldm(config, unet.to(device), ae, scaling, device)
    return LatentDiffusionTrainer(config, ldm, train_loader, val_loader, classes,
                                  device=device, graphs=False if eager else None)


def run(config: Config, device="cuda", strict_data: bool = False, eager: bool = False) -> Run:
    """Build the trainer for ``config`` on ``device`` and train ``config.epochs`` epochs."""
    set_seed(config.seed)
    apply_runtime_flags(config)
    trainer = build_trainer(config, device, strict_data, eager)
    return Run(trainer, trainer.train())


def main(argv: Optional[Sequence[str]] = None) -> Run:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--epochs", type=int, default=None, help="override the config's epoch count")
    ap.add_argument("--eager", action="store_true",
                    help="launch every kernel from Python instead of replaying CUDA graphs")
    add_runtime_args(ap)
    args = ap.parse_args(argv)
    device = runtime_setup(args)
    config = load_config(args.config)
    if args.epochs is not None:
        config = dataclasses.replace(config, epochs=args.epochs)
    return run(config, device, strict_data=args.strict_data, eager=args.eager)


if __name__ == "__main__":
    main()
