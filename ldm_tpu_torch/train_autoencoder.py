"""VAE training entry point of the port (scripts/train_autoencoder.py).

config -> data loaders -> Autoencoder (the ``model:`` block) ->
AutoencoderTrainer -> train().

    python -m ldm_tpu_torch.train_autoencoder configs/autoencoder_hard.yaml \\
        [--epochs N] [--device cuda] [--eager] [--strict-data]

The weights start from a seeded random init (the config's seed).  Writes
``<workdir>/autoencoder/<project>/checkpoints/autoencoder.pt`` (the best
weights, what a latent config's ``ae_checkpoint`` names) and
``autoencoder_state.pt``, metrics and reconstruction grids.  On a CUDA
device (the default) the train step runs as a CUDA graph captured once and
replayed; ``--eager`` asks for the eager step.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.loader import create_dataloaders
from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.training.autoencoder_trainer import AutoencoderTrainer
from ldm_tpu_torch.utils.cli import add_runtime_args, runtime_setup
from ldm_tpu_torch.utils.seed import apply_runtime_flags, set_seed


class Run(NamedTuple):
    trainer: AutoencoderTrainer
    history: dict


def run(config: Config, device="cuda", strict_data: bool = False, eager: bool = False) -> Run:
    """Build the trainer for ``config`` on ``device`` and train ``config.epochs`` epochs."""
    device = torch.device(device)
    set_seed(config.seed)
    apply_runtime_flags(config)
    train_loader, val_loader, _test, _classes = create_dataloaders(
        config, allow_synthetic_fallback=not strict_data)
    with torch.random.fork_rng(devices=[]):  # seeded init, the caller's RNG untouched
        torch.manual_seed(config.seed)
        model = build_model(config)
    trainer = AutoencoderTrainer(config, model.to(device), train_loader, val_loader,
                                 device=device, graphs=False if eager else None)
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
