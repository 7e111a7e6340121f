"""Training entry point of the port (scripts/train_diffusion_model.py).

config -> data loaders -> UNet + diffusion -> DiffusionTrainer -> train().

    python -m ldm_tpu_torch.train configs/pixel_diffusion_model_cifar10.yaml \\
        [--epochs N] [--resume] [--device cuda | --cpu] [--wandb] [--strict-data] \\
        [--eager] [--mesh | --distributed] [--profile DIR]

Data parallel on a machine with several cards (one process a card, over
NCCL; ``param_sharding: fsdp`` in the config for ZeRO-3):

    torchrun --nproc-per-node 4 -m ldm_tpu_torch.train <config> --distributed
    # (torchrun sets RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_RANK;
    #  LDM_TPU_DISTRIBUTED=1 tells the port to read them)

or with ``LDM_TPU_COORDINATOR=host:port LDM_TPU_NUM_PROCESSES=P
LDM_TPU_PROCESS_ID=r`` set for each process.  ``--mesh`` without any of these
is a group of one process.  The config's ``batch_size`` is the global batch.

On a CUDA device the train step (everything after the step's random draws)
and the sample grid's sampler steps run as CUDA graphs captured once and
replayed; ``--eager`` asks for the steps that launch every kernel from
Python (the only ones on the CPU).

``--profile DIR`` records the training run (``trainer.train()``) with
``torch.profiler`` (the host's operators, and the card's kernels when there
is one) and writes its Chrome trace under DIR (``utils/profiling.py``).

Data come from ``ldm_tpu_torch.data`` (the JAX package's numpy readers and
loaders, resized without JAX): when the dataset's files are not under the
config's ``data_path`` they fall back to seeded synthetic images at the
config's shape, unless ``--strict-data``.
The UNet's initial weights are a seeded random init (the config's seed).
Metrics go to ``<workdir>/<type>/<project>/metrics.jsonl`` (and, with
``--wandb``, to wandb), checkpoints to its ``checkpoints/`` and sample grids
to its ``results/``.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.loader import create_dataloaders
from ldm_tpu_torch.factory import build_diffusion, build_model, load_config
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.utils.cli import add_runtime_args, runtime_setup
from ldm_tpu_torch.utils.profiling import trace


class Run(NamedTuple):
    trainer: DiffusionTrainer
    history: dict
    resumed_from: Optional[int]  # the step a --resume run restored, else None


def build_trainer(config: Config, device, strict_data: bool = False,
                  eager: bool = False, mesh=None, logger=None) -> DiffusionTrainer:
    train_loader, val_loader, _test_loader, classes = create_dataloaders(
        config, allow_synthetic_fallback=not strict_data
    )
    with torch.random.fork_rng(devices=[]):  # seeded init, caller's RNG untouched
        torch.manual_seed(config.seed)
        model = build_model(config)
    model.to(device)
    return DiffusionTrainer(config, model, build_diffusion(config, device),
                            train_loader, val_loader, classes, device=device,
                            logger=logger, graphs=False if eager else None, mesh=mesh)


def run(config: Config, device="cuda", resume: bool = False,
        strict_data: bool = False, eager: bool = False, mesh=None,
        profile: Optional[str] = None, logger=None) -> Run:
    """Build the trainer for ``config`` on ``device``, resume from the latest
    checkpoint if asked and one exists, and train ``config.epochs`` epochs;
    ``eager``: without CUDA graphs; ``mesh``: data parallel over it;
    ``profile``: a directory for the training's trace; ``logger``: the
    trainer's ``MetricsLogger`` (default: the run directory's)."""
    device = torch.device(device)
    trainer = build_trainer(config, device, strict_data, eager, mesh, logger)
    resumed = None
    if resume and trainer.resume_latest():
        resumed = trainer.state.step
        print(f"resumed from step {resumed}")
    with trace(profile):
        history = trainer.train()
    return Run(trainer, history, resumed)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the config's epoch count")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest full-state checkpoint")
    add_runtime_args(ap)
    ap.add_argument("--eager", action="store_true",
                    help="launch every kernel from Python instead of replaying CUDA graphs")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the training under DIR")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    args = parse_args(argv)
    config = load_config(args.config)
    if args.epochs is not None:
        config = dataclasses.replace(config, epochs=args.epochs)
    device, mesh, logger = runtime_setup(args, config)
    return run(config, device, resume=args.resume, strict_data=args.strict_data,
               eager=args.eager, mesh=mesh, profile=args.profile, logger=logger)


if __name__ == "__main__":
    main()
