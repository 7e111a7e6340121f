"""Consistency-distillation entry point of the port (scripts/distill_consistency.py).

config -> data loaders -> teacher UNet (weights from a checkpoint) ->
ConsistencyDistillTrainer -> train() -> a per-class sample grid from the EMA
student.

    python -m ldm_tpu_torch.distill configs/protocol_hard.yaml \\
        [--teacher-checkpoint <checkpoints>/diffusion_model_ema.pt] \\
        [--epochs 24] [--skip 20] [--ema-decay 0.99] [--lr 2e-4] \\
        [--huber-c 0.03] [--sample-steps 2] [--cfg-scale S] \\
        [--device cuda | --cpu] [--wandb] [--eager] [--strict-data]

The defaults are the JAX script's recipe (24 epochs, target EMA 0.99, skip
20, lr 2e-4); ``--epochs 0`` and ``--lr 0`` take the config's.  The teacher
is a UNet state_dict (``python -m ldm_tpu_torch.train`` writes
``diffusion_model_ema.pt``), loaded strictly.  Writes
``consistency_model{,_ema}.pt`` beside it and
``<results>/consistency_<k>step_grid_step0.npy`` (PNG too when PIL is
present).
On a CUDA device (the default) the distillation step and the sampler step
run as CUDA graphs captured once and replayed; ``--eager`` asks for the
steps that launch every kernel from Python.
"""

from __future__ import annotations

import argparse
import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.data.loader import create_dataloaders
from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.factory import build_diffusion, build_model, load_config
from ldm_tpu_torch.training.consistency_trainer import ConsistencyDistillTrainer
from ldm_tpu_torch.utils.cli import add_runtime_args, runtime_setup
from ldm_tpu_torch.utils.seed import apply_runtime_flags, set_seed

PER_CLASS = 8  # images a class in the final grid


class Distilled(NamedTuple):
    trainer: ConsistencyDistillTrainer
    result: dict
    grid: str  # the sample grid's .npy


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--teacher-checkpoint", default=None,
                    help="teacher UNet state_dict (default: <checkpoints>/"
                         "diffusion_model_ema.pt)")
    ap.add_argument("--epochs", type=int, default=24, help="0: the config's")
    ap.add_argument("--skip", type=int, default=20, help="boundary spacing along the ODE")
    ap.add_argument("--ema-decay", type=float, default=0.99, help="target-network EMA")
    ap.add_argument("--cfg-scale", type=float, default=None,
                    help="guidance distilled in (default: the config's)")
    ap.add_argument("--lr", type=float, default=2e-4, help="0: the config's")
    ap.add_argument("--huber-c", type=float, default=0.03)
    ap.add_argument("--sample-steps", type=int, default=2,
                    help="consistency steps of the final sample grid")
    ap.add_argument("--eager", action="store_true",
                    help="launch every kernel from Python instead of replaying CUDA graphs")
    add_runtime_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Distilled:
    args = parse_args(argv)
    config = load_config(args.config)
    device, mesh, logger = runtime_setup(args, config)
    set_seed(config.seed)
    apply_runtime_flags(config)
    train_loader, _val, _test, classes = create_dataloaders(
        config, allow_synthetic_fallback=not args.strict_data)

    teacher_path = args.teacher_checkpoint or os.path.join(config.checkpoints,
                                                           "diffusion_model_ema.pt")
    if not os.path.exists(teacher_path):
        raise FileNotFoundError(f"teacher checkpoint not found: {teacher_path} "
                                "(train first, or pass --teacher-checkpoint)")
    teacher = build_model(config)
    teacher.load_state_dict(torch.load(teacher_path, map_location="cpu", weights_only=True),
                            strict=True)
    print(f"teacher: {teacher_path}", flush=True)

    trainer = ConsistencyDistillTrainer(
        config, teacher.to(device), build_diffusion(config, device), train_loader, classes,
        device=device, logger=logger, skip_steps=args.skip, cfg_scale=args.cfg_scale,
        ema_decay=args.ema_decay, huber_c=args.huber_c, lr=args.lr or None,
        graphs=False if args.eager else None, mesh=mesh)
    result = trainer.train(args.epochs or None)
    print(f"final distill loss: {result['loss']:.5f}", flush=True)

    ids = np.repeat(np.arange(len(classes)), PER_CLASS)
    x0 = trainer.sample(ids, n_sample_steps=args.sample_steps)
    images = reverse_transform(x0.cpu().numpy())
    grid = trainer.logger.log_images(images, step=0,
                                     mode=f"consistency_{args.sample_steps}step_grid",
                                     dirpath=config.results)
    print(f"sample grid: {grid}", flush=True)
    return Distilled(trainer, result, grid)


if __name__ == "__main__":
    main()
