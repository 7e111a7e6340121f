"""Classifier training entry point of the port
(scripts/train_resnet_classifier.py), with the optional pretraining pass on
an image tree.

config -> data loaders -> ResNet-18 (``factory.build_classifier``) ->
ResNetTrainer -> [pretrain on ``--pretrain-dir``] -> train() -> test().

    python -m ldm_tpu_torch.train_classifier configs/pixel_diffusion_model_cifar10.yaml \\
        [--pretrain-dir DIR] [--device cuda | --cpu] [--wandb] [--strict-data] \\
        [--mesh | --distributed]

``--pretrain-dir`` names a class-per-subdirectory image tree (torchvision's
ImageFolder layout), as ``python -m ldm_tpu_torch.generate`` writes it
under a config's ``results/``: one pass of training over it, in batches of
the config's ``batch_size`` shuffled from the config's seed, before the
epochs on the dataset (grayscale when the config's images have one
channel).  A config whose ``loss_fn`` is ``mse`` (the diffusion configs')
trains with cross-entropy.  The best weights by validation loss go to
``<checkpoints>/resnet.pt``; the last line printed is the test pass's
micro and macro F1 and loss with them.  On a CUDA device (the default) the
train step runs as a CUDA graph captured once and replayed.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple, Optional, Sequence

import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.loader import DataLoader, create_dataloaders
from ldm_tpu_torch.factory import build_classifier, load_config
from ldm_tpu_torch.training.resnet_trainer import ResNetTrainer
from ldm_tpu_torch.utils.cli import add_runtime_args, runtime_setup
from ldm_tpu_torch.utils.images import load_image_folder
from ldm_tpu_torch.utils.seed import apply_runtime_flags, set_seed


class Run(NamedTuple):
    trainer: ResNetTrainer
    pretrain: Optional[dict]  # the pretraining pass's stats, None without --pretrain-dir
    history: dict
    test: dict
    seconds: dict  # wall seconds of "pretrain" (0 without), "train" and "test", host clock


def run(config: Config, device="cuda", pretrain_dir: Optional[str] = None,
        strict_data: bool = False, mesh=None, logger=None) -> Run:
    """Build the classifier and its trainer for ``config`` on ``device``,
    pretrain on the image tree ``pretrain_dir`` if given, train
    ``config.epochs`` epochs and test the best weights (``mesh``: data
    parallel over it; ``logger``: the trainer's ``MetricsLogger``)."""
    if config.loss_fn == "mse":
        config = dataclasses.replace(config, loss_fn="cross-entropy")
    device = torch.device(device)
    set_seed(config.seed)
    apply_runtime_flags(config)
    train_loader, val_loader, test_loader, classes = create_dataloaders(
        config, allow_synthetic_fallback=not strict_data)
    model = build_classifier(config, config.data.image_channels, len(classes), device)
    trainer = ResNetTrainer(config, model, train_loader, val_loader, classes,
                            test_loader=test_loader, logger=logger, device=device, mesh=mesh)
    pretrain, t0 = None, time.perf_counter()
    if pretrain_dir:
        pre = load_image_folder(pretrain_dir, config.data.image_size,
                                grayscale=config.data.image_channels == 1)
        pretrain = trainer.run("pretrain", DataLoader(pre, config.batch_size, seed=config.seed))
    t1 = time.perf_counter()
    history = trainer.train()
    t2 = time.perf_counter()
    stats = trainer.test()
    seconds = {"pretrain": t1 - t0, "train": t2 - t1, "test": time.perf_counter() - t2}
    print(f"test F1 (micro): {stats['f1_micro']:.4f}  "
          f"(macro): {stats['f1_macro']:.4f}  loss: {stats['loss']:.4f}")
    return Run(trainer, pretrain, history, stats, seconds)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--pretrain-dir", default=None,
                    help="class-per-subdirectory image tree to pretrain on")
    add_runtime_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Run:
    args = parse_args(argv)
    config = load_config(args.config)
    device, mesh, logger = runtime_setup(args, config)
    return run(config, device, pretrain_dir=args.pretrain_dir,
               strict_data=args.strict_data, mesh=mesh, logger=logger)


if __name__ == "__main__":
    main()
