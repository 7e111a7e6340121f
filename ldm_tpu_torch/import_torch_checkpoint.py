"""Migrate a reference torch checkpoint (.pt) into the port (the twin of
scripts/import_torch_checkpoint.py).

The reference's only checkpoint format is ``torch.save(model.state_dict())``.
This entry point loads such a file, checks it against the model the config
builds (every missing key, extra key and shape mismatch named in one error;
``utils/torch_import.py``), loads it strictly and writes the port's
weight file where the rest of the port reads it:

* UNet        -> <checkpoints>/diffusion_model.pt (+ diffusion_model_ema.pt:
                 the reference has no EMA, so the imported weights seed it)
* Autoencoder -> <checkpoints>/autoencoder.pt
* ResNetBase  -> <checkpoints>/classifier.pt

so ``python -m ldm_tpu_torch.generate <config>`` samples from a
reference-trained model with no further step, and ``serve``, ``distill``
and ``train_latent`` (``ae_checkpoint``) read the same files.

    python -m ldm_tpu_torch.import_torch_checkpoint ckpt.pt config.yaml \\
        [--kind auto|unet|autoencoder|classifier] [--out PATH] \\
        [--bottleneck-time-emb | --no-bottleneck-time-emb] [--device cuda | --cpu]

The UNet's channels come from the config's ``model`` block (a latent-space
UNet's ``in_channels`` is the VAE's ``z_channels``), the classifier's from
its ``data`` block.  The model is built and the weights loaded on
``--device``; the files hold CPU tensors.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from ldm_tpu_torch.factory import build_classifier, build_model, load_config
from ldm_tpu_torch.training.checkpoint import atomic_save
from ldm_tpu_torch.utils.cli import add_device_args
from ldm_tpu_torch.utils.torch_import import (
    KINDS,
    check_against_model,
    detect_kind,
    without_bottleneck_time_mlp,
)

DEFAULT_FILES = {"unet": "diffusion_model.pt", "autoencoder": "autoencoder.pt",
                 "classifier": "classifier.pt"}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkpoint", help="reference .pt state_dict file")
    ap.add_argument("config", help="config YAML describing the model")
    ap.add_argument("--kind", default="auto", choices=("auto",) + KINDS)
    ap.add_argument("--out", default=None,
                    help="output path (default: the trainer-standard name under the "
                         "config's checkpoints dir)")
    ap.add_argument("--bottleneck-time-emb", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="UNet only: keep the reference's (untrained) bottleneck time-MLP "
                         "weights instead of zeroing them. Default: follow the config "
                         "model's bottleneck_time_emb")
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)

    sd = torch.load(args.checkpoint, map_location="cpu", weights_only=True)
    if not isinstance(sd, dict):
        raise SystemExit("checkpoint is not a state_dict (torch.save'd dict)")

    config = load_config(args.config)
    kind = detect_kind(sd) if args.kind == "auto" else args.kind
    device = torch.device(args.device)
    if kind == "classifier":
        # the classifier always sees dataset-space images
        model = build_classifier(config, config.data.image_channels, config.data.num_classes,
                                 device)
    else:
        model = build_model(config, device)
    if kind == "unet":
        model_bte = bool(getattr(model, "bottleneck_time_emb", True))
        bte = model_bte if args.bottleneck_time_emb is None else args.bottleneck_time_emb
        if bte != model_bte:
            print(f"note: config model has bottleneck_time_emb={model_bte}; importing with "
                  f"{bte} — set model.params.bottleneck_time_emb accordingly for exact "
                  "reference behavior")
        elif bte:
            print("note: the reference never trains its bottleneck time-MLPs; importing "
                  "them at their random init. Set model.params.bottleneck_time_emb: false "
                  "for exact reference behavior")
        if not bte:
            sd = without_bottleneck_time_mlp(sd, model)
    check_against_model(sd, model)
    model.load_state_dict(sd, strict=True)
    weights = {k: v.detach().cpu() for k, v in model.state_dict().items()}

    out = args.out or os.path.join(config.checkpoints, DEFAULT_FILES[kind])
    atomic_save(weights, out)
    n = sum(v.numel() for v in weights.values())
    print(f"imported {kind} ({n:,} values) -> {out}")
    if kind == "unet" and args.out is None:
        ema = os.path.join(config.checkpoints, "diffusion_model_ema.pt")
        atomic_save(weights, ema)
        print(f"seeded EMA weights (reference has none) -> {ema}")
    return out


if __name__ == "__main__":
    main()
