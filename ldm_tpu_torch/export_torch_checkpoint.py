"""Export weights trained by the port as a reference torch checkpoint (the
twin of scripts/export_torch_checkpoint.py).

The inverse of ``python -m ldm_tpu_torch.import_torch_checkpoint``: loads one
of the port's weight files (weights-only, as the trainers and the importer
write them, or a full training state such as ``state.pt`` /
``best_state.pt``, whose model or, with ``--ema``, EMA model it takes) and
``torch.save``s the reference-layout state_dict of CPU fp32 tensors
(``utils/torch_export.py``): loadable with
``module.load_state_dict(sd, strict=True)`` by the reference's classes and
the port's, and by the JAX package's importers
(``scripts/import_torch_checkpoint.py``).

    python -m ldm_tpu_torch.export_torch_checkpoint [weights.pt] config.yaml \\
        [--kind auto|unet|autoencoder|classifier] [--out model.pt] [--ema] \\
        [--device cuda | --cpu]

Without a weights path it reads the trainer-standard file under the
config's ``checkpoints`` dir of the kind the config's model names
(``diffusion_model.pt``, with ``--ema`` ``diffusion_model_ema.pt``;
``autoencoder.pt``; ``classifier.pt``).  ``--kind auto`` reads the kind
from the file's keys; an explicit kind the keys disagree with is an error,
as is an autoencoder whose blocks a level are not the config's
``n_resnet_blocks``.  The output defaults to ``<weights>_reference.pt``
beside the input.  The file is read onto ``--device``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import torch

from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.utils.cli import add_device_args
from ldm_tpu_torch.utils.torch_export import (
    check_kind,
    model_state_dict,
    reference_state_dict,
    vae_blocks_per_level,
)
from ldm_tpu_torch.utils.torch_import import KINDS


def default_weights(config, kind: str, ema: bool) -> str:
    """The trainer-standard file of ``kind`` (``auto``: the one the config's
    model names) under the config's checkpoints dir."""
    if kind == "auto":
        target = config.model.target.lower()
        kind = ("autoencoder" if "autoencoder" in target
                else "unet" if "unet" in target else "classifier")
    name = {"unet": "diffusion_model_ema.pt" if ema else "diffusion_model.pt",
            "autoencoder": "autoencoder.pt", "classifier": "classifier.pt"}[kind]
    return os.path.join(config.checkpoints, name)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("weights", nargs="?", default=None,
                    help="the port's .pt weight file or training state (default: the "
                         "trainer-standard file under the config's checkpoints dir)")
    ap.add_argument("config", help="config YAML describing the model")
    ap.add_argument("--kind", default="auto", choices=("auto",) + KINDS)
    ap.add_argument("--out", default=None, help="output .pt path")
    ap.add_argument("--ema", action="store_true",
                    help="the EMA weights: the default UNet file's, or a training state's")
    add_device_args(ap)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> str:
    args = parse_args(argv)

    config = load_config(args.config)
    weights = args.weights or default_weights(config, args.kind, args.ema)
    checkpoint = torch.load(weights, map_location=torch.device(args.device),
                            weights_only=True)
    if not isinstance(checkpoint, dict):
        raise SystemExit(f"{weights} is not a state_dict (torch.save'd dict)")
    sd = reference_state_dict(model_state_dict(checkpoint, args.ema))
    kind = check_kind(sd, args.kind)
    if kind == "autoencoder":
        nrb = int(config.model.params.get("n_resnet_blocks", 2))
        if vae_blocks_per_level(sd) != nrb:
            raise ValueError(f"encoder has {vae_blocks_per_level(sd)} res blocks a level, "
                             f"the config {nrb} — wrong n_resnet_blocks?")

    out = args.out or os.path.splitext(weights)[0] + "_reference.pt"
    torch.save(sd, out)
    print(f"exported {kind} ({len(sd)} tensors) -> {out}")
    return out


if __name__ == "__main__":
    main()
