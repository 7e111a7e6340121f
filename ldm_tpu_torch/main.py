"""The flagship experiment, end to end (the port's twin of the root main.py).

Trains the class-conditional generator on half the train set, samples a
synthetic set with classifier-free guidance, retrains a ResNet-18 classifier
on five real / synthetic mixes and prints the test F1 of each with the
pixel- and classifier-feature FIDs, as the JSON the root main.py prints
(``experiments/augmentation.py`` has the protocol).

    python -m ldm_tpu_torch.main configs/pixel_diffusion_model_cifar10.yaml \\
        [--per-class N] [--classifier-epochs N] [--sampler ddpm|ddim|dpmpp] \\
        [--ddim-steps N] [--negative-control] [--diffusion-checkpoint PATH] \\
        [--generator-config LATENT.yaml] [--save-png] [--device cuda|cpu] \\
        [--eager] [--strict-data]

Three generator families: the pixel DDPM (``GaussianDiffusion``), the
rectified flow (``RectifiedFlow``, e.g. ``configs/protocol_flow_hard.yaml``)
and, with ``--generator-config`` (a latent config such as
``configs/latent_diffusion_hard.yaml``), the latent DDPM over a frozen VAE;
Phase C defaults to each family's sampler (ancestral DDPM; Heun-25 for the
flow).  ``--diffusion-checkpoint`` takes the port's full-state checkpoint
(``<checkpoints>/best_state.pt`` of an earlier run) and skips Phase A.  On a
CUDA device (the default) both trainers' steps and the sampler step run as
CUDA graphs captured once and replayed; ``--eager`` asks for the eager
steps.  ``--mesh`` / ``--distributed`` raise until ROADMAP queue 1, item 12.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from ldm_tpu_torch.experiments.augmentation import (
    AugmentationResult,
    run_augmentation_experiment,
)
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.training.diffusion_trainer import SAMPLERS
from ldm_tpu_torch.utils.cli import add_runtime_args, runtime_setup
from ldm_tpu_torch.utils.seed import apply_runtime_flags, set_seed


def result_json(result: AugmentationResult) -> dict:
    """The keys the root main.py prints."""
    out = {"test_f1": result.test_f1, "synthetic_size": result.synthetic_size,
           "fid_pixel": result.fid_pixel, "fid_classifier": result.fid_classifier}
    if result.fid_pixel_broken is not None:
        out["fid_pixel_broken"] = result.fid_pixel_broken
        out["fid_classifier_broken"] = result.fid_classifier_broken
    return out


def main(argv: Optional[Sequence[str]] = None) -> AugmentationResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    add_runtime_args(ap)
    ap.add_argument("--per-class", type=int, default=None,
                    help="synthetic images per class (default: |generator half| / classes)")
    ap.add_argument("--save-png", action="store_true",
                    help="also write the synthetic set as an ImageFolder PNG tree")
    ap.add_argument("--classifier-epochs", type=int, default=None)
    ap.add_argument("--sampler", choices=SAMPLERS, default=None,
                    help="Phase C's sampler (default: the family's; ancestral DDPM, "
                         "flow Heun-25)")
    ap.add_argument("--ddim-steps", type=int, default=None)
    ap.add_argument("--negative-control", action="store_true",
                    help="also a deliberately broken synthetic set, its FIDs and an "
                         "exp2_broken classifier")
    ap.add_argument("--diffusion-checkpoint", default=None,
                    help="skip Phase A: restore the generator's full state from this .pt")
    ap.add_argument("--generator-config", default=None,
                    help="a latent config: its family generates (Phases A and C)")
    ap.add_argument("--eager", action="store_true",
                    help="launch every kernel from Python instead of replaying CUDA graphs")
    args = ap.parse_args(argv)

    device = runtime_setup(args)
    config = load_config(args.config)
    set_seed(config.seed)
    apply_runtime_flags(config)
    result = run_augmentation_experiment(
        config,
        n_per_class=args.per_class,
        save_png=args.save_png,
        classifier_epochs=args.classifier_epochs,
        strict_data=args.strict_data,
        sampler=args.sampler,
        ddim_steps=args.ddim_steps,
        negative_control=args.negative_control,
        diffusion_checkpoint=args.diffusion_checkpoint,
        generator_config=args.generator_config,
        device=device,
        graphs=False if args.eager else None,
    )
    print(json.dumps(result_json(result), indent=2))
    return result


if __name__ == "__main__":
    main()
