"""Sampling entry point of the port (scripts/generate_images.py).

config -> model -> the trained weights -> diffusion -> CFG sampling ->
``reverse_transform`` -> images, written as a PNG tree
``<results>/<class>/sample_<i>.png`` (torchvision's ImageFolder layout, the
tree ``python -m ldm_tpu_torch.train_classifier --pretrain-dir`` reads) and
as one uint8 NHWC ``.npy``.

    python -m ldm_tpu_torch.generate configs/pixel_diffusion_model_cifar10.yaml \\
        [--weights unet.pt] [--ema | --no-ema] [--cfg-scale S] [--per-class 1] \\
        [--device cuda | --cpu] [--out x.npy] [--sampler ddpm|ddim|dpmpp|consistency] \\
        [--ddim-steps 50] [--eta 0.0] [--eager]

The weights are the state_dict a trainer of the port left under the
config's ``checkpoints/``: ``diffusion_model_ema.pt`` (``--no-ema``:
``diffusion_model.pt``; a ``type: latent`` config's latent UNet has the
same names), or for ``--sampler consistency`` the distilled student's
``consistency_model_ema.pt`` / ``consistency_model.pt``; ``--weights``
names another file.  A missing file is an error.

``--sampler``: the ancestral DDPM loop over all T steps (default), DDIM or
DPM-Solver++(2M) over ``--ddim-steps`` steps; for a rectified-flow config
Euler over ``n_steps``, Euler or Heun over ``--ddim-steps`` steps.
``consistency`` samples a distilled student (``python -m
ldm_tpu_torch.distill``) in ``--ddim-steps`` steps (1-4 are useful), one
B-batch forward a step and no guidance pass.  A ``type: latent`` config
samples the latent UNet over the frozen VAE's latents and decodes them (the
first stage and the scale as ``python -m ldm_tpu_torch.train_latent``
resolved them).  On a CUDA device the loop is one sampler step captured
into a CUDA graph and replayed; ``--eager`` asks for the Python loop that
launches every kernel itself (the only loop on the CPU).  The reported
seconds are the whole request, warm-up and capture included; their share
is printed on a line of its own.

The guidance scale is ``--cfg-scale``, by default the config's
``cfg_scale``; x_T and the per-step noise come from a ``torch.Generator``
on the sampling device, seeded from the config's seed.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.models.autoencoder import latent_shape_of
from ldm_tpu_torch.serving.builder import load_sampler, sampler_checkpoint
from ldm_tpu_torch.training.diffusion_trainer import CONSISTENCY, SAMPLERS, run_sampler
from ldm_tpu_torch.training.latent_trainer import load_ldm
from ldm_tpu_torch.utils.cli import add_device_args
from ldm_tpu_torch.utils.images import save_images


class Generated(NamedTuple):
    images: np.ndarray   # (B, H, W, C) uint8
    x0: np.ndarray       # (B, H, W, C) float32, the sampler's output (decoded: latent)
    seconds: float       # sampling wall time, ending in a device sync
    capture_seconds: float = 0.0  # of which: warm-up and capture of the graph (host clock)
    paths: Sequence[str] = ()     # the PNG tree's files, one an image in order


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--weights", default=None,
                    help="UNet state_dict (.pt): one a trainer of the port wrote, or a "
                         "reference-layout file from python -m "
                         "ldm_tpu_torch.export_torch_checkpoint or from "
                         "scripts/export_torch_checkpoint.py (the JAX package's weights); "
                         "default: the run directory's checkpoint")
    ap.add_argument("--per-class", type=int, default=1)
    ap.add_argument("--cfg-scale", type=float, default=None,
                    help="guidance scale (default: the config's)")
    ap.add_argument("--ema", action=argparse.BooleanOptionalAction, default=True,
                    help="the EMA weights (default) or, with --no-ema, the raw ones")
    add_device_args(ap)
    ap.add_argument("--out", default=None,
                    help="output .npy (default: <results>/samples_torch.npy)")
    ap.add_argument("--sampler", choices=SAMPLERS + (CONSISTENCY,), default="ddpm",
                    help="ddim / dpmpp: few-step samplers over --ddim-steps steps; "
                         "consistency: a distilled student's 1-4 steps")
    ap.add_argument("--ddim-steps", type=int, default=50)
    ap.add_argument("--eta", type=float, default=0.0, help="DDIM stochasticity")
    ap.add_argument("--eager", action="store_true",
                    help="the Python loop instead of the replayed CUDA graph")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Generated:
    args = parse_args(argv)

    device = torch.device(args.device)
    config = load_config(args.config)
    cfg_scale = args.cfg_scale if args.cfg_scale is not None else config.diffusion.cfg_scale
    weights = args.weights or sampler_checkpoint(config, args.ema, args.sampler)
    model, diffusion = load_sampler(config, weights, device=device)

    d = config.data
    shape = (d.image_size, d.image_size, d.image_channels)
    decode = None
    if config.type == "latent":
        ldm = load_ldm(config, model, device)
        diffusion, decode = ldm.diffusion, ldm.autoencoder_decode
        shape = latent_shape_of(ldm.autoencoder, d.image_size)
    classes = torch.arange(d.num_classes, device=device).repeat_interleave(args.per_class)
    gen = torch.Generator(device=device).manual_seed(config.seed)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x0 = run_sampler(diffusion, args.sampler, model, classes, shape,
                     ddim_steps=args.ddim_steps, eta=args.eta, cfg_scale=cfg_scale,
                     null_label=model.null_label, generator=gen,
                     graph=False if args.eager else None)
    if decode is not None:
        x0 = decode(x0)
    x0 = x0.cpu().numpy()  # waits for the device
    seconds = time.perf_counter() - t0
    capture = diffusion.last_capture_seconds

    images = reverse_transform(x0)
    paths = [os.path.join(config.results, str(c), f"sample_{i % args.per_class}.png")
             for i, c in enumerate(classes.tolist())]
    save_images(list(images), paths)
    out = args.out or os.path.join(config.results, "samples_torch.npy")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.save(out, images)
    steps = "" if args.sampler == "ddpm" else f" in {args.ddim_steps} steps"
    cfg = "no guidance pass" if args.sampler == CONSISTENCY else f"cfg {cfg_scale}"
    print(f"sampled {len(images)} images ({args.sampler}{steps}, T={diffusion.n_steps}, "
          f"{cfg}) in {seconds:.3f} s on {device} from {weights}; wrote {out} and "
          f"{len(paths)} PNGs under {config.results}/")
    if device.type == "cuda":
        how = "the eager loop" if args.eager else "one step as a CUDA graph, replayed"
        print(f"of which warm-up and capture of the graph: {capture:.3f} s ({how})")
    return Generated(images, x0, seconds, capture, paths)


if __name__ == "__main__":
    main()
