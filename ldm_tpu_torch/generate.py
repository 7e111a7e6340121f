"""Sampling entry point of the port (the ddpm branch of scripts/generate_images.py).

config -> model -> diffusion -> weights -> ancestral CFG sampling ->
``reverse_transform`` -> images, written as one uint8 NHWC ``.npy``.

    python -m ldm_tpu_torch.generate configs/pixel_diffusion_model_cifar10.yaml \\
        [--weights unet.pt] [--per-class 1] [--device cuda] [--out x.npy]

``--weights`` takes the ``.pt`` state_dict that scripts/export_torch_checkpoint.py
writes.  Without it the UNet gets a random init seeded from the config's
seed, and says so.  The guidance scale is the config's ``cfg_scale``; x_T and
the per-step noise come from a ``torch.Generator`` on the sampling device,
seeded from the config's seed.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.factory import build_diffusion, build_model, load_config


class Generated(NamedTuple):
    images: np.ndarray   # (B, H, W, C) uint8
    x0: np.ndarray       # (B, H, W, C) float32, the sampler's output
    seconds: float       # sampling wall time, ending in a device sync


def main(argv: Optional[Sequence[str]] = None) -> Generated:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--weights", default=None,
                    help=".pt state_dict from scripts/export_torch_checkpoint.py")
    ap.add_argument("--per-class", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="output .npy (default: <results>/samples_torch.npy)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    config = load_config(args.config)
    cfg_scale = config.diffusion.cfg_scale

    if args.weights is None:
        # seeded init without touching the caller's global RNG state
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            model = build_model(config)
        print(f"no --weights: random UNet init from seed {config.seed}")
    else:
        model = build_model(config)
        sd = torch.load(args.weights, map_location="cpu", weights_only=True)
        model.load_state_dict(sd, strict=True)
    model.to(device).eval()
    diffusion = build_diffusion(config, device)

    d = config.data
    shape = (d.image_size, d.image_size, d.image_channels)
    classes = torch.arange(d.num_classes, device=device).repeat_interleave(args.per_class)
    gen = torch.Generator(device=device).manual_seed(config.seed)

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    x0 = diffusion.sample(model, classes, shape, cfg_scale=cfg_scale,
                          null_label=model.null_label, generator=gen)
    x0 = x0.cpu().numpy()  # waits for the device
    seconds = time.perf_counter() - t0

    images = reverse_transform(x0)
    out = args.out or os.path.join(config.results, "samples_torch.npy")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    np.save(out, images)
    print(f"sampled {len(images)} images (T={diffusion.n_steps}, cfg {cfg_scale}) "
          f"in {seconds:.3f} s on {device}; wrote {out}")
    return Generated(images, x0, seconds)


if __name__ == "__main__":
    main()
