"""Generation server of the port (the twin of scripts/serve.py): an
always-on HTTP service that coalesces concurrent requests into one
fixed-batch sampler (``ldm_tpu_torch/serving``); pixel, flow and latent
configs, and a distilled consistency student (``--sampler consistency``).

    python -m ldm_tpu_torch.serve configs/pixel_diffusion_model_cifar10.yaml \\
        [--checkpoint unet.pt] [--no-ema] [--sampler ddim|ddpm|dpmpp|consistency] \\
        [--ddim-steps 50] [--eta 0] [--cfg-scale S] [--batch-size 64] \\
        [--max-delay-ms 20] [--host 127.0.0.1] [--port 8080] [--device cuda]
    curl -X POST localhost:8080/generate -d '{"class_id": 3, "n": 4, "seed": 1}'
    curl -s -X POST localhost:8080/generate \\
        -d '{"class_id": 3, "n": 2, "seed": 7, "format": "npy"}'
    curl localhost:8080/stats
    curl localhost:8080/healthz

The weights default to the config's run directory's
``checkpoints/diffusion_model_ema.pt`` (``--no-ema``: ``diffusion_model.pt``),
as ``python -m ldm_tpu_torch.train`` writes them.  On a CUDA device (the
default) the sampler's step is captured as a CUDA graph before the server
listens; ``--device cpu`` runs the eager loop on the CPU.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.serving import GenerationHTTPServer
from ldm_tpu_torch.serving.builder import build_generation_service
from ldm_tpu_torch.training.diffusion_trainer import CONSISTENCY, SAMPLERS


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("config")
    ap.add_argument("--checkpoint", default=None,
                    help="UNet state_dict (.pt); default: the run directory's best")
    ap.add_argument("--ema", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--sampler", choices=SAMPLERS + (CONSISTENCY,), default="ddim")
    ap.add_argument("--ddim-steps", type=int, default=50,
                    help="ddim / dpmpp / consistency steps")
    ap.add_argument("--eta", type=float, default=0.0)
    ap.add_argument("--cfg-scale", type=float, default=None)
    ap.add_argument("--batch-size", type=int, default=64,
                    help="the one batch size (slots a batch)")
    ap.add_argument("--max-delay-ms", type=float, default=20.0,
                    help="how long the batcher fills a batch before sampling it padded")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    service = build_generation_service(
        load_config(args.config), args.checkpoint, use_ema=args.ema, sampler=args.sampler,
        ddim_steps=args.ddim_steps, eta=args.eta, cfg_scale=args.cfg_scale,
        batch_size=args.batch_size, max_delay_s=args.max_delay_ms / 1e3, device=args.device)
    print(f"warming up the {args.sampler} sampler at batch {args.batch_size} on "
          f"{args.device}...", flush=True)
    service.start(warmup=True)
    server = GenerationHTTPServer(service, host=args.host, port=args.port)
    print(f"serving on {server.address} (POST /generate, GET /stats, GET /healthz)", flush=True)
    try:
        server.serve_forever()
    finally:
        service.stop()


if __name__ == "__main__":
    main()
