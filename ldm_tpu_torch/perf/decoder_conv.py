"""The VAE decoder's convolutions when serving: what the per-shape probe of
``models/autoencoder.py::DecoderConv2d`` saves over computing every decoder
convolution in fp32.

    python -m ldm_tpu_torch.perf.decoder_conv [--images 4096] [--out rows.json]

At the full width of configs/latent_diffusion_hard.yaml (its latent UNet
and its autoencoder_hard first stage, weights from the config's seed), under
the cuDNN flags ``python -m ldm_tpu_torch.serve`` runs with (PyTorch's
defaults: TF32 on for cuDNN, no autotuning, algorithms not forced
deterministic), three settings of the decoder's convolutions, in turns
(probe, fp32, bf16, bf16, fp32, probe):

* ``probe``: ``DecoderConv2d`` as it is (bf16 where the probe found cuDNN's
  bf16 algorithm keeps every image independent of its batch slot, fp32 on
  the bf16 values elsewhere);
* ``fp32``: every decoder convolution in fp32 on its bf16 values;
* ``bf16``: every decoder convolution in bf16 (no slot guarantee).

For each: whether a B=64 decode gives each image the same output at
another slot (the batch rolled by 1 and by 32), the device ms of that
decode (a CUDA-graph replay), and latent DDIM-50 served img/s at B=64
(8 client threads of 32-image requests, ``--images`` images, wall time).
Needs a CUDA card.  Prints one line a run; writes the rows as JSON only to
``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.models.autoencoder import DecoderConv2d, latent_shape_of
from ldm_tpu_torch.perf.common import card, cuda_graph_ms
from ldm_tpu_torch.serving.builder import build_generation_service
from ldm_tpu_torch.training.latent_trainer import load_autoencoder

CONFIG = "configs/latent_diffusion_hard.yaml"
VERDICTS = {"probe": None, "fp32": False, "bf16": True}  # what _probe answers
ORDER = ("probe", "fp32", "bf16", "bf16", "fp32", "probe")
B = 64


@contextlib.contextmanager
def decoder_mode(mode: str):
    """Every DecoderConv2d built and first called inside runs as ``mode``."""
    verdict, original = VERDICTS[mode], DecoderConv2d._probe
    if verdict is not None:
        DecoderConv2d._probe = lambda self, x: verdict
    try:
        yield
    finally:
        DecoderConv2d._probe = original


def decode_row(config, device) -> dict:
    """Slot independence and the device ms of one B=64 decode."""
    ae = load_autoencoder(config, device)
    g = torch.Generator().manual_seed(0)
    z = torch.randn((B,) + latent_shape_of(ae, config.data.image_size), generator=g).to(device)
    with torch.inference_mode():
        out = ae.decode(z)
        slots = {s: bool(torch.equal(out.roll(s, 0), ae.decode(z.roll(s, 0)))) for s in (1, 32)}
        ms = cuda_graph_ms(lambda: ae.decode(z), iters=5)
    fp32 = sorted(f"{name} {key[0]}" for name, m in ae.named_modules()
                  for key, ok in getattr(m, "position_independent", {}).items() if not ok)
    return {"slot_independent": slots, "decode_ms": ms, "fp32_convs": fp32}


def saturate(svc, images: int, clients: int = 8, n: int = 32) -> float:
    """img/s over the wall time of ``images`` images from ``clients``
    threads, each submitting ``n``-image requests one after another."""
    per_client = images // (clients * n)
    errors = []

    def client(k: int):
        for r in range(per_client):
            try:
                svc.submit(((np.arange(n) + k + r) % 10).tolist(), n=n,
                           seed=1000 * k + r).result(timeout=600)
            except Exception as e:  # noqa: BLE001 - reported below
                errors.append(e)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"saturated run: {errors[:3]}")
    return clients * per_client * n / wall


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--images", type=int, default=4096)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decoder_conv: torch.cuda.is_available() is False; "
                         "this probe runs only on a CUDA card")
    device = torch.device("cuda")
    c = torch.backends.cudnn
    flags = {"cudnn.allow_tf32": c.allow_tf32, "cudnn.deterministic": c.deterministic,
             "cudnn.benchmark": c.benchmark}
    tag = card()
    print(f"decoder_conv: {tag}; serve's cuDNN flags {flags}", flush=True)
    config = load_config(CONFIG)
    config = dataclasses.replace(  # a seeded first stage and a fixed scale: no files to read
        config, ae_checkpoint="",
        diffusion=dataclasses.replace(config.diffusion, latent_scaling_factor=1.0))
    rows = []
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "diffusion_model_ema.pt")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(config.seed)
            torch.save(build_model(config).state_dict(), ckpt)
        for mode in ORDER:
            with decoder_mode(mode):
                row = {"mode": mode, **decode_row(config, device)}
                svc = build_generation_service(config, ckpt, sampler="ddim", ddim_steps=50,
                                               batch_size=B, device=device)
                svc.start(warmup=True)
                try:
                    row["served_img_s"] = saturate(svc, args.images)
                finally:
                    svc.stop()
            rows.append({**row, "card": tag, "flags": flags})
            print(f"decoder_conv {mode}: B={B} decode slot-independent "
                  f"{row['slot_independent']}, device {row['decode_ms']:.4f} ms (CUDA-graph "
                  f"replay); latent DDIM-50 served {row['served_img_s']:.3f} img/s "
                  f"({args.images} images); fp32 convs {row['fp32_convs']} [{tag}]", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
