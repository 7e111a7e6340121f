#!/usr/bin/env python3
"""Smoke test of the PyTorch port (ldm_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout and drives the port's main path, the
class-conditional ancestral DDPM sampler with classifier-free guidance at the
flagship width (configs/pixel_diffusion_model_cifar10.yaml, random weights
from a seed), through its entry point ``ldm_tpu_torch.generate.main``.
Phases, each printing its own lines; any failure raises and exits nonzero:

1. device: a CUDA card or exit; its name and power limit; TF32 off.
2. build: nvcc builds the linear-attention kernel from ldm_tpu_torch/csrc/.
3. kernel vs plain: the kernel against its plain PyTorch version at the 8
   attention sites of the 32px UNet at 2B=20 and 2B=128, and at the 64px
   and 128px sites at 2B=4; fp32 (<= 1e-4) and bf16 (<= 3e-2 + one bf16
   spacing of the output); both timed with CUDA events at 2B=128 bf16.
4. full-width UNet: 20,350,915 parameters; kernel-path vs plain-path forward
   (fp32 <= 1e-3; the bf16 difference is printed).
5. the slice: generate.main at T=400, CFG 3, B=10 (2B=20), bf16; the kernel
   must launch exactly 8 x 400 times; uint8 (10, 32, 32, 3) images from a
   finite x0; a 10-step fp32 trajectory through the kernel against the plain
   path; ms/step of 20 sampler steps at B=64 (median of 5 runs).
6. one JSON line of per-kernel results, the card's line, and last
   ``{"ok": true, "device": {...}}``.

No CPU fallback: without a card it exits nonzero before printing a result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

from ldm_tpu_torch import generate
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.factory import build_model, load_config
from ldm_tpu_torch.ops import build
from ldm_tpu_torch.ops import linear_attention as la

FLAGSHIP = "configs/pixel_diffusion_model_cifar10.yaml"
N_PARAMS = 20_350_915
# (site, N, C) of the 8 linear-attention blocks of the 32px flagship UNet
SITES = [("enc0", 1024, 64), ("enc1", 256, 128), ("enc2", 64, 256),
         ("enc3", 16, 512), ("dec0", 16, 256), ("dec1", 64, 128),
         ("dec2", 256, 64), ("dec3", 1024, 64)]
# the 64px UNet's sites and the largest 128px one, checked at 2B=4
LARGE_SITES = [("64px-l0", 4096, 64), ("64px-l1", 1024, 128), ("64px-l2", 256, 256),
               ("64px-l3", 64, 512), ("128px-l0", 16384, 64)]
# |kernel - plain| <= atol + rtol * |plain|.  fp32: summation order only.
# bf16: 3e-2 as tests/test_linear_attention_op.py allows, plus one bf16
# spacing of the output (2^-7 |y|): y itself is bf16, spaced 2^-5 = 3.1e-2
# in [4, 8), so a sum that rounds to the neighbouring value is one spacing off
TOL = {torch.float32: (1e-4, 0.0), torch.bfloat16: (3e-2, 2.0**-7)}
UNET_FP32_TOL = 1e-3
T_STEPS = 400
DEV = torch.device("cuda")


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms, from CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def site_inputs(b: int, n: int, c: int, dtype: torch.dtype, seed: int):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    x = r(b, n, c).to(DEV, dtype)
    params = [r(c, 384) / c**0.5, r(128, c) / 128**0.5, 0.1 * r(c),
              1 + 0.1 * r(c), 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c)]
    return x, [p.to(DEV) for p in params]


def check_kernel(tag: str) -> dict:
    """Phase 3: kernel vs plain at every site; timings at 2B=128 bf16."""
    kw = dict(heads=4, dim_head=32)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    cases = [(b, site) for b in (20, 128) for site in SITES]
    cases += [(4, site) for site in LARGE_SITES]
    for dtype in (torch.float32, torch.bfloat16):
        for b, (site, n, c) in cases:
            x, p = site_inputs(b, n, c, dtype, seed=b + n + c)
            with torch.inference_mode():
                got = la.linear_attention_block(x, *p, compute_dtype=dtype, **kw)
                again = la.linear_attention_block(x, *p, compute_dtype=dtype, **kw)
                want = la.linear_attention_block_torch(x, *p, compute_dtype=dtype, **kw)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            err = diff.max().item()
            atol, rtol = TOL[dtype]
            excess = (diff - atol - rtol * want.float().abs()).max().item()
            print(f"kernel vs plain {site} (N={n}, C={c}) 2B={b} "
                  f"{str(dtype)[6:]}: max_abs_err {err:.3e} "
                  f"(tol {atol:g} + {rtol:g}|y|, excess {excess:.3e})")
            if not (torch.isfinite(got).all() and excess <= 0):
                raise AssertionError(f"{site} 2B={b} {dtype}: err {err}")
            if not torch.equal(got, again):
                raise AssertionError(f"{site} 2B={b} {dtype}: not deterministic")
            worst[dtype] = max(worst[dtype], err)

    ms = plain_ms = 0.0
    for i, (site, n, c) in enumerate(SITES):
        x, p = site_inputs(128, n, c, torch.bfloat16, seed=i)
        kw_b = dict(kw, compute_dtype=torch.bfloat16)
        with torch.inference_mode():
            k = cuda_ms(lambda: la.linear_attention_block(x, *p, **kw_b))
            t = cuda_ms(lambda: la.linear_attention_block_torch(x, *p, **kw_b))
        ms, plain_ms = ms + k, plain_ms + t
        print(f"time {site} (N={n}, C={c}) 2B=128 bf16: kernel {k:.4f} ms, "
              f"plain {t:.4f} ms, kernel/plain {k / t:.2f} [{tag}]")
    print(f"time all 8 sites 2B=128 bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{tag}]")
    return {"max_abs_err": worst[torch.bfloat16], "max_abs_err_fp32": worst[torch.float32],
            "ms": ms, "plain_ms": plain_ms}


def seeded_pair(config, seed: int = 0):
    """A kernel-path and a plain-path UNet with the same random weights."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        m_kernel = build_model(config, DEV).eval()
    m_plain = build_model(config, DEV, attention_impl="torch").eval()
    m_plain.load_state_dict(m_kernel.state_dict(), strict=True)
    return m_kernel, m_plain


def check_unet(config) -> None:
    """Phase 4: parameter count; kernel-path vs plain-path forward."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(20, 32, 32, 3, generator=g).to(DEV)
    t = torch.randint(0, T_STEPS, (20,), generator=g).to(DEV)
    y = torch.cat([torch.arange(10), torch.full((10,), 10)]).to(DEV)
    for use_amp in (False, True):
        m_kernel, m_plain = seeded_pair(dataclasses.replace(config, use_amp=use_amp))
        n = sum(p.numel() for p in m_kernel.parameters())
        if n != N_PARAMS:
            raise AssertionError(f"UNet has {n} parameters, want {N_PARAMS}")
        with torch.inference_mode():
            ek, ep = m_kernel(x, t, y), m_plain(x, t, y)
        err = (ek - ep).abs().max().item()
        dt = "bf16" if use_amp else "fp32"
        print(f"full-width UNet ({n} parameters) 2B=20 {dt}: kernel path vs plain "
              f"path max_abs_err {err:.3e}, |eps| max {ep.abs().max().item():.3f}")
        if not torch.isfinite(ek).all():
            raise AssertionError(f"{dt} UNet output not finite")
        if not use_amp and err > UNET_FP32_TOL:
            raise AssertionError(f"fp32 UNet kernel vs plain err {err} > {UNET_FP32_TOL}")


def check_trajectory(config) -> None:
    """A short fp32 CFG trajectory through the kernel against the plain path,
    same weights, same injected x_T and noise."""
    m_kernel, m_plain = seeded_pair(dataclasses.replace(config, use_amp=False), seed=2)
    diffusion = GaussianDiffusion(10, device=DEV)
    g = torch.Generator().manual_seed(3)
    x_init = torch.randn(2, 32, 32, 3, generator=g)
    noise = torch.randn(10, 2, 32, 32, 3, generator=g)
    classes = torch.tensor([3, 7], device=DEV)
    out = [diffusion.sample(m, classes, (32, 32, 3), cfg_scale=3.0, null_label=10,
                            x_init=x_init, noise=lambda t: noise[t])
           for m in (m_kernel, m_plain)]
    err = (out[0] - out[1]).abs().max().item()
    print(f"10-step fp32 CFG trajectory B=2: kernel path vs plain path max_abs_err {err:.3e}")
    if not (torch.isfinite(out[0]).all() and err <= UNET_FP32_TOL):
        raise AssertionError(f"trajectory err {err}")


def main() -> None:
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    tag = card()
    print(f"card: {tag}; {torch.cuda.get_device_name(0)}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("2 build")
    lib, log, seconds = build.build()
    print(f"built {lib} from {[str(s) for s in build.sources()]} in {seconds:.1f} s "
          f"with nvcc {' '.join(build.NVCC_FLAGS)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  ptxas: {line.strip()}")
    build.load()

    phase("3 kernel vs plain")
    kernel = check_kernel(tag)

    phase("4 full-width UNet")
    config = load_config(FLAGSHIP)
    check_unet(config)

    phase("5 the slice: generate.main, T=400, CFG 3, B=10, bf16")
    if config.diffusion.n_steps != T_STEPS or not config.use_amp:
        raise AssertionError("flagship config is not T=400 with use_amp")
    la.linear_attention_block.launches = 0
    res = generate.main([FLAGSHIP, "--per-class", "1", "--device", "cuda"])
    launches = la.linear_attention_block.launches
    print(f"kernel launches in the sampler run: {launches} (want {8 * T_STEPS})")
    if launches != 8 * T_STEPS:
        raise AssertionError(f"kernel launched {launches} times, want {8 * T_STEPS}")
    if res.images.dtype != np.uint8 or res.images.shape != (10, 32, 32, 3):
        raise AssertionError(f"images {res.images.dtype} {res.images.shape}")
    if not np.isfinite(res.x0).all():
        raise AssertionError("x0 not finite")
    print(f"sampler T=400 CFG 3 B=10 bf16: {10 / res.seconds:.3f} img/s "
          f"({res.seconds:.3f} s, x0 in [{res.x0.min():.3f}, {res.x0.max():.3f}]) [{tag}]")

    check_trajectory(config)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(config.seed)
        model = build_model(config, DEV).eval()
    diffusion = GaussianDiffusion(20, device=DEV)
    classes = (torch.arange(64) % 10).to(DEV)
    gen = torch.Generator(device=DEV).manual_seed(0)

    def run():
        diffusion.sample(model, classes, (32, 32, 3), cfg_scale=3.0,
                         null_label=model.null_label, generator=gen)

    run()  # warm-up
    # the loop is launched from the host, whose clock varies from run to run
    # on a shared machine: report every run and the median
    runs = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) / 20 * 1e3)
    step_ms = float(np.median(runs))
    print(f"sampler B=64 (2B=128) bf16: {step_ms:.3f} ms/step, median of 5 runs of "
          f"20 steps ({' '.join(f'{r:.3f}' for r in runs)}), "
          f"{64 / (step_ms * 1e-3 * T_STEPS):.3f} img/s at T=400 [{tag}]")

    phase("6 result")
    print(json.dumps({"kernels": [{
        "name": "linear_attention_fwd",
        "route": "cuda",
        "source": "ldm_tpu_torch/csrc/linear_attention_fwd.cu",
        "replaces": "ldm_tpu/ops/linear_attention.py:220",
        "also_replaces": "ldm_tpu/ops/linear_attention.py:333",
        "launches": launches,
        "max_abs_err": kernel["max_abs_err"],
        "max_abs_err_fp32": kernel["max_abs_err_fp32"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "timed": "sum over the 8 sites, one launch each, 2B=128, bf16",
    }]}))
    print(card())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
