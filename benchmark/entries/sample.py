"""The offline sampling cells: Phase C buying a synthetic set.  The pixel
family's ``GaussianDiffusion.sample`` (ancestral over T, CFG fused as one
2B forward, a step replayed as a CUDA graph), or the latent family's
``LatentDiffusionModel.sample_images`` (the same sampler over the VAE's
latents, then one decode a batch; the latent scale calibrated in set-up).

Set-up loads the seeded weights, calibrates (latent), and samples one
whole batch (the capture, cuDNN's choices, the decoder's probes).  The
window runs whole batches, each from its own seeded x_T and noise, until
``--seconds`` has passed; ``sample_img_per_s`` is the images of those
batches over their time.  A batch ends on a device sync, as Phase C reads
each batch back.

Compared (after the window, the program freed): ``check_images`` images
drawn from the seed over all the window's batches, against the reference
run from the same x_T, noise and classes (its own calibration, its own
decode): the worst image's relative L2 distance.

Params: ``batch``, ``check_images``, ``trace_from`` / ``trace_units`` (the
profiled slice, in sampler steps of the window's first batch),
``limits``.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.entries import common
from benchmark.harness import Check
from benchmark.reference import diffusion as ref
from benchmark.reference.arith import Arith, tf32_off
from benchmark.reference.unet import RefUNet, attention_sites
from benchmark.reference.vae import RefVAE
from benchmark.tracing import Slice
from benchmark.weights import stream_seed
from benchmark.yardsticks import decode_flops, unet_forward_flops

# what the controls put in the program's place (``benchmark/controls.py``)
CONTROLS = ("control_fp8",)
CALIB, PICK = 21, 22
WARM = 1 << 30  # the warm-up batch's stream, apart from the window's


def _calibration(run, traffic, n: int, img_shape, latent_shape):
    rng = np.random.default_rng(stream_seed(run.seed, CALIB))
    u8 = rng.integers(0, 256, size=(n, *img_shape), dtype=np.uint8)
    images = torch.from_numpy(u8).to(run.device).float() / 255.0 * 2.0 - 1.0
    eps = torch.from_numpy(rng.standard_normal((n, *latent_shape), dtype=np.float32)
                           ).to(run.device)
    return images, eps


def run(run) -> None:
    from ldm_tpu_torch.factory import build_diffusion, build_model
    from ldm_tpu_torch.models.autoencoder import Autoencoder
    from ldm_tpu_torch.models.latent import LatentDiffusionModel, calibrate_latent_scaling

    p = run.params
    prog = run.config["program"]
    mp, dc, d = prog["model"]["params"], prog["diffusion"], prog["data"]
    k = d.get("num_classes", 10)
    b = int(p["batch"])
    img_shape = (d["image_size"], d["image_size"], d["image_channels"])
    latent = prog["type"] == "latent"
    cfg_scale = float(dc["cfg_scale"])
    shape = _latent_shape(prog)
    traffic = run.gen.Traffic(p, run.seed, run.device, k)
    w = common.unet_weights(run)
    config = common.program_config(run, workdir="")
    model = build_model(config, device=run.device).eval()
    model.load_state_dict(w, strict=True)
    graph = True if run.device.type == "cuda" else None
    if latent:
        ap = prog["autoencoder"]["params"]
        vw = common.vae_weights(run)
        vae = Autoencoder(**ap, dtype=model.dtype, device=run.device)
        vae.load_state_dict(vw, strict=True)
        calib = _calibration(run, traffic, prog["batch_size"], img_shape, shape)
        scale = calibrate_latent_scaling(vae, calib[0], eps=calib[1])
        ldm = LatentDiffusionModel(model, vae, scale, dc["params"]["n_steps"],
                                   dc["beta_start"], dc["beta_end"], device=run.device)

        def sample(classes, x_t, noise):
            return ldm.sample_images(classes, shape, cfg_scale=cfg_scale, x_init=x_t,
                                     noise=noise, graph=graph)
    else:
        diffusion = build_diffusion(config, run.device)

        def sample(classes, x_t, noise):
            return diffusion.sample(model, classes, shape, cfg_scale=cfg_scale,
                                    null_label=model.null_label, x_init=x_t, noise=noise,
                                    graph=graph)

    sample(*traffic.batch(WARM, shape))  # warm-up: the capture and every first call
    common.sync(run.device)

    sl = Slice(run.device) if run.traced else None
    if sl is not None:
        sl.warm()
    t_from, t_units = int(p.get("trace_from", 20)), int(p.get("trace_units", 30))
    outs = []
    common.reset_peak(run.device)
    win = common.Window(run)
    while True:
        classes, x_t, noise = traffic.batch(len(outs), shape)
        if sl is not None and not outs:
            calls = [0]

            def noise(t, _draw=noise, calls=calls):
                if calls[0] == t_from:
                    sl.start()
                if calls[0] == t_from + t_units and sl.open:
                    sl.units = t_units
                    sl.stop()
                calls[0] += 1
                return _draw(t)
        outs.append(sample(classes, x_t, noise))
        common.sync(run.device)
        if not win.open():
            break
    window_s = win.close()
    common.read_peak(run)
    run.units = len(outs)
    run.attempted = run.units * b
    images = torch.stack(outs)
    run.failed = int((~torch.isfinite(images.flatten(2)).all(dim=2)).sum())
    run.e2e["sample_img_per_s"] = run.attempted / window_s
    run.trace = sl.reduce() if sl is not None else None
    del model, outs
    if latent:
        del ldm, vae
    common.free(run.device)

    steps = dc["params"]["n_steps"]
    per_batch = steps * unet_forward_flops(mp, 2 * b, shape)
    if latent:
        per_batch += decode_flops(ap, b, shape)
    run.flops = run.units * per_batch
    run.fwd_sites = [(2 * b, n, c) for n, c in attention_sites(mp, shape[0])]

    # the reference over images drawn from the seed
    tf32_off()
    ps = picks(run, images.shape[0] * b)
    got = torch.stack([images[i // b, i % b] for i in ps])
    want = reference(run, traffic, ps, b, shape, Arith("fp32"))
    judge(run, got, want)
    for what in run.stand_ins:  # the control, on these picks (benchmark/controls.py)
        run.stood_in.append((what, reference(run, traffic, ps, b, shape, Arith("fp8")), want))


def _latent_shape(prog: dict):
    """The shape the sampler draws: the image's, or the VAE's latent's."""
    d = prog["data"]
    if prog["type"] != "latent":
        return (d["image_size"], d["image_size"], d["image_channels"])
    ap = prog["autoencoder"]["params"]
    z = 2 ** (len(ap["channel_multipliers"]) - 1)
    return (d["image_size"] // z, d["image_size"] // z, ap["z_channels"])


def picks(run, n_images: int) -> list:
    """``check_images`` of the ``n_images`` a window made (indices over its
    batches in order), drawn from the seed."""
    rng = np.random.default_rng(stream_seed(run.seed, PICK))
    n = min(int(run.params["check_images"]), n_images)
    return sorted(rng.choice(n_images, size=n, replace=False).tolist())


def judge(run, got: torch.Tensor, want: torch.Tensor) -> None:
    """The worst relative L2 distance of ``got`` (the program's images, or a
    control's) from the float32 reference's ``want``, against its limit."""
    gap = ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()
    run.note(f"sample check: {got.shape[0]} images, worst relative L2 {gap!r}")
    run.checks.append(Check("image_rel_l2", gap, run.params["limits"]["image_rel_l2"]))


def reference(run, traffic, picks, b: int, shape, arith: Arith) -> torch.Tensor:
    """The images ``picks`` (indices over the window's batches in order)
    as the reference computes them in ``arith``."""
    prog = run.config["program"]
    mp, dc = prog["model"]["params"], prog["diffusion"]
    k = prog["data"].get("num_classes", 10)
    latent = prog["type"] == "latent"
    sched = ref.Schedule(dc["params"]["n_steps"], dc.get("schedule", "linear"),
                         dc.get("beta_start", 1e-4), dc.get("beta_end", 0.02), run.device)
    unet = RefUNet(common.unet_weights(run), mp, arith)
    batches = sorted({i // b for i in picks})
    draws = {j: traffic.batch(j, shape) for j in batches}
    rows = [(batches.index(i // b), i % b) for i in picks]
    x = torch.stack([draws[batches[j]][1][r] for j, r in rows])
    y = torch.stack([draws[batches[j]][0][r] for j, r in rows])

    def noise(_i):
        z = [draws[j][2](0) for j in batches]
        return torch.stack([z[j][r] for j, r in rows])

    with torch.no_grad():
        z0 = ref.ancestral(sched, unet, x, y, k, float(dc["cfg_scale"]), noise)
        if not latent:
            return z0
        ap = prog["autoencoder"]["params"]
        vae = RefVAE(common.vae_weights(run), ap, arith)
        img_shape = (prog["data"]["image_size"],) * 2 + (prog["data"]["image_channels"],)
        calib = _calibration(run, traffic, prog["batch_size"], img_shape, shape)
        scale = 1.0 / vae.latent(*calib).std(correction=0)
        return vae.decode(z0 / scale)
