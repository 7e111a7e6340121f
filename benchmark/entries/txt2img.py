"""The text-to-image cell: Stable Diffusion's ``txt2img`` over a list of
prompts, as the port runs it: ``LatentDiffusionModel.sample_images`` with
DDIM (eta 0) over the v-predicting U-Net, classifier-free guidance fused as
one 2B forward over the prompts' contexts and the empty prompt's, a step
replayed as a CUDA graph, then one VAE decode of the batch.

Set-up loads the seeded weights and samples one whole batch (the capture,
cuDNN's choices, the decoder's probes at the cell's shapes).  The window runs
whole batches, each from its own seeded contexts and x_T, until ``--seconds``
has passed; ``sample_img_per_s`` is the images of those batches over their
time.  A batch ends on a device sync.  The traced slice is the window's
first batch whole: its steps and its decode.

Compared (after the window, the program freed), against the plain reference
(``reference/sd_unet.py``, ``reference/txt2img.py``, ``reference/vae.py``)
on the same weights and inputs:

* ``image_rel_l2``: ``check_images`` decoded images drawn from the seed over
  all the window's batches, against the reference run from the same x_T and
  contexts through its own sampler and decode: the worst image's relative
  L2 distance;
* ``v_rel_l2``: the guided prediction of the first step on the window's
  first batch (its x_T and contexts at the first DDIM timestep), through the
  same model and the sampler's own guidance, against the reference's: the
  worst item's relative L2 distance.

Params: ``batch``, ``context_len``, ``sampler_steps``, ``eta``,
``check_images``, ``limits``.
"""

from __future__ import annotations

import torch

from benchmark import weights
from benchmark.entries import common
from benchmark.entries.sample import _latent_shape, picks
from benchmark.harness import Check
from benchmark.reference import diffusion as ref
from benchmark.reference import txt2img as ref_txt2img
from benchmark.reference.arith import Arith, tf32_off
from benchmark.reference.sd_unet import (
    RefSDUNet,
    attention_sites,
    group_norm_scales,
    param_shapes,
)
from benchmark.reference.vae import RefVAE
from benchmark.tracing import Slice
from benchmark.yardsticks import decode_flops
from benchmark.yardsticks_sd import sd_forward_flops

# what the controls put in the program's place (``benchmark/controls.py``)
CONTROLS = ("control_fp8",)
WARM = 1 << 30  # the warm-up batch's stream, apart from the window's


def unet_weights(run):
    """The seeded U-Net weights; the GroupNorm scales whose names hold no
    ``norm`` get the 1 + N(0, 0.1^2) of every other norm's scale."""
    mp = run.config["program"]["model"]["params"]
    w = weights.make(param_shapes(mp), run.seed, common.UNET_SALT, run.device)
    for k in group_norm_scales(mp):
        w[k].add_(1.0)
    return w


def run(run) -> None:
    from ldm_tpu_torch.factory import build_model
    from ldm_tpu_torch.models.autoencoder import Autoencoder, DecoderConv2d
    from ldm_tpu_torch.models.latent import LatentDiffusionModel

    p = run.params
    prog = run.config["program"]
    mp, ap, dc = prog["model"]["params"], prog["autoencoder"]["params"], prog["diffusion"]
    b, steps, eta = int(p["batch"]), int(p["sampler_steps"]), float(p.get("eta", 0.0))
    shape = _latent_shape(prog)
    cfg_scale = float(dc["cfg_scale"])
    traffic = run.gen.Traffic(p, run.seed, run.device, mp["context_dim"])
    w = unet_weights(run)
    config = common.program_config(run, workdir="")
    model = build_model(config, device=run.device).eval()
    model.load_state_dict(w, strict=True)
    vae = Autoencoder(**ap, dtype=model.dtype, device=run.device)
    vae.load_state_dict(common.vae_weights(run), strict=True)
    ldm = LatentDiffusionModel(model, vae, float(dc["latent_scaling_factor"]),
                               dc["params"]["n_steps"], dc["beta_start"], dc["beta_end"],
                               device=run.device)
    null = traffic.null_context()
    graph = True if run.device.type == "cuda" else None

    def sample(ctx, x_t):
        return ldm.sample_images(ctx, shape, cfg_scale=cfg_scale, sampler="ddim",
                                 n_sample_steps=steps, eta=eta, null_cond=null, x_init=x_t,
                                 graph=graph)

    sample(*traffic.batch(WARM, shape))  # warm-up: the capture and every first call
    common.sync(run.device)
    fp32 = sorted({k[0] for m in vae.modules() if isinstance(m, DecoderConv2d)
                   for k, ok in m.position_independent.items() if not ok})
    run.note(f"txt2img: decoder convolutions computed in fp32 (the probe's verdict) at "
             f"input shapes {fp32 or 'none'}")

    sl = Slice(run.device) if run.traced else None
    if sl is not None:
        sl.warm()
    outs = []
    common.reset_peak(run.device)
    win = common.Window(run)
    while True:
        ctx, x_t = traffic.batch(len(outs), shape)
        if sl is not None and not outs:
            sl.start()
        outs.append(sample(ctx, x_t))
        common.sync(run.device)
        if sl is not None and sl.open:
            sl.units = steps
            sl.stop()
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

    # the first step's guided prediction on the window's first batch
    ctx0, x0 = traffic.batch(0, shape)
    t_first = int(ldm.diffusion.ddim_timesteps(steps)[0][0])
    with torch.inference_mode():
        t_vec = torch.full((b,), t_first, dtype=torch.int64, device=run.device)
        v = ldm.diffusion._cfg_eps(model, x0, t_vec, torch.cat([ctx0, null.expand_as(ctx0)]),
                                   cfg_scale, True)
    del model, outs, ldm, vae
    common.free(run.device)

    run.flops = run.units * (steps * sd_forward_flops(mp, 2 * b, shape, traffic.context_len)
                             + decode_flops(ap, b, shape))
    run.sdpa_batch = 2 * b
    run.sdpa_sites = attention_sites(mp, shape[0], traffic.context_len)

    # the reference over images drawn from the seed, and the first step
    tf32_off()
    ps = picks(run, images.shape[0] * b)
    got = {"images": torch.stack([images[i // b, i % b] for i in ps]), "v": v}
    del images
    want = reference(run, traffic, w, ps, t_first, Arith("fp32"))
    judge(run, got, want)
    for what in run.stand_ins:  # the control, on these inputs (benchmark/controls.py)
        run.stood_in.append((what, reference(run, traffic, w, ps, t_first, Arith("fp8")),
                             want))


def _worst_rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got - want).flatten(1).norm(dim=1) / want.flatten(1).norm(dim=1)).max().item()


def judge(run, got: dict, want: dict) -> None:
    """The worst relative L2 distance of ``got``'s images and first-step
    predictions (the program's, or a control's) from the float32
    reference's ``want``, against their limits."""
    lim = run.params["limits"]
    gaps = {"image_rel_l2": _worst_rel_l2(got["images"], want["images"]),
            "v_rel_l2": _worst_rel_l2(got["v"], want["v"])}
    run.note(f"txt2img check: {got['images'].shape[0]} images, worst relative L2 "
             f"{gaps['image_rel_l2']!r}; the first step's guided prediction of "
             f"{got['v'].shape[0]} items, worst relative L2 {gaps['v_rel_l2']!r}")
    run.checks += [Check(n, gaps[n], lim[n]) for n in ("image_rel_l2", "v_rel_l2") if n in lim]


def reference(run, traffic, w, picks, t_first: int, arith: Arith) -> dict:
    """The images ``picks`` (indices over the window's batches in order) and
    the first step's guided prediction on batch 0, as the reference
    computes them in ``arith``."""
    prog = run.config["program"]
    mp, ap, dc = prog["model"]["params"], prog["autoencoder"]["params"], prog["diffusion"]
    b, steps = int(run.params["batch"]), int(run.params["sampler_steps"])
    shape = _latent_shape(prog)
    cfg_scale = float(dc["cfg_scale"])
    sched = ref.Schedule(dc["params"]["n_steps"], dc.get("schedule", "linear"),
                         dc["beta_start"], dc["beta_end"], run.device)
    unet = RefSDUNet(w, mp, arith)
    null = traffic.null_context()
    draws = {j: traffic.batch(j, shape) for j in sorted({i // b for i in picks})}
    ctx = torch.stack([draws[i // b][0][i % b] for i in picks])
    x = torch.stack([draws[i // b][1][i % b] for i in picks])
    with torch.no_grad():
        z0 = ref_txt2img.ddim_v(sched, unet, x, ctx, null, cfg_scale, steps)
        images = RefVAE(common.vae_weights(run), ap, arith).decode(
            z0 / float(dc["latent_scaling_factor"]))
        ctx0, x0 = traffic.batch(0, shape)
        t = torch.full((b,), t_first, dtype=torch.int64, device=run.device)
        v = ref_txt2img.guided(unet, x0, t, ctx0, null, cfg_scale)
    return {"images": images, "v": v}
