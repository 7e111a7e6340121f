"""Stable Diffusion 2.1 (768-v) in the port on the CPU: the text-conditional
U-Net (``models/sd_unet.py``) against the benchmark's plain reference
(``benchmark/reference/sd_unet.py``, the copy the benchmark's ``correct``
uses) on seeded weights at a tiny size; the published widths built on the
meta device; v-prediction DDIM with a tensor null condition through the
sampler loop and ``LatentDiffusionModel`` against the reference's
(``benchmark/reference/txt2img.py``); the eps path as it was; the
attention op and its call counter; the ``sampler.decode`` record."""

import json
import math
import os

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import diffusion as ref
from benchmark.reference import txt2img as ref_txt2img
from benchmark.reference.sd_unet import RefSDUNet, group_norm_scales, param_shapes
from benchmark.reference.vae import RefVAE
from benchmark.reference.vae import param_shapes as vae_shapes
from ldm_tpu_torch import factory, registry
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models import sd_unet
from ldm_tpu_torch.models.autoencoder import Autoencoder
from ldm_tpu_torch.models.latent import SD_SCALING, LatentDiffusionModel
from ldm_tpu_torch.ops import attention
from ldm_tpu_torch.utils import launches, profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(in_channels=4, out_channels=4, model_channels=32, channel_mult=[1, 2],
            num_res_blocks=2, attention_resolutions=[1, 2], num_head_channels=16,
            transformer_depth=1, context_dim=24, use_linear_in_transformer=True,
            parameterization="v")
TINY_VAE = dict(in_channels=3, out_channels=3, channels=8, channel_multipliers=[1, 2],
                n_resnet_blocks=1, z_channels=4)
SIDE, CTX = 16, (7, 24)
# fp32: the port and the reference make the same products and sums in the
# same order but for the attention's blocks; 2e-5 is the JAX suite's module
# tolerance (tests/test_torch_parity.py)
FP32_TOL = 2e-5
# bf16 against the fp32 reference, relative L2 of the output: every product
# rounds its operands to 8 bits (2^-9 relative each) through about 40 layers
# (measured 1.7e-2 at this size); 3e-2 leaves that twice over and fails an
# output off by more than a bf16 model could be
BF16_REL_L2 = 3e-2
T_STEPS, DDIM_STEPS, CFG = 10, 3, 9.0
# v-DDIM over 3 steps in fp32 at CFG 9: the program's x_0 from v and the
# reference's agree to the rounding of the guidance's 9x difference
DDIM_TOL = 1e-4


def tiny_weights(p=TINY, seed=3):
    w = weights.make(param_shapes(p), seed, 1, "cpu")
    for k in group_norm_scales(p):
        w[k].add_(1.0)
    return w


def tiny_model(dtype=torch.float32, p=TINY):
    m = sd_unet.SDUNet(**p, dtype=dtype).eval()
    m.load_state_dict(tiny_weights(p), strict=True)
    return m


def inputs(b=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, SIDE, SIDE, 4, generator=g)
    ctx = torch.randn(b, *CTX, generator=g)
    null = torch.randn(*CTX, generator=g)
    return x, ctx, null


def transformer_blocks(model):
    return [m for m in model.modules() if isinstance(m, sd_unet.BasicTransformerBlock)]


def rel_l2(a, b):
    return ((a - b).norm() / b.norm()).item()


def test_the_unet_is_the_reference_in_fp32():
    x, ctx, _ = inputs()
    t = torch.tensor([999, 17])
    with torch.no_grad():
        got = tiny_model()(x, t, ctx)
        want = RefSDUNet(tiny_weights(), TINY)(x, t, ctx)
    assert got.dtype == torch.float32 and got.shape == (2, SIDE, SIDE, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=FP32_TOL)


def test_the_unet_in_bf16_is_within_its_bar():
    x, ctx, _ = inputs()
    t = torch.tensor([500, 3])
    with torch.no_grad():
        got = tiny_model(torch.bfloat16)(x, t, ctx)
        want = RefSDUNet(tiny_weights(), TINY)(x, t, ctx)
    assert got.dtype == torch.float32
    assert 0 < rel_l2(got, want) < BF16_REL_L2


@pytest.mark.parametrize("path", ["configs/sd21_v_768.yaml", "benchmark/configs/sd21-v-768.json"])
def test_the_published_widths_build_through_the_factory(path):
    if path.endswith(".json"):
        with open(os.path.join(ROOT, path)) as f:
            from ldm_tpu_torch.config import config_from_dict
            config = config_from_dict(json.load(f)["program"])
    else:
        config = factory.load_config(os.path.join(ROOT, path))
    with torch.device("meta"):
        unet = factory.build_model(config)
        vae = registry.instantiate_from_config(
            {"target": config.autoencoder.target, "params": config.autoencoder.params})
    assert isinstance(unet, sd_unet.SDUNet) and unet.parameterization == "v"
    assert unet.dtype == torch.bfloat16
    assert sum(p.numel() for p in unet.parameters()) == 865_910_724
    assert sum(p.numel() for p in vae.parameters()) == 83_653_863
    assert {k: tuple(v.shape) for k, v in unet.state_dict().items()} == \
        dict(param_shapes(config.model.params))
    assert {k: tuple(v.shape) for k, v in vae.state_dict().items()} == \
        dict(vae_shapes(config.autoencoder.params))
    assert factory.build_diffusion(config).parameterization == "v"
    assert config.diffusion.latent_scaling_factor == SD_SCALING


def test_the_published_topology_calls_16_self_and_16_cross_attentions():
    config = factory.load_config(os.path.join(ROOT, "configs/sd21_v_768.yaml"))
    with torch.device("meta"):
        unet = factory.build_model(config)
    assert len(transformer_blocks(unet)) == 16
    before = launches.snapshot()
    with torch.no_grad():
        unet(torch.zeros(1, 16, 16, 4, device="meta"),
             torch.zeros(1, dtype=torch.int64, device="meta"),
             torch.zeros(1, 77, 1024, device="meta"))
    assert launches.since(before) == {"softmax_attention.self": 16,
                                      "softmax_attention.cross": 16}


def test_one_self_and_one_cross_call_a_transformer_block():
    model = tiny_model()
    x, ctx, _ = inputs()
    before = launches.snapshot()
    with torch.no_grad():
        model(x, torch.tensor([1, 2]), ctx)
    n = len(transformer_blocks(model))
    assert n == 11 and launches.since(before) == {"softmax_attention.self": n,
                                                  "softmax_attention.cross": n}


def test_the_timestep_embedding_is_cos_first_over_half():
    t = torch.tensor([0, 7, 999])
    e = sd_unet.timestep_embedding(t, 8)
    freqs = [math.exp(-math.log(10000.0) * i / 4) for i in range(4)]
    want = [[math.cos(s * f) for f in freqs] + [math.sin(s * f) for f in freqs] for s in (0, 7, 999)]
    np.testing.assert_allclose(e.numpy(), np.array(want, np.float32), rtol=1e-5, atol=1e-5)


def test_plain_attention_in_blocks_is_the_whole_product(monkeypatch):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(2, 3, n, 8, generator=g) for n in (37, 11, 11))
    want = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(8), dim=-1) @ v
    monkeypatch.setattr(attention, "BLOCK_ELEMENTS", 2 * 3 * 11 * 5)
    got = attention.softmax_attention(q, k, v, "cross")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="kind"):
        attention.softmax_attention(q, k, v, "other")
    assert not attention.takes_fused(q) and not attention.takes_fused(q.bfloat16())


def _ldm(model, vae_weights=None):
    vae = Autoencoder(**TINY_VAE, dtype=model.dtype)
    if vae_weights is not None:
        vae.load_state_dict(vae_weights, strict=True)
    return LatentDiffusionModel(model, vae, SD_SCALING, T_STEPS, 0.00085, 0.012)


def test_v_ddim_with_a_context_null_matches_the_reference():
    """Three DDIM steps of the eager loop, CFG over contexts with a tensor
    null condition, then the decode: the port's images and latents against
    the reference's."""
    model = tiny_model()
    vw = weights.make(vae_shapes(TINY_VAE), 3, 2, "cpu")
    ldm = _ldm(model, vw)
    assert ldm.diffusion.parameterization == "v"
    x, ctx, null = inputs()
    shape = (SIDE, SIDE, 4)
    z0 = ldm.diffusion.sample_ddim(model, ctx, shape, n_sample_steps=DDIM_STEPS, cfg_scale=CFG,
                                   null_label=null, x_init=x)
    images = ldm.sample_images(ctx, shape, cfg_scale=CFG, sampler="ddim",
                               n_sample_steps=DDIM_STEPS, null_cond=null, x_init=x)
    sched = ref.Schedule(T_STEPS, "sqrt_linear", 0.00085, 0.012)
    with torch.no_grad():
        want = ref_txt2img.ddim_v(sched, RefSDUNet(tiny_weights(), TINY), x, ctx, null, CFG,
                                  DDIM_STEPS)
        want_images = RefVAE(vw, TINY_VAE).decode(want / SD_SCALING)
    assert rel_l2(z0, want) < DDIM_TOL
    assert rel_l2(images, want_images) < DDIM_TOL
    assert images.shape == (2, 2 * SIDE, 2 * SIDE, 3)


def test_a_v_prediction_gives_x0_and_eps_of_the_forward_process():
    d = GaussianDiffusion(T_STEPS, schedule="sqrt_linear", beta_start=0.00085, beta_end=0.012,
                          parameterization="v")
    g = torch.Generator().manual_seed(2)
    x0, eps = torch.randn(3, 4, 4, 2, generator=g), torch.randn(3, 4, 4, 2, generator=g)
    t = torch.tensor([0, 5, 9])
    v, xt, _ = d.noised(x0, t, eps)
    got_eps, got_x0 = d.from_v(xt, t, v)
    np.testing.assert_allclose(got_eps.numpy(), eps.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_x0.numpy(), x0.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="parameterization"):
        GaussianDiffusion(T_STEPS, parameterization="x0")


def test_the_eps_path_is_unchanged():
    """An eps model's DDIM: the reference's, and ``ddim_step`` without an
    x_0 is the update as it was written before v."""
    d = GaussianDiffusion(T_STEPS, schedule="sqrt_linear", beta_start=0.00085, beta_end=0.012)
    assert d.parameterization == "eps"
    lin = torch.nn.Linear(2, 2)

    def model(x, t, y):
        return lin(x) * 0.3 + (t.float() / 10 + y.float())[:, None, None, None]

    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 4, 4, 2, generator=g)
    y = torch.tensor([1, 3])
    with torch.no_grad():
        got = d.sample_ddim(model, y, (4, 4, 2), n_sample_steps=4, cfg_scale=2.0, null_label=9,
                            x_init=x)
        want = ref.ddim(ref.Schedule(T_STEPS, "sqrt_linear", 0.00085, 0.012), model, x, y, 9,
                        2.0, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    t, tp = torch.tensor([9, 9]), torch.tensor([6, 6])
    eps = torch.randn(2, 4, 4, 2, generator=g)
    ab, abp = d.schedule.alpha_bars[9], d.schedule.alpha_bars[6]
    old = torch.sqrt(abp) * ((x - torch.sqrt(1.0 - ab) * eps) * torch.rsqrt(ab)) \
        + torch.sqrt((1.0 - abp).clamp_min(0.0)) * eps
    assert torch.equal(d.ddim_step(x, t, tp, eps, None), old)


def test_every_decode_is_one_sampler_decode_record():
    ldm = _ldm(tiny_model())
    before = len(profiling.records("sampler.decode"))
    out = ldm.autoencoder_decode(torch.randn(3, 4, 4, 4))
    rs = profiling.records("sampler.decode")
    assert out.shape == (3, 8, 8, 3) and len(rs) == before + 1
    r = rs[-1]
    assert r["images"] == 3 and r["host_ns"] > 0 and r["events"] == () and not r["profiled"]
    assert profiling.event_ms(r["events"]) is None


def test_registry_resolves_the_source_configs_unet_target():
    assert registry.resolve("ldm.modules.diffusionmodules.openaimodel.UNetModel") \
        is sd_unet.SDUNet
    with pytest.raises(ValueError, match="linear"):
        sd_unet.SDUNet(**{**TINY, "use_linear_in_transformer": False})
