"""The model layer's GroupNorm (+ SiLU) pass (ldm_tpu_torch/ops/group_norm.py)
on the CPU: the plain version is the chain the model layer ran before the
pass, bit for bit, at every site of the pixel UNet, the latent UNet and the
VAE; the dispatch sends a bf16 CUDA tensor outside autograd to the kernel
(a stand-in launcher here) and everything else to the plain chain; the
models' CPU forwards are unchanged; the launch plan covers every site.  The
kernel itself is checked on the card by chip_smoke.py."""

import math
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ldm_tpu_torch.models import autoencoder as ae
from ldm_tpu_torch.models import unet as um
from ldm_tpu_torch.ops import group_norm as gn
from ldm_tpu_torch.utils import launches

CL = torch.channels_last
PIXEL = dict(in_channels=3, out_channels=3, channels=64, channel_multipliers=(1, 2, 4, 8),
             num_classes=10)
LATENT = dict(in_channels=8, out_channels=8, channels=64, channel_multipliers=(1,),
              num_classes=10)
VAE = dict(in_channels=3, out_channels=3, channels=64, channel_multipliers=(1, 2, 4, 8),
           n_resnet_blocks=2, z_channels=8)

# (H*W, C, G, eps, silu) of every norm a forward runs: the pixel UNet at
# 32x32, the latent UNet over 4x4 latents, the VAE's encoder at 32x32 and its
# decoder from 4x4 latents (benchmark/configs/cifar10-*.json)
SITES = {
    "pixel": {(1024, 64, 8, 1e-5, True), (1024, 128, 8, 1e-5, True), (256, 64, 8, 1e-5, True),
              (256, 128, 8, 1e-5, True), (256, 192, 8, 1e-5, True), (64, 128, 8, 1e-5, True),
              (64, 256, 8, 1e-5, True), (64, 384, 8, 1e-5, True), (16, 256, 8, 1e-5, True),
              (16, 512, 8, 1e-5, True), (16, 768, 8, 1e-5, True), (4, 512, 8, 1e-5, True),
              (4, 512, 1, 1e-5, False)},
    "latent": {(16, 64, 8, 1e-5, True), (16, 128, 8, 1e-5, True), (4, 64, 8, 1e-5, True),
               (4, 64, 1, 1e-5, False)},
    "vae": {(1024, 64, 32, 1e-6, True), (1024, 128, 32, 1e-6, True),
            (256, 64, 32, 1e-6, True), (256, 128, 32, 1e-6, True), (256, 256, 32, 1e-6, True),
            (64, 128, 32, 1e-6, True), (64, 256, 32, 1e-6, True), (64, 512, 32, 1e-6, True),
            (16, 256, 32, 1e-6, True), (16, 512, 32, 1e-6, True),
            (16, 512, 32, 1e-6, False)},
}
ALL_SITES = sorted({s for v in SITES.values() for s in v})
# the 64px protocol's largest sites (configs/protocol_hard_64.yaml) and the
# smoke config's narrow ones (configs/smoke_synthetic.yaml: C = 8, 16)
MORE_SHAPES = [(4096, 64, 8), (4096, 128, 8), (1024, 8, 8), (256, 16, 8), (16384, 64, 8)]


def old_chain(x, weight, bias, groups, eps, silu):
    """The model layer's norm as it was written before the pass."""
    y = F.group_norm(x.float(), groups, weight, bias, eps).to(x.dtype, memory_format=CL)
    return F.silu(y) if silu else y


def site_inputs(hw, c, dtype, seed, b=2):
    g = torch.Generator().manual_seed(seed)
    side = math.isqrt(hw)
    x = (torch.randn(b, side, side, c, generator=g) * 3 + 0.5).to(dtype).permute(0, 3, 1, 2)
    weight = 1 + 0.5 * torch.randn(c, generator=g)
    bias = 0.5 * torch.randn(c, generator=g)
    return x, weight, bias


def recorded_sites(model, run) -> set:
    """(H*W, C, G, eps, silu) of every norm ``run()`` calls in ``model``."""
    seen = set()
    norms = [m for m in model.modules() if isinstance(m, um.GroupNorm)]
    for m in norms:
        def norm(x, silu, m=m, inner=m._norm):
            seen.add((x.shape[2] * x.shape[3], x.shape[1], m.num_groups, m.eps, silu))
            return inner(x, silu)
        m._norm = norm
    try:
        with torch.no_grad():
            run()
    finally:
        for m in norms:
            del m._norm
    return seen


@pytest.fixture(scope="module")
def models():
    with torch.random.fork_rng():
        torch.manual_seed(0)
        return {"pixel": um.UNet(**PIXEL), "latent": um.UNet(**LATENT),
                "vae": ae.Autoencoder(**VAE)}


def test_the_sites_are_the_models_norms(models):
    """SITES lists exactly the norms the three models' forwards run."""
    t, y = torch.tensor([3]), torch.tensor([1])
    pixel, latent, vae = models["pixel"], models["latent"], models["vae"]
    assert recorded_sites(pixel, lambda: pixel(torch.zeros(1, 32, 32, 3), t, y)) == SITES["pixel"]
    assert recorded_sites(latent, lambda: latent(torch.zeros(1, 4, 4, 8), t, y)) == \
        SITES["latent"]
    assert recorded_sites(vae, lambda: vae(torch.zeros(1, 32, 32, 3),
                                           torch.zeros(1, 4, 4, 8))) == SITES["vae"]


def test_group_norm_calls_counts_a_forwards_norms(models):
    """One launch a GroupNorm module a forward: 23 in the pixel UNet (22 in
    its ResNet blocks, 1 in the bottleneck's PreNorm), 11 in the latent one;
    the linear-attention blocks' pre-norms are the attention op's."""
    assert um.group_norm_calls(models["pixel"]) == 23
    assert um.group_norm_calls(models["latent"]) == 11
    sites = recorded_sites(models["latent"], lambda: models["latent"](
        torch.zeros(2, 4, 4, 8), torch.tensor([1, 2]), torch.tensor([0, 10])))
    assert sites == SITES["latent"]
    calls = []
    model = models["pixel"]
    norms = [m for m in model.modules() if isinstance(m, um.GroupNorm)]
    for m in norms:
        m._norm = lambda x, silu, inner=m._norm: calls.append(silu) or inner(x, silu)
    try:
        with torch.no_grad():
            model(torch.zeros(1, 32, 32, 3), torch.tensor([1]), torch.tensor([10]))
    finally:
        for m in norms:
            del m._norm
    assert len(calls) == 23 and calls.count(False) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", ALL_SITES, ids=lambda s: "hw{}_c{}_g{}_eps{:g}_{}".format(
    *s[:4], "silu" if s[4] else "norm"))
def test_plain_version_is_the_old_chain_bit_for_bit(site, dtype):
    """The plain version, and the module's CPU path, against the chain the
    model layer ran before, bit for bit, silu on and off."""
    hw, c, groups, eps, silu = site
    x, weight, bias = site_inputs(hw, c, dtype, seed=hw + c + groups)
    norm = um.GroupNorm(groups, c, eps=eps)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    for s in (silu, not silu):
        want = old_chain(x, weight, bias, groups, eps, s)
        got = gn.group_norm_silu_torch(x, weight, bias, groups, eps, s)
        assert got.dtype == dtype and got.is_contiguous(memory_format=CL)
        assert torch.equal(got, want)
        with torch.no_grad():
            mod = norm.forward_silu(x) if s else norm(x)
        assert torch.equal(mod, want)
    assert torch.equal(gn.group_norm_silu(x, weight, bias, groups, eps, silu),
                       old_chain(x, weight, bias, groups, eps, silu))


# ---- the dispatch, with a stand-in launcher -------------------------------

class FakeCuda(torch.Tensor):
    """A CPU tensor that says it lies on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def launcher(monkeypatch):
    """The kernel's launch replaced by a recorder that returns the plain
    version's output."""
    calls = []

    def launch(x, weight, bias, groups, eps, silu, plan=None):
        calls.append(types.SimpleNamespace(shape=tuple(x.shape), groups=groups, eps=eps,
                                           silu=silu))
        return old_chain(x.as_subclass(torch.Tensor), weight, bias, groups, eps, silu)

    monkeypatch.setattr(gn, "_launch_kernel", launch)
    before = launches.snapshot()
    yield calls
    launches.restore(before)


@pytest.mark.parametrize("silu", [False, True])
def test_a_bf16_cuda_tensor_outside_autograd_takes_the_kernel(launcher, silu):
    norm = um.GroupNorm(32, 64, eps=1e-6)
    x, _, _ = site_inputs(16, 64, torch.bfloat16, seed=1)
    before = launches.read(gn.LIB.name)
    with torch.no_grad():
        y = norm.forward_silu(x.as_subclass(FakeCuda)) if silu else norm(x.as_subclass(FakeCuda))
    assert [(c.shape, c.groups, c.eps, c.silu) for c in launcher] == \
        [((2, 64, 4, 4), 32, 1e-6, silu)]
    assert launches.read(gn.LIB.name) == before + 1
    assert torch.equal(y.as_subclass(torch.Tensor),
                       old_chain(x, norm.weight, norm.bias, 32, 1e-6, silu))
    with torch.inference_mode():
        norm(x.as_subclass(FakeCuda))
    assert len(launcher) == 2


@pytest.mark.parametrize("case", ["grad on", "fp32", "cpu"])
def test_everything_else_keeps_the_plain_chain(launcher, case):
    """Grad mode (every train step), an fp32 input and a CPU tensor take the
    chain as it was, and launch nothing."""
    norm = um.GroupNorm(8, 64, eps=1e-5)
    dtype = torch.float32 if case == "fp32" else torch.bfloat16
    x, _, _ = site_inputs(64, 64, dtype, seed=2)
    fake = x if case == "cpu" else x.as_subclass(FakeCuda)
    before = launches.read(gn.LIB.name)
    with torch.set_grad_enabled(case == "grad on"):
        y = norm.forward_silu(fake)
    assert launcher == [] and launches.read(gn.LIB.name) == before
    assert torch.equal(y.as_subclass(torch.Tensor).detach(),
                       old_chain(x, norm.weight, norm.bias, 8, 1e-5, True).detach())


def test_blocks_send_silu_and_the_prenorm_does_not(launcher):
    """A UNet Block's norm takes the pass with the SiLU; the bottleneck's
    PreNorm (GroupNorm(1)) without it."""
    block = um.Block(64, 64)
    pre = um.PreNorm(64, torch.nn.Identity())
    x, _, _ = site_inputs(16, 64, torch.bfloat16, seed=3)
    with torch.no_grad():
        block.conv2d = torch.nn.Identity()
        block(x.as_subclass(FakeCuda))
        pre(x.as_subclass(FakeCuda))
    assert [(c.groups, c.silu) for c in launcher] == [(8, True), (1, False)]


def test_the_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    """A CUDA tensor reaches the kernel or an error: an fp32 x, an x that is
    not channels_last, fp16 weights; no fallback."""
    x, w, b = site_inputs(16, 64, torch.bfloat16, seed=4)
    for bad, why in [((x.float(), w, b), "bf16 channels_last"),
                     ((x.contiguous(), w, b), "bf16 channels_last"),
                     ((x, w.half(), b), "fp32")]:
        with pytest.raises(ValueError, match=why):
            gn._check(*bad)
    with pytest.raises(ValueError, match="no GroupNorm implementation"):
        gn.group_norm_silu(x.to("meta"), w, b, 8, 1e-5)


# ---- the models' CPU forwards -----------------------------------------------

def with_old_norms(model):
    """``model``'s norms put back to the chain as it was written."""
    for m in model.modules():
        if isinstance(m, um.GroupNorm):
            m._norm = lambda x, silu, m=m: old_chain(x, m.weight, m.bias, m.num_groups,
                                                     m.eps, silu)
    return model


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_unet_and_vae_forwards_on_the_cpu_are_unchanged(dtype):
    g = torch.Generator().manual_seed(5)
    with torch.random.fork_rng():
        torch.manual_seed(5)
        unet = um.UNet(in_channels=3, out_channels=3, channels=16, channel_multipliers=(1, 2),
                       num_classes=4, dtype=dtype)
        vae = ae.Autoencoder(in_channels=3, out_channels=3, channels=16,
                             channel_multipliers=(1, 2), n_resnet_blocks=1, z_channels=4,
                             dtype=dtype)
    x = torch.randn(2, 16, 16, 3, generator=g)
    eps = torch.randn(2, 8, 8, 4, generator=g)
    t, y = torch.tensor([5, 9]), torch.tensor([1, 4])
    with torch.no_grad():
        new = (unet(x, t, y), *vae(x, eps))
        old = (with_old_norms(unet)(x, t, y), *with_old_norms(vae)(x, eps))
    for a, b in zip(new, old):
        assert torch.equal(a, b)


# ---- the launch plan --------------------------------------------------------

def covered(hw, plan) -> np.ndarray:
    """How often the plan's (CTA rank, row, chunk) walk visits each pixel of
    an item: slot = rank * pi + row, pixel = slot + j * cs * pi, j < k."""
    hits = np.zeros(hw, np.int64)
    slots = np.arange(plan.cs * plan.pi)
    for j in range(plan.k):
        p = slots + j * plan.cs * plan.pi
        np.add.at(hits, p[p < hw], 1)
    return hits


@pytest.mark.parametrize("shape", sorted({s[:3] for s in ALL_SITES}) + MORE_SHAPES,
                         ids=lambda s: "hw{}_c{}_g{}".format(*s))
def test_plan_covers_every_site_within_shared_memory(shape):
    hw, c, groups = shape
    plan = gn.plan_group_norm(hw, c, groups)
    assert plan.smem == gn.smem_bytes(c, groups, plan.cs, plan.items, plan.pi)
    assert plan.smem <= gn.SMEM_LIMIT == 232448
    assert plan.threads == plan.items * plan.pi * c // 8 <= gn.MAX_THREADS
    assert plan.cs in (1, 2, 4, 8) and (plan.cs == 1 or plan.items == 1)
    assert plan.kr in (1, 2, 4, 8, 16) and plan.kr >= min(plan.k, gn.MAX_KR)
    assert plan.items == 1 or plan.pi == hw
    assert (covered(hw, plan) == 1).all()
    # the plan is the shape's alone: every item of every batch takes the same
    assert gn.plan_group_norm(hw, c, groups) == plan


def test_plan_holds_the_flagship_items_in_registers():
    """Every site of the three models holds its chunks in registers (x read
    once); the 32x32 sites spread an item over a cluster; the latent UNet's
    2x2 sites put several items in one CTA."""
    for hw, c, groups, _, _ in ALL_SITES:
        plan = gn.plan_group_norm(hw, c, groups)
        assert plan.k <= plan.kr, (hw, c, plan)
        assert plan.cs > 1 or hw <= 256, (hw, c, plan)
    assert gn.plan_group_norm(4, 64, 8).items == 4
    assert gn.plan_group_norm(1024, 128, 8).cs == 8


@pytest.mark.parametrize("c, groups", [(12, 4), (64, 7), (0, 1), (8200, 8)])
def test_plan_refuses_what_the_kernel_does_not_take(c, groups):
    with pytest.raises(ValueError, match="GroupNorm kernel"):
        gn.plan_group_norm(16, c, groups)


# the plans at every norm site of the benchmark's four earlier cells (the
# pixel UNet, the latent UNet and the VAE at the cifar10 configurations'
# shapes), as the pass was tuned for them: GnPlan(cs, items, pi, k, kr,
# threads, smem)
FROZEN_PLANS = {
    (4, 64, 1): (1, 4, 4, 1, 1, 128, 7200), (4, 64, 8): (1, 4, 4, 1, 1, 128, 7424),
    (4, 512, 1): (1, 1, 4, 1, 1, 256, 14344), (4, 512, 8): (1, 1, 4, 1, 1, 256, 14400),
    (16, 64, 8): (1, 1, 16, 1, 1, 128, 4928), (16, 128, 8): (1, 1, 16, 1, 1, 256, 9792),
    (16, 256, 8): (1, 1, 8, 2, 2, 256, 11328), (16, 256, 32): (1, 1, 8, 2, 2, 256, 11520),
    (16, 512, 8): (1, 1, 4, 4, 4, 256, 14400), (16, 512, 32): (1, 1, 4, 4, 4, 256, 14592),
    (16, 768, 8): (1, 1, 2, 8, 8, 192, 15424), (64, 128, 8): (1, 1, 16, 4, 4, 256, 9792),
    (64, 128, 32): (1, 1, 16, 4, 4, 256, 9984), (64, 256, 8): (1, 1, 8, 8, 8, 256, 11328),
    (64, 256, 32): (1, 1, 8, 8, 8, 256, 11520), (64, 384, 8): (2, 1, 4, 8, 8, 192, 13888),
    (64, 512, 32): (2, 1, 4, 8, 8, 256, 18688), (256, 64, 8): (1, 1, 32, 8, 8, 256, 9024),
    (256, 64, 32): (1, 1, 32, 8, 8, 256, 9216), (256, 128, 8): (2, 1, 16, 8, 8, 256, 10816),
    (256, 128, 32): (2, 1, 16, 8, 8, 256, 11008), (256, 192, 8): (4, 1, 8, 8, 8, 192, 10048),
    (256, 256, 32): (4, 1, 8, 8, 8, 256, 13568), (1024, 64, 8): (4, 1, 32, 8, 8, 256, 9536),
    (1024, 64, 32): (4, 1, 32, 8, 8, 256, 9728), (1024, 128, 8): (8, 1, 16, 8, 8, 256, 10816),
    (1024, 128, 32): (8, 1, 16, 8, 8, 256, 11008),
}


def test_plans_at_the_earlier_cells_sites_are_unchanged():
    """A plan for larger items (Stable Diffusion's) leaves every site of the
    pixel and latent cells as it was."""
    assert {s[:3] for s in ALL_SITES} == set(FROZEN_PLANS)
    for (hw, c, g), plan in FROZEN_PLANS.items():
        assert tuple(gn.plan_group_norm(hw, c, g)) == plan, (hw, c, g)
