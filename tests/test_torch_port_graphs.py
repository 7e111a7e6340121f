"""What lets a CUDA graph replay the port's train step, tested on the CPU:
the EMA weight computed from a device step counter, the kernel-weight cache's
key under replays, the step split into draws and device work, and the
attention kernels' zero-padded narrow widths through their plain versions."""

import copy

import numpy as np
import pytest
import torch

from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.unet import LinAttnBlock, UNet
from ldm_tpu_torch.ops import linear_attention as la
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
from ldm_tpu_torch.training.state import TrainState, ema_decay_at, ema_decay_tensor
from ldm_tpu_torch.utils import graphs

MODEL = dict(in_channels=1, out_channels=1, channels=8, channel_multipliers=[1, 2],
             num_classes=10)
KW = dict(heads=4, dim_head=32)


@pytest.mark.parametrize("step", [0, 1, 8, 9, 100, 89_990, 89_991, 10**6])
def test_ema_decay_tensor_is_the_scalar_formula(step):
    """min(decay, (1 + step) / (10 + step)) in fp32 from a 0-d integer
    tensor: the very float the host formula gives."""
    got = ema_decay_tensor(0.9999, torch.tensor(step))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert float(got) == ema_decay_at(0.9999, step)


def test_tensor_form_ema_matches_scalar_form_over_20_steps():
    """20 updates: the state's tensor form (the weight from the device step
    counter, ``d*ema + (1-d)*params`` with 0-d tensors, as the fused pass
    has it) against the scalar form (Python floats, the same association),
    each leaf within 1e-7 of its largest entry."""
    torch.manual_seed(0)
    model = UNet(**MODEL)
    state = TrainState(model, lr=1e-3, ema_decay=0.9999)
    assert state.capturable is False  # CPU parameters: plain Adam
    ref = [p.detach().clone() for p in state.ema.parameters()]
    g = torch.Generator().manual_seed(1)
    for step in range(20):
        for p in model.parameters():
            p.grad = torch.randn(p.shape, generator=g) * 0.1
        state.apply_gradients()
        d = ema_decay_at(0.9999, step)
        torch._foreach_mul_(ref, d)
        torch._foreach_add_(ref, torch._foreach_mul([p.detach() for p in model.parameters()],
                                                    1.0 - d))
    assert state.step == 20 and int(state.step_t) == 20
    for (name, got), want in zip(state.ema.named_parameters(), ref):
        err = (got - want).abs().max().item()
        assert err <= 1e-7 * want.abs().max().item(), (name, err)


def test_update_and_count_are_apply_gradients():
    """``update`` is the device's part (it moves the device counter, not the
    host's), ``count_step`` the host's; a checkpoint keeps ``step`` an int and
    restores both counters."""
    torch.manual_seed(0)
    state = TrainState(UNet(**MODEL), lr=1e-3)
    for p in state.params():
        p.grad = torch.ones_like(p)
    state.update()
    assert state.step == 0 and int(state.step_t) == 1
    state.count_step()
    assert state.step == 1
    sd = copy.deepcopy(state.state_dict())
    assert type(sd["step"]) is int and sd["step"] == 1
    # a checkpoint from a CUDA run carries capturable=True: this device's holds
    for group in sd["optimizer"]["param_groups"]:
        group["capturable"] = True
    other = TrainState(UNet(**MODEL), lr=1e-3)
    other.load_state_dict(sd)
    assert other.step == 1 and int(other.step_t) == 1
    assert all(g["capturable"] is False for g in other.optimizer.param_groups)
    for p in other.params():
        p.grad = torch.ones_like(p)
    other.apply_gradients()  # a CPU optimizer that thought itself capturable would raise
    assert other.step == 2 and int(other.step_t) == 2


def test_cache_key_changes_on_a_replayed_step_with_versions_unchanged():
    """A replayed graph moves the weights without bumping a version counter;
    ``weights_replayed`` (what ``TrainState.count_replayed_step`` calls on
    both models) changes the cache's key all the same, so the next eager
    call makes new copies."""
    torch.manual_seed(0)
    model = UNet(**MODEL)
    blocks = model.lin_attn_blocks()
    assert len(blocks) == 4 and all(isinstance(b, LinAttnBlock) for b in blocks)
    block = blocks[0]
    wq = block.fn.fn.to_qkv.weight
    before = block.kernel_weights(torch.bfloat16)
    key, version = block._weights_key(), wq._version
    state_key, held = model.kernel_weights_state()
    assert held[0] is before and state_key[0] == key
    wq.data.mul_(2.0)  # what a replay does: new values, the same version
    assert wq._version == version and block._weights_key() == key
    assert block.kernel_weights(torch.bfloat16) is before  # stale, and not noticed
    model.weights_replayed()
    assert wq._version == version and block._weights_key() != key
    assert model.kernel_weights_state()[0] != state_key
    after = block.kernel_weights(torch.bfloat16)
    assert after is not before
    torch.testing.assert_close(after.wqkv_t[:, :8], wq.detach().view(-1, 8).to(torch.bfloat16),
                               rtol=0, atol=0)
    assert block.kernel_weights(torch.bfloat16) is after

    state = TrainState(model, lr=1e-3)
    ema_key = state.ema.kernel_weights_state()[0]
    state.count_replayed_step()
    assert state.step == 1
    assert state.ema.kernel_weights_state()[0] != ema_key
    assert block._weights_key() != after and block.replayed_steps == 2

    model.drop_kernel_weights()  # before a capture: the copies are made inside it
    assert all(b._kernel_w is None and b._kernel_w_key is None for b in blocks)
    assert block.kernel_weights(torch.bfloat16) is not after


def tiny_trainer(tmp_path, graphs_flag=None):
    cfg = Config(project_name="tiny", workdir=str(tmp_path), batch_size=4, use_amp=False,
                 model=ModelConfig(params=MODEL), diffusion=DiffusionConfig(n_steps=10),
                 data=DataConfig(dataset="SYNTHETIC", image_size=8, image_channels=1))
    torch.manual_seed(0)
    return DiffusionTrainer(cfg, UNet(**MODEL), GaussianDiffusion(10), None, None,
                            list(range(10)), device="cpu", graphs=graphs_flag)


def test_train_step_is_draws_then_device_step(tmp_path):
    """``train_step`` = the eager draws + ``_device_step`` on device tensors +
    the host's count: calling the parts by hand from the same state gives the
    same loss and weights bit for bit, and a CPU trainer counts only eager
    steps."""
    a, b = tiny_trainer(tmp_path / "a"), tiny_trainer(tmp_path / "b")
    assert a.graphs is False
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, (4, 8, 8, 1)).astype(np.float32),
             "label": rng.integers(0, 10, 4).astype(np.int32)}
    t = torch.tensor([0, 3, 5, 9])
    eps = torch.from_numpy(rng.standard_normal((4, 8, 8, 1)).astype(np.float32))
    drop = torch.tensor([True, False, False, True])
    out_a = a.train_step(batch, t=t, eps=eps, drop=drop)
    x0, y = b._batch(batch)
    out_b = b._device_step(x0, y, t, eps, drop)
    b.state.count_step()
    assert torch.equal(out_a["loss"], out_b["loss"])
    assert torch.equal(out_a["grad_norm"], out_b["grad_norm"])
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert a.state.step == b.state.step == 1
    assert a.step_counts == {"graphed": 0, "eager": 1}
    with pytest.raises(ValueError, match="CUDA graph needs a CUDA device"):
        tiny_trainer(tmp_path / "c", graphs_flag=True)


def test_graph_wrapper_counts_every_kernel_wrapper():
    """The launches a capture makes are added at every replay for every
    count of the registry (``utils/launches.py``): ``launch_counts`` names
    every hand-written kernel, and no sub-count."""
    from ldm_tpu_torch.ops import launch_counts

    counts = launch_counts()
    assert set(counts) == {"linear_attention_fwd", "linear_attention_bwd", "resnet_block_fwd",
                           "fused_adam_ema", "group_norm_silu"}
    assert all(isinstance(n, int) for n in counts.values())


# ---- the attention kernels' narrow widths (C = 8: configs/smoke_synthetic.yaml)

def narrow_inputs(b, n, c, dtype, seed):
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=dtype)

    x, dy = r(b, n, c), r(b, n, c)
    p = [r(c, 384) / c**0.5, r(128, c) / 128**0.5, 0.1 * r(c), 1 + 0.1 * r(c), 0.1 * r(c),
         1 + 0.1 * r(c), 0.1 * r(c)]
    return x, dy, p


def padded(x, dy, p, cp):
    """What the CUDA wrappers hand the kernels: zero columns up to ``cp``."""
    pad = la._pad_last
    return (pad(x, cp), pad(dy, cp),
            [pad(p[0].t(), cp).t(), pad(p[1], cp)] + [pad(v, cp) for v in p[2:]])


@pytest.mark.parametrize("c,want", [(8, 16), (16, 16), (24, 32), (64, 64), (72, 80)])
def test_pad_width(c, want):
    assert la.pad_width(c) == want


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("n,c", [(256, 8), (64, 8), (16, 24)])
def test_padded_forward_with_masked_statistics_is_the_narrow_forward(n, c, dtype, tol):
    """The kernels' treatment of a narrow width, through the plain version:
    zero-pad x, the projections and the five vectors to 16 columns and take
    GroupNorm's statistics over the true columns alone.  The true columns
    equal the plain version at the true width (1e-6 in fp32), the padded
    ones are exactly zero; zero padding alone is wrong (the padded columns
    enter the variance)."""
    x, dy, p = narrow_inputs(3, n, c, dtype, seed=n + c)
    cp = la.pad_width(c)
    xp, _, pp = padded(x, dy, p, cp)
    want = la.linear_attention_block_torch(x, *p, compute_dtype=dtype, **KW)
    got = la.linear_attention_block_torch(xp, *pp, compute_dtype=dtype, stat_c=c, **KW)
    assert (got[..., :c] - want).abs().max().item() <= tol * want.abs().max().item()
    assert got[..., c:].abs().max().item() == 0.0
    unmasked = la.linear_attention_block_torch(xp, *pp, compute_dtype=dtype, **KW)
    assert (unmasked[..., :c] - want).abs().max().item() > 1e-2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.float64, 1e-13)])
@pytest.mark.parametrize("n,c", [(256, 8), (16, 24)])
def test_padded_backward_with_masked_statistics_is_the_narrow_backward(n, c, dtype, tol):
    """Likewise the backward: every grad's true part within 1e-6 of its
    largest entry (fp32), every padded column and row exactly zero."""
    x, dy, p = narrow_inputs(3, n, c, dtype, seed=n + c + 1)
    cp = la.pad_width(c)
    xp, dyp, pp = padded(x, dy, p, cp)
    want = la.linear_attention_block_bwd_torch(x, dy, *p, compute_dtype=dtype, **KW)
    got = la.linear_attention_block_bwd_torch(xp, dyp, *pp, compute_dtype=dtype, stat_c=c, **KW)
    cuts = [(lambda t: t[..., :c], lambda t: t[..., c:]),   # dx
            (lambda t: t[:c], lambda t: t[c:]),              # dWqkv (C, 3H)
            (lambda t: t[:, :c], lambda t: t[:, c:])]        # dWout (H, C)
    cuts += [(lambda t: t[:c], lambda t: t[c:])] * 5          # the five vectors
    for name, g, w, (live, pad) in zip(("dx", "dwqkv", "dwout", "dbout", "dg1s", "dg1b",
                                        "dg2s", "dg2b"), got, want, cuts):
        assert (live(g) - w).abs().max().item() <= tol * w.abs().max().item(), name
        assert pad(g).abs().max().item() == 0.0, name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weights_come_padded_for_a_narrow_block(dtype):
    """``make_kernel_weights`` pads a C that is no multiple of 16 with zero
    columns; the argument check takes the narrow x beside them, C = 8 up in
    steps of 8, and still refuses other widths."""
    x, _, p = narrow_inputs(2, 16, 8, torch.float32, seed=3)
    w = la.make_kernel_weights(p[0], p[1], dtype)
    assert w.wqkv.shape == (16, 384) and w.wqkv_t.shape == (384, 16)
    assert w.wout.shape == (128, 16) and w.wout_t.shape == (16, 128)
    for t_ in w:
        assert t_.is_contiguous() and t_.dtype == dtype
    torch.testing.assert_close(w.wqkv[:8], p[0].to(dtype), rtol=0, atol=0)
    torch.testing.assert_close(w.wout_t[:8], p[1].t().to(dtype), rtol=0, atol=0)
    assert w.wqkv[8:].abs().max() == 0 and w.wout[:, 8:].abs().max() == 0
    with torch.no_grad():
        la._check_cuda_args(x.to(dtype), p, 4, 32, dtype, weights=w)
        la._check_cuda_args(x.to(dtype), p, 4, 32, dtype, max_c=la.MAX_C_BWD, weights=w)
        unpadded = la.KernelWeights(*(t_[..., :8] if t_.shape[-1] == 16 else t_[:8]
                                      for t_ in w))
        with pytest.raises(ValueError, match="kernel weight"):
            la._check_cuda_args(x.to(dtype), p, 4, 32, dtype, weights=unpadded)
        for bad in (4, 12, 6):
            xb = torch.zeros(1, 4, bad, dtype=dtype)
            pb = [torch.zeros(bad, 384), torch.zeros(128, bad)] + [torch.zeros(bad)] * 5
            with pytest.raises(ValueError, match="multiple of 8"):
                la._check_cuda_args(xb, pb, 4, 32, dtype)
    assert la.MAX_C_FWD == 768 and la.MAX_C_BWD == 512  # sampling takes wider than training


def test_smoke_config_unet_has_narrow_sites_and_runs_on_the_cpu():
    """configs/smoke_synthetic.yaml: attention sites at C = 8 and C = 16; its
    blocks hand the kernels 16-wide copies either way."""
    from ldm_tpu_torch.factory import build_model, load_config

    config = load_config("configs/smoke_synthetic.yaml")
    torch.manual_seed(0)
    model = build_model(config).eval()
    widths = sorted({b.fn.fn.to_out[0].weight.shape[0] for b in model.lin_attn_blocks()})
    assert widths == [8, 16]
    for b in model.lin_attn_blocks():
        w = b.kernel_weights(torch.float32, backward=True)
        assert w.wqkv.shape == (16, 384) and w.wout_t.shape == (16, 128)
    with torch.no_grad():
        out = model(torch.zeros(2, 16, 16, 1), torch.tensor([1, 2]), torch.tensor([3, 10]))
    assert out.shape == (2, 16, 16, 1) and torch.isfinite(out).all()
