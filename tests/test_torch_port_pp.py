"""Pipeline parallelism of the port (``parallel/pp.py``) across real
processes on the CPU, held against the JAX package's ``ldm_tpu/parallel/pp.py``
and against one process of the port.

The UNet and inputs are ``tests/test_pp.py``'s (channels 8, multipliers
(1, 2), 1 channel, 10 classes, 8 x 8, labels with the null label 10), its
flax weights bridged by ``utils/flax_import.py``:

* the split by name, the payload's packing and size, and ``UNet.encode`` /
  ``UNet.decode`` against JAX's ``unet_stage0`` / ``unet_stage1`` (2e-5);
  ``decode(*encode(...))`` is ``forward`` bit for bit;
* over (data=1, model=2) and (2, 2) gloo groups of ``tests/_torch_mp_worker.py``
  (scenario ``pp``) at M = 1, 2 and 4 microbatches: the forward against
  JAX's ``pipeline_unet_apply`` on the (4, 2) CPU mesh at JAX's bar (rtol
  1e-4 / atol 2e-6), each stage's gradients against JAX's one-device
  ``jax.grad`` split by stage (rtol 2e-4 / atol 1e-6: the bar JAX's test
  holds its pipeline to), the 4-step ancestral sampler through
  ``make_pp_apply`` against the one-process port and JAX's
  ``GaussianDiffusion.sample`` fed the same draws (rtol 1e-4 / atol 1e-5);
* each process's parameters are its stage's, the weights gather back bit
  for bit, and three Adam steps at M = 2 stay with one process (losses and
  gradient norms rtol 1e-5);
* bad microbatching and a model axis other than 2 raise.
"""

import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mp_worker as w
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ldm_tpu.parallel.pp import (
    pipeline_unet_apply as jax_pipeline,
    pp_pack_params,
    split_unet_params,
    tree_size,
    unet_stage0,
    unet_stage1,
)
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.parallel import pp
from ldm_tpu_torch.utils.flax_import import unet_from_flax
from ldm_tpu_torch.utils.logging import global_norm
from test_torch_port_multiprocess import spawn

SETUP = dict(in_channels=1, out_channels=1, channels=8, channel_multipliers=[1, 2],
             num_classes=10)
SHAPE = (8, 8, 1)
N_STEPS = 4
WORLDS = {2: "1x2", 4: "2x2"}
CASES = [(world, m) for world in WORLDS for m in w.PP_MICROBATCHES]
CASE_IDS = [f"{WORLDS[world]}-M{m}" for world, m in CASES]


def _inputs(b: int):
    """``tests/test_pp.py``'s inputs of ``b`` items (null labels included)."""
    x = jax.random.normal(jax.random.key(1), (b,) + SHAPE, jnp.float32)
    t = jax.random.randint(jax.random.key(2), (b,), 0, 100)
    y = (jnp.arange(b, dtype=jnp.int32) * 3) % 11
    return x, t, y


def _torch(*arrays):
    """numpy copies as tensors, integers as int64 (the port's labels and steps)."""
    out = [torch.from_numpy(np.array(a)) for a in arrays]
    return [a.long() if a.dtype == torch.int32 else a for a in out]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's side, once: the weights, the stage functions, the
    pipeline's forward on the (4, 2) mesh, the one-device gradients, the
    sampler and its draws; and the inputs the port's processes read."""
    model = FlaxUNet(**SETUP)
    x16, t16, y16 = _inputs(16)
    params = jax.device_get(jax.jit(model.init)(jax.random.key(0), x16[:1], t16[:1], y16[:1]))
    mesh = jax_create_mesh(model=2)
    stack = pp_pack_params(mesh, model, params)
    fwd = jax.jit(lambda s, x, t, y: jax_pipeline(
        mesh, type(stack)(s, stack.templates, model), x, t, y, n_microbatches=4))(
        stack.stacked, x16, t16, y16)

    x8, t8, y8 = _inputs(8)
    target = jax.random.normal(jax.random.key(7), x8.shape, jnp.float32)
    grads = jax.jit(jax.grad(lambda p: jnp.mean((model.apply(p, x8, t8, y8) - target) ** 2)))(
        params)
    p0, p1 = split_unet_params(model, params)
    mid, skips, temb = jax.jit(lambda p, x, t, y: unet_stage0(model, p, x, t, y))(
        p0, x8, t8, y8)
    eps = jax.jit(lambda p, m, s, e: unet_stage1(model, p, m, s, e))(p1, mid, skips, temb)

    # the ancestral sampler, and its draws (ddpm.py sample: split, then
    # fold_in per step) for the port
    classes = jnp.arange(8, dtype=jnp.int32) % 10
    key = jax.random.key(5)
    diffusion = JaxDiffusion(n_steps=N_STEPS)
    x0 = jax.jit(lambda p, k, c: diffusion.sample(model.apply, p, k, c, SHAPE, cfg_scale=3.0,
                                                  null_label=10))(params, key, classes)
    key_init, key_loop = jax.random.split(key)
    x_init = jax.random.normal(key_init, (8,) + SHAPE, jnp.float32)
    noise = {t: torch.from_numpy(np.array(jax.random.normal(
        jax.random.fold_in(key_loop, t), (8,) + SHAPE, jnp.float32))) for t in range(N_STEPS)}

    g = torch.Generator().manual_seed(3)
    steps = [(torch.rand(8, *SHAPE, generator=g) * 2 - 1, torch.randint(0, 10, (8,), generator=g),
              torch.randint(0, N_STEPS, (8,), generator=g), torch.randn(8, *SHAPE, generator=g),
              torch.rand(8, generator=g) < 0.3) for _ in range(3)]
    state_dict = unet_from_flax(params)
    return {
        "state_dict": state_dict, "p0_size": tree_size(p0), "p1_size": tree_size(p1),
        "fwd": np.asarray(fwd), "grads": unet_from_flax(jax.device_get(grads)),
        "stage0": [np.asarray(a) for a in (mid, *skips, temb)], "stage1": np.asarray(eps),
        "x0": np.asarray(x0),
        "pp_in": {"model": SETUP, "state_dict": state_dict,
                  "fwd": _torch(x16, t16, y16), "grad": _torch(x8, t8, y8, target),
                  "sample": {"n_steps": N_STEPS, "classes": _torch(classes)[0], "shape": SHAPE,
                             "x_init": _torch(x_init)[0], "noise": noise},
                  "train": {"steps": steps, "lr": 1e-3, "n_steps": N_STEPS}},
    }


def whole_unet(ref) -> UNet:
    model = UNet(**SETUP)
    model.load_state_dict(ref["state_dict"], strict=True)
    return model


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Each world size's processes, spawned once for the module."""
    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"pp{world}")
            torch.save(ref["pp_in"], out / "pp_in.pt")
            cache[world] = [o["pp"] for o in spawn("pp", world, out)]
        return cache[world]
    return get


@pytest.fixture(scope="module")
def one_process(ref):
    """The port's whole UNet in one process: the sampler and three Adam
    steps on the same draws."""
    torch.set_num_threads(1)
    inp = ref["pp_in"]
    smp = inp["sample"]
    x0 = GaussianDiffusion(N_STEPS).sample(
        whole_unet(ref), smp["classes"], SHAPE, cfg_scale=3.0, null_label=10,
        x_init=smp["x_init"], noise=smp["noise"].__getitem__)
    model = whole_unet(ref)
    params = list(model.parameters())
    tr = inp["train"]
    losses, norms = w.diffusion_steps(model, params, tr["steps"], tr["lr"], tr["n_steps"], 10,
                                      lambda: global_norm([p.grad for p in params]))
    return {"x0": x0, "losses": losses, "norms": norms,
            "state": copy.deepcopy(model.state_dict())}


# ------------------------------------------------------------- one process
def test_split_partitions_names(ref):
    """The counterpart of test_pp.py's split test: the stages partition the
    names, hold the parameters JAX's split gives each, and an unknown name
    raises."""
    sd = ref["state_dict"]
    s0, s1 = pp.split_unet_state_dict(sd)
    assert not s0.keys() & s1.keys() and s0.keys() | s1.keys() == sd.keys()
    assert {"time_emb.time_mlp.1.weight", "label_emb.weight", "initial_conv.weight",
            "bottleneck.attn.fn.fn.to_qkv.weight"} <= s0.keys()
    assert {"final_conv.1.weight", "decoder.ups.0.2.weight"} <= s1.keys()
    assert sum(v.numel() for v in s0.values()) == ref["p0_size"]
    assert sum(v.numel() for v in s1.values()) == ref["p1_size"]
    with pytest.raises(ValueError, match="no stage"):
        pp.split_unet_state_dict({**sd, "extra.weight": torch.zeros(1)})


@pytest.mark.parametrize("b", [1, 3])
def test_payload_roundtrip(ref, b):
    """Pack and unpack bit for bit, the size from the architecture equal to
    the packed one, and the activations unpacked as NCHW views of NHWC
    memory, as encode made them."""
    model = whole_unet(ref)
    x, t, y = (a[:b] for a in ref["pp_in"]["fwd"])
    with torch.no_grad():
        mid, skips, temb = model.encode(x, t, y)
        buf = pp.pack_payload(mid, skips, temb)
        shapes = pp.payload_shapes(model, b, 8, 8)
        assert buf.numel() == sum(int(np.prod(s)) for s in shapes)
        assert buf.dtype == model.dtype
        mid2, skips2, temb2 = pp.unpack_payload(buf, shapes)
        for a, a2 in zip((mid, *skips, temb), (mid2, *skips2, temb2)):
            assert a.shape == a2.shape and torch.equal(a, a2)
            if a.dim() == 4:
                assert a2.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(model.decode(mid2, skips2, temb2), model.decode(mid, skips, temb))


def test_stages_match_jax(ref):
    """encode against unet_stage0 (h_mid, each skip, t_emb) and decode on
    JAX's stage-0 outputs against unet_stage1, at 2e-5; decode(*encode) is
    forward bit for bit."""
    model = whole_unet(ref)
    x, t, y, _ = ref["pp_in"]["grad"]
    with torch.no_grad():
        mid, skips, temb = model.encode(x, t, y)
        got = [a.permute(0, 2, 3, 1) for a in (mid, *skips)] + [temb]
        for a, want in zip(got, ref["stage0"]):
            np.testing.assert_allclose(a.numpy(), want, atol=2e-5)
        jm, *js, jt = (torch.from_numpy(a.copy()) for a in ref["stage0"])
        eps = model.decode(jm.permute(0, 3, 1, 2), [s.permute(0, 3, 1, 2) for s in js], jt)
        np.testing.assert_allclose(eps.numpy(), ref["stage1"], atol=2e-5)
        assert torch.equal(model.decode(mid, skips, temb), model(x, t, y))


def fake_mesh(model_size: int, size: int = 1):
    """A mesh's place without a process group: what the checks read."""
    return types.SimpleNamespace(model_size=model_size, size=size, model_rank=0,
                                 model_group=None, local_rows=lambda a: a)


def test_bad_microbatching_raises(ref):
    """The counterpart of test_pp.py's refusal: a batch that does not split
    into M microbatches, or a microbatch that does not split over the data
    axis; and a gradient asked of the input."""
    model = whole_unet(ref)
    x, t, y = ref["pp_in"]["fwd"]  # 16 items
    with pytest.raises(ValueError, match="microbatches"):
        pp.pipeline_unet_apply(fake_mesh(2), model, x, t, y, 3)
    with pytest.raises(ValueError, match="data axis"):
        pp.pipeline_unet_apply(fake_mesh(2, size=3), model, x, t, y, 2)
    with pytest.raises(ValueError, match="input"):
        pp.pipeline_unet_apply(fake_mesh(2), model, x.clone().requires_grad_(), t, y, 2)


@pytest.mark.parametrize("model_size", [1, 4])
def test_model_axis_other_than_two_raises(ref, model_size):
    x, t, y = ref["pp_in"]["fwd"]
    with pytest.raises(ValueError, match="2 stages"):
        pp.pp_stage(fake_mesh(model_size), whole_unet(ref))
    with pytest.raises(ValueError, match="2 stages"):
        pp.pipeline_unet_apply(fake_mesh(model_size), whole_unet(ref), x, t, y, 2)


# --------------------------------------------------------------- processes
@pytest.mark.parametrize("world,m", CASES, ids=CASE_IDS)
def test_pipeline_forward_matches_jax(runs, ref, world, m):
    for o in runs(world):
        np.testing.assert_allclose(o["fwd"][m].numpy(), ref["fwd"], rtol=1e-4, atol=2e-6)


@pytest.mark.parametrize("world,m", CASES, ids=CASE_IDS)
def test_pipeline_grads_match_jax(runs, ref, world, m):
    """Each process's gradients are its stage's leaves of JAX's one-device
    gradients."""
    for o in runs(world):
        got = o["grads"][m]
        assert got.keys() == set(o["names"])
        for name, g in got.items():
            np.testing.assert_allclose(g.numpy(), ref["grads"][name].numpy(), rtol=2e-4,
                                       atol=1e-6, err_msg=name)


@pytest.mark.parametrize("world", list(WORLDS), ids=list(WORLDS.values()))
def test_stage_holds_its_parameters(runs, ref, world):
    """A process holds exactly its stage's parameters, and the weights
    gather back to the whole UNet's bit for bit on every process."""
    split = pp.split_unet_state_dict(ref["state_dict"])
    for r, o in enumerate(runs(world)):
        part = split[r % 2]
        assert sorted(o["names"]) == sorted(part)
        assert o["bytes"] == sum(v.nbytes for v in part.values())
        assert o["gathered"].keys() == ref["state_dict"].keys()
        for k, v in ref["state_dict"].items():
            assert torch.equal(o["gathered"][k], v), k


@pytest.mark.parametrize("world,m", CASES, ids=CASE_IDS)
def test_pp_sampler_matches_one_process_and_jax(runs, ref, one_process, world, m):
    for o in runs(world):
        np.testing.assert_allclose(o["x0"][m].numpy(), one_process["x0"].numpy(), rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(o["x0"][m].numpy(), ref["x0"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("world", list(WORLDS), ids=list(WORLDS.values()))
def test_adam_steps_match_one_process(runs, one_process, world):
    """Three steps of the diffusion trainer's loss and Adam at M = 2: losses
    and each step's gradient norm at rtol 1e-5, the weights gathered after
    them at atol 5e-3 (the JAX data-parallel bar)."""
    for o in runs(world):
        losses, norms = o["train"]
        np.testing.assert_allclose(losses, one_process["losses"], rtol=1e-5)
        np.testing.assert_allclose(norms, one_process["norms"], rtol=1e-5)
        for k, v in one_process["state"].items():
            np.testing.assert_allclose(o["train_state"][k].numpy(), v.numpy(), atol=5e-3,
                                       err_msg=k)
