"""Tensor parallelism of the port (``parallel/tp.py``): the leaf rules held
against the JAX package's spec for spec, the plain attention block against
``linear_attention_block_xla_heads`` and, its heads split over two
processes, against the port's one-process block, and ``param_sharding`` tp
/ fsdp_tp through ``DiffusionTrainer.train()`` over (data=1, model=2) and
(2, 2) gloo groups against one process of the port.

Bars: the rules exactly; the block 1e-5 (the ops bar, fp32), its grads
2e-5 x each grad's max; training losses rtol 1e-5 and parameters atol 5e-3
(the JAX TP bars, ``tests/test_tp.py``); each step's gradient norm and the
final parameters' norm rtol 1e-5; checkpoints between a model axis and one
process bit for bit; the sampler 1e-4.  The tiny UNet is
``_torch_mp_worker.MODEL`` (channels 32, multipliers [1], 8 px, 4 heads).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

import _torch_mp_worker as w
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.ops.linear_attention import linear_attention_block_xla_heads
from ldm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ldm_tpu.parallel.tp import fsdp_tp_shardings, tp_shardings
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.ops.linear_attention import (
    linear_attention_block,
    linear_attention_block_torch,
)
from ldm_tpu_torch.parallel import tp
from ldm_tpu_torch.training import checkpoint as ckpt
from ldm_tpu_torch.utils.flax_import import unet_state_dict_from_params
from test_torch_port_multiprocess import assert_states_close, spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_tp.py's tree, each leaf beside the port's name and shape for
# it, and an attention whose projections a model axis of 4 does not divide
SMALL_TREE = [
    ("LinAttnBlock_0/qkv_kernel", (32, 384), "encoder.downs.0.1.fn.fn.to_qkv.weight",
     (384, 32, 1, 1)),
    ("LinAttnBlock_0/out_kernel", (128, 32), "encoder.downs.0.1.fn.fn.to_out.0.weight",
     (32, 128, 1, 1)),
    ("LinAttnBlock_0/norm_pre_scale", (32,), "encoder.downs.0.1.fn.norm.weight", (32,)),
    ("Attention_0/Dense_0/kernel", (32, 384), "bottleneck.attn.fn.fn.to_qkv.weight",
     (384, 32, 1, 1)),
    ("Attention_0/Dense_1/kernel", (128, 32), "bottleneck.attn.fn.fn.to_out.weight",
     (32, 128, 1, 1)),
    ("Attention_0/Dense_1/bias", (32,), "bottleneck.attn.fn.fn.to_out.bias", (32,)),
    ("ResNetBlock_0/Dense_0/kernel", (32, 32), "encoder.downs.0.0.mlp_t.1.weight", (32, 32)),
    ("Conv_0/kernel", (3, 3, 32, 32), "initial_conv.weight", (32, 32, 3, 3)),
    ("LinAttnBlock_1/qkv_kernel", (8, 6), "encoder.downs.1.1.fn.fn.to_qkv.weight", (6, 8, 1, 1)),
    ("LinAttnBlock_1/out_kernel", (6, 8), "encoder.downs.1.1.fn.fn.to_out.0.weight",
     (8, 6, 1, 1)),
]
CASES = [("tp", 2), ("fsdp_tp", 2), ("tp", 4), ("fsdp_tp", 4)]
IDS = ["tp_1x2", "fsdp_tp_1x2", "tp_2x2", "fsdp_tp_2x2"]


def jax_mesh(model: int):
    return jax_create_mesh(jax.devices()[:8], model=model)  # (8 / model, model)


def assert_same_split(want: tuple, flax_shape, got: tuple, torch_shape) -> bool:
    """JAX's spec on the flax shape and the port's on the torch shape split
    the same leaf the same way: both replicated, or the same axis on
    dimensions of the same extent (the layouts order them differently).
    True where the leaf is sharded."""
    assert bool(want) == bool(got), (want, got)
    if not want:
        return False
    (d, axis), = [(i, a) for i, a in enumerate(want) if a is not None]
    (e, axis2), = [(i, a) for i, a in enumerate(got) if a is not None]
    assert axis == axis2 and flax_shape[d] == torch_shape[e], (want, got)
    return True


@pytest.mark.parametrize("n", [1, 2, 4])
def test_tp_rule_matches_jax_on_the_test_tree(n):
    """tests/test_tp.py's tree: the attention projections (a LinAttnBlock's
    and the bottleneck Attention's) sharded, a ResNet block's time
    projection, biases, norms and convs replicated; at n=4 the narrow
    attention's 6 columns stay replicated; nothing at n=1."""
    tree = {}
    for path, shape, _, _ in SMALL_TREE:
        *scopes, leaf = path.split("/")
        node = tree
        for s in scopes:
            node = node.setdefault(s, {})
        node[leaf] = jnp.zeros(shape)
    specs = tp_shardings(jax_mesh(n), tree)
    sharded = 0
    for path, flax_shape, name, torch_shape in SMALL_TREE:
        node = specs
        for s in path.split("/"):
            node = node[s]
        got = tp.tp_leaf_spec(name.split("."), torch_shape, n)
        sharded += assert_same_split(tuple(node.spec), flax_shape, got, torch_shape)
    assert sharded == {1: 0, 2: 6, 4: 4}[n]


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("mode", ["tp", "fsdp_tp"])
def test_rules_match_jax_on_the_flagship_tree(mode, n):
    """Every leaf of the flagship UNet: JAX's ``tp_shardings`` /
    ``fsdp_tp_shardings`` over a (8/n, n) mesh against the port's rule on
    the leaf the weight bridge makes of it (each flax leaf filled with its
    own number, so the bridge's output names its source)."""
    params = dict(load_config(f"{ROOT}/configs/pixel_diffusion_model_cifar10.yaml").model.params)
    tree = jax.eval_shape(FlaxUNet(**params).init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                          jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32))
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rule = tp_shardings if mode == "tp" else fsdp_tp_shardings
    specs = jax.tree_util.tree_leaves(rule(jax_mesh(n), tree),
                                      is_leaf=lambda x: isinstance(x, NamedSharding))
    numbered = jax.tree_util.tree_unflatten(
        treedef, [np.full(x.shape, i + 1, np.float32) for i, x in enumerate(leaves)])
    sd = unet_state_dict_from_params(numbered)
    names = {k for k, _ in UNet(**params).named_parameters()}
    assert set(sd) == names
    counts = {"model": 0, "data": 0}
    for name, arr in sd.items():
        (i,) = np.unique(arr).astype(int) - 1
        if mode == "tp":
            got = tp.tp_leaf_spec(name.split("."), arr.shape, n)
        else:
            got = tp.fsdp_tp_leaf_spec(name.split("."), arr.shape, 8 // n, n)
        if i < 0:  # a leaf the bridge makes (a zero time MLP): replicated
            assert got == ()
            continue
        if assert_same_split(tuple(specs[i].spec), leaves[i].shape, got, arr.shape):
            counts["model" if "model" in got else "data"] += 1
    # 8 linear-attention sites and the bottleneck, two projections each
    assert counts["model"] == (0 if n == 1 else 18)
    assert (counts["data"] > 10) == (mode == "fsdp_tp")


def test_plain_attention_at_the_full_head_range_matches_xla_heads():
    """The plain block over all its heads (no group) is JAX's
    ``linear_attention_block_xla_heads``, the path JAX's TP takes (fp32,
    1e-5)."""
    (x, wqkv, wout, *vec), _ = w.heads_inputs()
    want = linear_attention_block_xla_heads(
        *(jnp.asarray(t.numpy()) for t in (x, wqkv, wout, *vec)), heads=4, dim_head=32)
    got = linear_attention_block_torch(x, wqkv, wout, *vec, heads=4, dim_head=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world size spawned once for the module."""
    cache = {}

    def get(world):
        if world not in cache:
            out = tmp_path_factory.mktemp(f"tp{world}")
            scenario = "tp+fsdp_tp+heads" if world == 2 else "tp+fsdp_tp"
            cache[world] = (spawn(scenario, world, out), out)
        return cache[world]
    return get


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One process of the port: the trainer's run, each step's gradient
    norm, the final parameters' norm and the whole state."""
    torch.set_num_threads(1)
    tr = w.tiny_trainer(w.tiny_config(tmp_path_factory.mktemp("ref")))
    grad_norms = w.record_grad_norms(tr)
    hist = tr.train()
    return {"history": hist, "grad_norms": grad_norms,
            "param_norm": float(tr.state.norm(tr.state.params())),
            "state": tr.state.state_dict()}


def test_heads_over_two_processes_match_the_one_process_block(runs):
    """The plain block on each process's two heads, *f* before and *g*
    after them: the port's
    one-process block (its plain forward and backward on the CPU) at 1e-5
    forward and 2e-5 x each grad's max backward; each process's weight
    grads are its heads' rows of the whole grads."""
    outs, _ = runs(2)
    (x, wqkv, wout, *vec), dy = w.heads_inputs()
    args = [t.clone().requires_grad_() for t in (x, wqkv, wout, *vec)]
    y = linear_attention_block(*args, heads=4, dim_head=32)
    (y * dy).sum().backward()
    grads = [a.grad for a in args]
    for r, o in enumerate(outs):
        h = o["heads"]
        np.testing.assert_allclose(h["y"].numpy(), y.detach().numpy(), atol=1e-5, rtol=0)
        dwq, dwo = w.head_share(grads[1], grads[2], r, 2)
        for got, want in zip(h["grads"], [grads[0], dwq, dwo, *grads[3:]]):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=2e-5 * float(want.abs().max()))


@pytest.mark.parametrize("part,world", CASES, ids=IDS)
def test_tp_training_matches_one_process(runs, reference, part, world):
    outs, _ = runs(world)
    want = reference["history"]
    for r, o in enumerate(outs):
        got = o[part]
        assert got["step"] == 6 and o["primary"] == (r == 0) and got["impls"] == {"torch"}
        np.testing.assert_allclose(got["history"]["train_loss"], want["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(got["history"]["val_loss"], want["val_loss"], rtol=1e-5)
        assert_states_close(got["state"], reference["state"], atol=5e-3)
        for k, v in outs[0][part]["state"]["model"].items():
            assert torch.equal(got["state"]["model"][k], v), k


@pytest.mark.parametrize("part,world", CASES, ids=IDS)
def test_tp_norms_match_one_process(runs, reference, part, world):
    """``TrainState.norm`` under the placement (the TP shares' squares
    summed over the model axis, FSDP shards' over the data axis, the
    replicated leaves counted once): each step's gradient norm, as the
    trainer logs it, and the final parameters' norm are one process's."""
    outs, _ = runs(world)
    for o in outs:
        got = o[part]
        assert len(got["grad_norms"]) == 6
        np.testing.assert_allclose(got["grad_norms"], reference["grad_norms"], rtol=1e-5)
        np.testing.assert_allclose(got["param_norm"], reference["param_norm"], rtol=1e-5)


@pytest.mark.parametrize("part,world", CASES, ids=IDS)
def test_each_process_holds_its_share_of_the_attention(runs, part, world):
    """The tiny UNet's 6 attention projections are half their width on
    every process; of the flagship's parameters each process holds the
    bytes the rule's arithmetic gives (TP: the attention leaves' half)."""
    outs, _ = runs(world)
    full = dict(UNet(**w.MODEL).named_parameters())
    for o in outs:
        got = o[part]
        assert len(got["shares"]) == 6
        for name, shape in got["shares"].items():
            dim = 0 if name.endswith("to_qkv.weight") else 1
            want = list(full[name].shape)
            want[dim] //= 2
            assert list(shape) == want, name
        assert got["flagship_bytes"] == got["flagship_bytes_expected"]
        if part == "tp":
            assert got["flagship_bytes"] == (got["flagship_bytes_replicated"]
                                             - got["attention_bytes"] // 2)


@pytest.mark.parametrize("part,world", CASES, ids=IDS)
def test_tp_checkpoints_round_trip_bit_for_bit(runs, part, world, tmp_path):
    """A model axis resumes from its own checkpoint bit for bit (model, EMA,
    Adam); under tp a one-process state loads and gathers back bit for bit,
    and the checkpoint the model axis wrote loads into one process bit for
    bit."""
    outs, out = runs(world)
    for o in outs:
        assert o[part]["resumed"]
        if part == "tp":
            assert o[part]["loaded"]
    if part == "tp":
        saved = ckpt.load_state(str(out / "run" / "tp" / "pixel" / "mp" / "checkpoints"
                                    / "state.pt"), map_location="cpu")
        one = w.tiny_trainer(w.tiny_config(tmp_path))
        one.state.load_state_dict(saved)
        assert w.same_state(one.state.state_dict(), saved)


@pytest.mark.parametrize("world", [2, 4], ids=["1x2", "2x2"])
def test_tp_sampler_matches_one_process(runs, world, tmp_path):
    """DDPM and DDIM from the EMA weights under TP (every process the whole
    grid): one process's draws from the same EMA at 1e-4."""
    outs, _ = runs(world)
    torch.set_num_threads(1)
    tr = w.tiny_trainer(w.tiny_config(tmp_path))
    tr.state.ema.load_state_dict(outs[0]["tp"]["state"]["ema"])
    for method in ("ddpm", "ddim"):
        want = tr.sample_x0([1, 2, 3], cfg_scale=3.0, method=method, ddim_steps=2)
        for o in outs:
            np.testing.assert_allclose(o["tp"]["x0"][method].numpy(), want.numpy(), atol=1e-4,
                                       err_msg=method)


def test_a_model_axis_that_does_not_split_the_heads_raises():
    """JAX's rule shards a qkv kernel of 384 columns over 3 (a contiguous
    block), but 4 heads do not split over 3 processes."""
    mesh = types.SimpleNamespace(model_size=3, model_rank=0, model_group=None)
    assert tp.tp_leaf_spec(["to_qkv", "weight"], (384, 32, 1, 1), 3)
    with pytest.raises(ValueError, match="heads"):
        tp.shard_module(UNet(**w.MODEL), mesh)


def test_the_kernel_path_refuses_a_block_whose_heads_are_split():
    """The fused kernels compute whole blocks: a block holding a model
    group takes the plain path or raises, never a partial kernel sum."""
    block = UNet(**w.MODEL).lin_attn_blocks()[0]
    block.fn.fn.model_group = object()
    x = torch.zeros(1, block.fn.norm.num_channels, 4, 4)
    with pytest.raises(ValueError, match="impl='torch'"):
        block(x)
