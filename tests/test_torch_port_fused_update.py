"""The port's one-pass Adam + EMA update held against the JAX package.

``ldm_tpu_torch/ops/fused_adam_ema.py`` (the plain version and the kernel's
wrapper), ``TrainState.update`` and ``fused_apply_gradients`` in
``ldm_tpu_torch/training/state.py`` against ``fused_apply_gradients`` and
``TrainState.apply_gradients`` (the optax chain) of
``ldm_tpu/training/state.py``: the same leaves and gradients, made with numpy,
over chained steps from step 0 (the first bias correction, the EMA warmup),
compared at the JAX test's own tolerance (``tests/test_training.py``: atol
1e-6).  The drift guard, a state without an EMA, checkpoints written by the
``foreach`` Adam the port used before, and the kernel path's table and
version counters with the library replaced by a stand-in that writes through
the table's raw addresses as the kernel does (there is no card here).
"""

import contextlib
import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from ldm_tpu.training.state import TrainState as JaxState
from ldm_tpu.training.state import fused_apply_gradients as jax_fused
from ldm_tpu.training.state import make_optimizer
from ldm_tpu_torch.models.unet import LinAttnBlock
from ldm_tpu_torch.ops import fused_adam_ema as fa
from ldm_tpu_torch.training import state as state_mod
from ldm_tpu_torch.training.state import TrainState, ema_decay_at, fused_apply_gradients
from ldm_tpu_torch.utils import launches

LR, STEPS, ATOL = 3e-3, 4, 1e-6
# (7, 5), (5,) and (3,) as the JAX test has them, and one of odd numel no
# multiple of 4 wide
SHAPES = {"w": (7, 5), "b": (5,), "c": (3,), "odd": (9, 13)}
PLAIN = fa.fused_adam_ema_torch  # the plain version, whatever a test patches


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Leaves(nn.Module):
    def __init__(self, arrays: dict):
        super().__init__()
        for name, a in arrays.items():
            self.register_parameter(name, nn.Parameter(torch.from_numpy(a.copy())))


def leaves(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}


def grads_at(step: int) -> dict:
    rng = np.random.default_rng(100 + step)
    return {k: (0.1 * rng.standard_normal(s)).astype(np.float32) for k, s in SHAPES.items()}


def jax_states(arrays: dict, how: str):
    """The JAX states after each of STEPS steps (``how``: the fused pass or
    the optax chain)."""
    state = JaxState.create({k: jnp.asarray(a) for k, a in arrays.items()},
                            make_optimizer(LR), jax.random.key(0))
    out = []
    for i in range(STEPS):
        g = {k: jnp.asarray(a) for k, a in grads_at(i).items()}
        state = jax_fused(state, g, LR) if how == "fused" else state.apply_gradients(g)
        out.append(state)
    return out


def set_grads(model: nn.Module, step: int) -> None:
    for name, p in model.named_parameters():
        p.grad = torch.from_numpy(grads_at(step)[name])


def assert_matches_jax(state: TrainState, want, ema: bool = True) -> None:
    """Params, EMA, moments and count of the port's state against a JAX state."""
    adam = want.opt_state[0]
    emas = dict(state.ema.named_parameters()) if ema else {}
    for name, p in state.model.named_parameters():
        st = state.optimizer.state[p]
        pairs = [("param", p, want.params[name]), ("exp_avg", st["exp_avg"], adam.mu[name]),
                 ("exp_avg_sq", st["exp_avg_sq"], adam.nu[name])]
        if ema:
            pairs.append(("ema", emas[name], want.ema_params[name]))
        for what, got, w in pairs:
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(w), rtol=0, atol=ATOL,
                                       err_msg=f"{name} {what}")
        assert float(st["step"]) == int(adam.count)
    assert state.step == int(want.step) == int(state.step_t)


@pytest.mark.parametrize("entry", ["fused_apply_gradients", "apply_gradients"])
@pytest.mark.parametrize("how", ["fused", "optax"])
def test_plain_pass_matches_jax_over_chained_steps(how, entry):
    """Four chained steps from step 0 through the port's pass (the function
    or the state's method; the plain version on the CPU) against JAX's fused
    pass and the optax chain, each step: params, EMA, m, v, count at 1e-6."""
    arrays = leaves()
    want = jax_states(arrays, how)
    state = TrainState(Leaves(arrays), LR)
    for i in range(STEPS):
        set_grads(state.model, i)
        if entry == "fused_apply_gradients":
            fused_apply_gradients(state, LR)
        else:
            state.apply_gradients()
        assert_matches_jax(state, want[i])


@pytest.mark.parametrize("kw,raises", [
    ({"lr": 5e-4}, True),
    ({"b1": 0.95}, True),
    ({"lr": 5e-4, "b1": 0.95}, True),
    ({"b2": 0.99}, True),
    ({"eps": 1e-6}, True),
    ({}, False),
])
def test_drift_guard(kw, raises):
    """Hyperparameters other than the state's Adam holds raise (a wrong lr
    alone too, as ``tests/test_training.py`` asks of the JAX guard) and move
    nothing; the state's own pass."""
    arrays = leaves()
    state = TrainState(Leaves(arrays), LR)
    set_grads(state.model, 0)
    args = dict(lr=LR) | kw
    if raises:
        with pytest.raises(AssertionError, match="fused pass was given"):
            fused_apply_gradients(state, **args)
        assert state.step == 0 and int(state.step_t) == 0
        for name, p in state.model.named_parameters():
            assert torch.equal(p.detach(), torch.from_numpy(arrays[name]))
            assert float(state.optimizer.state[p]["step"]) == 0
    else:
        fused_apply_gradients(state, **args)
        assert_matches_jax(state, jax_states(arrays, "fused")[0])


def test_state_without_ema_matches_jax_params_and_moments():
    """``ema=False`` (the classifier's and the VAE's states): params, m, v and
    count as JAX's fused pass has them over four steps; no EMA exists."""
    arrays = leaves()
    want = jax_states(arrays, "fused")
    state = TrainState(Leaves(arrays), LR, ema=False)
    assert state.ema is None
    for i in range(STEPS):
        set_grads(state.model, i)
        fused_apply_gradients(state, LR)
        assert_matches_jax(state, want[i], ema=False)


def foreach_state_dict(arrays: dict, steps: int) -> dict:
    """A ``TrainState.state_dict()`` as the port wrote it before this pass:
    ``torch.optim.Adam(foreach=True)`` and the EMA as ``ema*d`` then
    ``addcmul_(params, 1-d)``, ``steps`` steps from step 0."""
    model = Leaves(arrays)
    ema = Leaves(arrays).requires_grad_(False)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8,
                           foreach=True)
    for i in range(steps):
        set_grads(model, i)
        opt.step()
        with torch.no_grad():
            d = torch.tensor(ema_decay_at(0.9999, i))
            for e, p in zip(ema.parameters(), model.parameters()):
                e.mul_(d).addcmul_(p, 1.0 - d)
    return {"step": steps, "model": model.state_dict(), "optimizer": opt.state_dict(),
            "ema": ema.state_dict()}


@pytest.mark.parametrize("written_at", [0, 2])
def test_foreach_checkpoint_loads_and_continues_with_jax(written_at):
    """A state_dict the foreach Adam wrote (before any step: no Adam state
    in it; after 2 steps) loads into a new state, which continues to step 4
    within 1e-6 of JAX's fused pass from step 0."""
    arrays = leaves()
    want = jax_states(arrays, "fused")
    state = TrainState(Leaves(leaves(seed=1)), LR)
    state.load_state_dict(foreach_state_dict(arrays, written_at))
    assert state.step == int(state.step_t) == written_at
    for i in range(written_at, STEPS):
        set_grads(state.model, i)
        fused_apply_gradients(state, LR)
        assert_matches_jax(state, want[i])


# ---- the kernel path, with a stand-in library -------------------------------

class FakeCuda(torch.Tensor):
    """A CPU tensor (an alias: the same memory and version counter) that says
    it lies on a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @property
    def is_cuda(self):
        return True


def as_cuda(x):
    if isinstance(x, torch.Tensor):
        return x.as_subclass(FakeCuda)
    if isinstance(x, (list, tuple)):
        return [as_cuda(t) for t in x]
    return x


def raw(addr: int, numel: int) -> torch.Tensor:
    """``numel`` fp32 values at ``addr``, as a tensor of its own: a write
    through it moves no other tensor's version counter, as the kernel's."""
    return torch.from_numpy(np.ctypeslib.as_array((ctypes.c_float * numel).from_address(addr)))


class FakeLibrary:
    """The built library's entry point: reads the leaf table as the C code
    does and runs the plain arithmetic through the table's raw addresses."""

    def __init__(self):
        self.calls = []

    def ldm_fused_adam_ema(self, n, table, d, lr, b1, b2, ob1, ob2, eps, stream, launches):
        assert (ob1, ob2) == (1.0 - b1, 1.0 - b2) and stream == 0
        rows = [list(table)[r * n:(r + 1) * n] for r in range(7)]
        numel = rows[6]

        def col(r, size=None):
            return [None if a == 0 else raw(a, size or k).view(() if size else (k,))
                    for a, k in zip(rows[r], numel)]

        emas = col(4) if any(rows[4]) else None
        PLAIN(col(0), col(1), col(2), col(3), emas, col(5, 1),
              None if d in (0, None) else raw(d, 1).view(()), lr, b1, b2, eps)
        self.calls.append({"n": n, "rows": rows})
        launches._obj.value = 1
        return 0


@pytest.fixture
def kernel_path(monkeypatch):
    """The wrapper's CUDA route on CPU memory: the library, the stream and
    the device context replaced; the plain version refused."""
    lib = FakeLibrary()
    monkeypatch.setattr(fa.LIB, "cdll", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))

    def refused(*args, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(fa, "fused_adam_ema_torch", refused)
    before = launches.snapshot()
    launches.restore({})
    yield lib
    launches.restore(before)


def pass_args(ema: bool, no_grad_leaf: bool):
    """(params, grads, m, v, emas, count, d) over SHAPES plus an empty leaf."""
    rng = np.random.default_rng(3)
    shapes = [*SHAPES.values(), (0,)]

    def r(scale=1.0, positive=False):
        out = []
        for s in shapes:
            a = scale * rng.standard_normal(s).astype(np.float32)
            out.append(torch.from_numpy(np.abs(a) if positive else a))
        return out

    params, grads, m, v, e = r(), r(0.1), r(0.01), r(1e-4, positive=True), r()
    if no_grad_leaf:
        grads[1] = None
    count = [torch.tensor(float(k)) for k in range(len(shapes))]
    return params, grads, m, v, e if ema else None, count, torch.tensor(0.7)


@pytest.mark.parametrize("ema", [True, False])
@pytest.mark.parametrize("no_grad_leaf", [False, True])
def test_cuda_tensors_reach_the_kernel_path(kernel_path, ema, no_grad_leaf):
    """CUDA tensors go to the library, never to the plain version: one launch
    over a table that skips the empty leaf and marks a leaf without a
    gradient (no moments, no count) or a state without an EMA with 0; the
    results are the plain version's bit for bit; the version counters of
    what the kernel wrote moved, those of the gradients and counts did not."""
    args = pass_args(ema, no_grad_leaf)
    want = [None if x is None else [None if t is None else t.clone() for t in x]
            for x in args[:6]] + [args[6]]
    PLAIN(*want, LR, 0.9, 0.999, 1e-8)
    versions = [[None if t is None else t._version for t in x] if x is not None else None
                for x in args[:6]]
    fa.fused_adam_ema(*as_cuda(args), LR, 0.9, 0.999, 1e-8)
    assert launches.read(fa.LIB.name) == 1 and len(kernel_path.calls) == 1
    # the table: no empty leaf, no leaf with neither a gradient nor an EMA
    call = kernel_path.calls[0]
    listed = [i for i in range(len(SHAPES)) if ema or not (no_grad_leaf and i == 1)]
    sizes = [int(np.prod(s)) for s in SHAPES.values()]
    assert call["n"] == len(listed) and call["rows"][6] == [sizes[i] for i in listed]
    assert (0 in call["rows"][1]) == (no_grad_leaf and ema)
    assert (call["rows"][4] == [0] * len(listed)) == (not ema)
    if no_grad_leaf and ema:  # the gradient's, moments' and count's words 0
        assert [call["rows"][r][1] for r in (1, 2, 3, 5)] == [0, 0, 0, 0]
    for k, (got, exp) in enumerate(zip(args[:6], want[:6])):
        if got is None:
            continue
        for i, (a, b) in enumerate(zip(got, exp)):
            if a is None:
                continue
            assert torch.equal(a, b), (k, i)
            wrote = k in (0, 2, 3, 4) and a.numel() > 0 and (k == 4 or args[1][i] is not None)
            assert (a._version > versions[k][i]) == wrote, (k, i)


@pytest.mark.parametrize("bad", ["fp64 moment", "strided param", "count on another device"])
def test_kernel_path_refuses_what_the_kernel_does_not_take(kernel_path, bad):
    """A leaf of another type, a strided leaf, a count on the CPU beside CUDA
    leaves: ValueError before any launch."""
    params, grads, m, v, e, count, d = as_cuda(pass_args(True, False))
    if bad == "fp64 moment":
        m[0] = m[0].double()
    elif bad == "strided param":
        params[0] = torch.randn(5, 7).t().as_subclass(FakeCuda)
    else:
        count[2] = count[2].as_subclass(torch.Tensor)
    with pytest.raises(ValueError):
        fa.fused_adam_ema(params, grads, m, v, e, count, d, LR, 0.9, 0.999, 1e-8)
    assert launches.read(fa.LIB.name) == 0 and not kernel_path.calls


@pytest.mark.parametrize("ema", [True, False])
def test_eager_update_on_the_kernel_path_rekeys_the_attention_weights(kernel_path, monkeypatch,
                                                                      ema):
    """``TrainState.update`` through the kernel path (its tensors seen as
    CUDA ones): the attention block's ``_weights_key`` changes (the kernel
    moves no version counter: the wrapper must), in the model and in the
    EMA; the step lands where the plain path's does, bit for bit."""
    monkeypatch.setattr(state_mod, "fused_adam_ema",
                        lambda *args: fa.fused_adam_ema(*as_cuda(args)))
    torch.manual_seed(0)
    block = LinAttnBlock(64)
    twin = LinAttnBlock(64)
    twin.load_state_dict(block.state_dict())
    state, plain = TrainState(block, LR, ema=ema), TrainState(twin, LR, ema=ema)
    models = [state.model] + ([state.ema] if ema else [])
    keys = [m._weights_key() for m in models]
    g = torch.Generator().manual_seed(1)
    for a, b in zip(block.parameters(), twin.parameters()):
        a.grad = torch.randn(a.shape, generator=g)
        b.grad = a.grad.clone()
    state.update()
    with monkeypatch.context() as mp:
        mp.setattr(state_mod, "fused_adam_ema", PLAIN)
        plain.update()
    assert launches.read(fa.LIB.name) == 1
    assert all(m._weights_key() != k for m, k in zip(models, keys))
    for part in ["model"] + (["ema"] if ema else []):
        for (name, a), b in zip(getattr(state, part).state_dict().items(),
                                getattr(plain, part).state_dict().values()):
            assert torch.equal(a, b), (part, name)
    for a, b in zip(block.parameters(), twin.parameters()):
        sa, sb = state.optimizer.state[a], plain.optimizer.state[b]
        assert all(torch.equal(sa[k], sb[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    assert int(state.step_t) == 1
