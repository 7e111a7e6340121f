"""One process of a gloo group for tests/test_torch_port_multiprocess.py.

    python tests/_torch_mp_worker.py <scenario> <port> <world> <rank> <outdir>

A scenario is parts joined by "+"; each process writes
``<outdir>/rank<r>.pt``, a dict of results:

* ``dp`` / ``fsdp``: the tiny UNet trained by ``DiffusionTrainer.train()``
  under ``create_mesh()`` with ``param_sharding`` replicated or fsdp (the
  device-resident epoch: every process draws the global permutation and
  gathers its rows); the history, the whole final state, the bytes each
  process holds of the flagship UNet's parameters under the FSDP rule, and
  under fsdp a resume from the checkpoint and the kernel-cache check.
* ``perbatch``: ``train_step`` on this process's rows of given global
  batches.
* ``bn``: the ResNet classifier's steps, BatchNorm on the global batch's
  statistics, and again with each process's own (the wrong answer).
* ``tp`` / ``fsdp_tp`` / ``sp`` (a mesh with a model axis of 2): the tiny
  UNet trained with ``param_sharding`` tp or fsdp_tp, or with
  ``activation_sharding`` spatial; the history, each step's gradient norm
  and the final parameters' norm, the whole final state, the TP shares'
  shapes, sampler draws (DDPM and DDIM) from the EMA; under tp
  and fsdp_tp a resume from the checkpoint, a one-process state loaded and
  gathered back, and the bytes each process holds of the flagship UNet.
* ``heads``: the plain attention over this process's heads of one block,
  forward and grads (:func:`heads_inputs`).
* ``spjax``: the explicit spatial forward and gradients of a UNet read from
  ``<outdir>/spjax_in.pt`` (weights, x, t, y, the target).
* ``pp``: the pipeline (``parallel/pp.py``) on the UNet and inputs of
  ``<outdir>/pp_in.pt``: for M in :data:`PP_MICROBATCHES` the forward, the
  stage's gradients of a loss and the ancestral sampler through
  ``make_pp_apply`` (the draws injected); the stage's names and bytes, the
  weights gathered back, and :func:`diffusion_steps` at M = 2.

The tiny setup (the same for the one-process reference the test runs) is
defined here; this module imports torch and the port only.
"""

from __future__ import annotations

import copy
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from ldm_tpu_torch.config import Config, DataConfig, DiffusionConfig, ModelConfig  # noqa: E402
from ldm_tpu_torch.data.datasets import synthetic_dataset  # noqa: E402
from ldm_tpu_torch.data.loader import DataLoader  # noqa: E402
from ldm_tpu_torch.models.resnet import ResNetBase, sync_batch_norm  # noqa: E402
from ldm_tpu_torch.models.unet import UNet  # noqa: E402
from ldm_tpu_torch.ops.linear_attention import make_kernel_weights  # noqa: E402
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion  # noqa: E402
from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer  # noqa: E402
from ldm_tpu_torch.training.resnet_trainer import ResNetTrainer  # noqa: E402

MODEL = dict(in_channels=1, out_channels=1, channels=32, channel_multipliers=[1],
             num_classes=10)
FLAGSHIP = dict(in_channels=3, out_channels=3, channels=64, channel_multipliers=[1, 2, 4, 8],
                num_classes=10)
BATCH, STEPS_PER_EPOCH, EPOCHS = 16, 3, 2  # 6 steps


def tiny_config(workdir, param_sharding="replicated", **kw) -> Config:
    return Config(project_name="mp", workdir=str(workdir), epochs=EPOCHS, batch_size=BATCH,
                  use_amp=False, seed=3, sample_every=0, param_sharding=param_sharding,
                  model=ModelConfig(params=MODEL), diffusion=DiffusionConfig(n_steps=4),
                  data=DataConfig(dataset="SYNTHETIC", image_size=8, image_channels=1), **kw)


def tiny_dataset():
    return synthetic_dataset(BATCH * STEPS_PER_EPOCH, 8, 1, seed=0)


def tiny_trainer(cfg, mesh=None) -> DiffusionTrainer:
    torch.manual_seed(0)
    ds = tiny_dataset()
    return DiffusionTrainer(cfg, UNet(**MODEL), GaussianDiffusion(cfg.diffusion.n_steps),
                            DataLoader(ds, BATCH, seed=0), DataLoader(ds, BATCH, seed=1),
                            list(range(10)), device="cpu", mesh=mesh)


def global_batches(n=6, seed=7):
    rng = np.random.default_rng(seed)
    return [{"image": rng.uniform(-1, 1, (BATCH, 8, 8, 1)).astype(np.float32),
             "label": rng.integers(0, 10, BATCH).astype(np.int32)} for _ in range(n)]


def classifier_config(workdir, lr: float = 5e-4) -> Config:
    return Config(project_name="mpclf", workdir=str(workdir), epochs=1, batch_size=BATCH,
                  use_amp=False, seed=5, loss_fn="cross-entropy", scan_epochs=False, lr=lr,
                  data=DataConfig(dataset="SYNTHETIC", image_size=8, image_channels=1))


def classifier_trainer(cfg, mesh=None) -> ResNetTrainer:
    model = ResNetBase(img_channels=1, out_channels=10, n_blocks=(1, 1), n_channels=(8, 16),
                       first_kernel_size=3, seed=cfg.seed)
    ds = tiny_dataset()
    return ResNetTrainer(cfg, model, DataLoader(ds, BATCH, seed=0),
                         DataLoader(ds, BATCH, seed=1), list(range(10)), device="cpu",
                         mesh=mesh)


def running_stats(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def state_bytes(shapes, n) -> int:
    """The fp32 bytes one process holds of leaves of ``shapes`` under the
    FSDP rule over n processes, computed from the shapes alone."""
    from ldm_tpu_torch.parallel.fsdp import fsdp_shard_dim

    total = 0
    for shape in shapes:
        numel = int(np.prod(shape))
        total += 4 * (numel // n if fsdp_shard_dim(shape, n) is not None else numel)
    return total


def cache_check(trainer, batch) -> list:
    """(key, copies fresh) of the first attention block's kernel copies at
    the start of each step's forward, read through ``kernel_weights`` while
    FSDP2 has the weights unsharded (the forward on the CPU takes the plain
    path and never asks for them)."""
    seen = []

    def hook(block, _args):
        attn = block.fn.fn
        c = attn.to_out[0].weight.shape[0]
        got = block.kernel_weights(torch.float32)
        fresh = make_kernel_weights(attn.to_qkv.weight.view(-1, c).t(),
                                    attn.to_out[0].weight.view(c, -1).t(), torch.float32,
                                    backward=False)
        seen.append((block._weights_key(), torch.equal(got.wqkv_t, fresh.wqkv_t)
                     and torch.equal(got.wout_t, fresh.wout_t)))

    handle = trainer.model.lin_attn_blocks()[0].register_forward_pre_hook(hook)
    try:
        for _ in range(3):
            trainer.train_step(batch)
    finally:
        handle.remove()
    return seen


MODEL_AXIS_PARTS = {"tp", "fsdp_tp", "sp", "heads", "spjax", "pp"}


def rule_bytes(named_shapes: dict, data: int, model: int) -> int:
    """The fp32 bytes one process holds of the named leaves under the
    fsdp_tp rule over a (data, model) mesh (at data 1: the TP rule alone)."""
    from ldm_tpu_torch.parallel.tp import fsdp_tp_leaf_spec

    total = 0
    for name, shape in named_shapes.items():
        spec = fsdp_tp_leaf_spec(name.split("."), shape, data, model)
        split = model if "model" in spec else data if "data" in spec else 1
        total += 4 * int(np.prod(shape)) // split
    return total


def same_state(a: dict, b: dict) -> bool:
    """Two whole states equal bit for bit: model, EMA, Adam's state."""
    for part in ("model", "ema"):
        if a[part].keys() != b[part].keys() or not all(
                torch.equal(a[part][k], v) for k, v in b[part].items()):
            return False
    sa, sb = a["optimizer"]["state"], b["optimizer"]["state"]
    return sa.keys() == sb.keys() and all(
        torch.equal(sa[i][k], v) for i, st in sb.items() for k, v in st.items())


def record_grad_norms(trainer) -> list:
    """The list that each of ``trainer``'s steps appends its ``grad_norm``
    to (a float), from now on."""
    norms = []
    for name in ("train_step", "scan_step"):
        def step(*args, _step=getattr(trainer, name), **kw):
            m = _step(*args, **kw)
            norms.append(float(m["grad_norm"]))
            return m
        setattr(trainer, name, step)
    return norms


def model_axis_run(part: str, mesh, workdir: str) -> dict:
    """``tp`` / ``fsdp_tp`` / ``sp``: the tiny trainer under the placement."""
    from ldm_tpu_torch.parallel import fsdp, tp

    sharding = "replicated" if part == "sp" else part
    cfg = tiny_config(os.path.join(workdir, part), sharding,
                      activation_sharding="spatial" if part == "sp" else "batch")
    tr = tiny_trainer(cfg, mesh)
    grad_norms = record_grad_norms(tr)
    out = {"history": tr.train(), "grad_norms": grad_norms,
           "param_norm": float(tr.state.norm(tr.state.params())),
           "state": copy.deepcopy(tr.state.state_dict()),
           "step": tr.state.step, "impls": {b.impl for b in tr.model.lin_attn_blocks()},
           "shares": {n: tuple(p.shape) for n, p in tr.model.named_parameters()
                      if n in tr.state.tp_layout},
           "x0": {m: tr.sample_x0([1, 2, 3], cfg_scale=3.0, method=m, ddim_steps=2)
                  for m in ("ddpm", "ddim")}}
    if part == "sp":
        return out
    # resume from the checkpoint the primary process wrote at the end
    with torch.no_grad():
        for p in tr.model.parameters():
            fsdp.local(p).zero_()
    assert tr.resume_latest()
    out["resumed"] = same_state(tr.state.state_dict(), out["state"])
    if part == "tp":
        # a one-process state, loaded under the model axis and gathered back
        # (an FSDP state's Adam has its own parameter order and groups)
        one = tiny_trainer(tiny_config(os.path.join(workdir, part + "_one")))
        for b in global_batches(2):
            one.train_step(b)
        sd = copy.deepcopy(one.state.state_dict())
        tr.state.load_state_dict(sd)
        out["loaded"] = same_state(tr.state.state_dict(), sd)
    # the flagship UNet's parameters under the rule
    flag = UNet(**FLAGSHIP)
    shapes = {n: tuple(p.shape) for n, p in flag.named_parameters()}
    layout = tp.shard_module(flag, mesh)
    if part == "fsdp_tp":
        fsdp.shard_module(flag, mesh, ignored=[p for n, p in flag.named_parameters()
                                               if n in layout])
    out["flagship_bytes"] = fsdp.sharded_bytes_per_device(flag.parameters())
    out["flagship_bytes_expected"] = rule_bytes(shapes, mesh.size if part == "fsdp_tp" else 1,
                                                mesh.model_size)
    out["flagship_bytes_replicated"] = rule_bytes(shapes, 1, 1)
    out["attention_bytes"] = sum(4 * int(np.prod(shapes[n])) for n in layout)
    return out


def heads_inputs(seed: int = 5):
    """One attention block's inputs, C=24, N=16, B=2, 4 heads of 32: x,
    the seven parameters, and the output's cotangent."""
    g = torch.Generator().manual_seed(seed)
    c, hidden = 24, 128

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g) * scale

    return (rnd(2, 16, c), rnd(c, 3 * hidden, scale=0.2), rnd(hidden, c, scale=0.2),
            rnd(c, scale=0.1), 1 + rnd(c, scale=0.1), rnd(c, scale=0.1), 1 + rnd(c, scale=0.1),
            rnd(c, scale=0.1)), rnd(2, 16, c)


def head_share(wqkv, wout, rank: int, size: int) -> tuple:
    """Process ``rank``'s heads' weights of the (C, 3H) ``wqkv`` and the
    (H, C) ``wout``: its q, k and v columns and its rows (``tp``'s share)."""
    from ldm_tpu_torch.parallel.tp import TpLeaf, local_slice

    return (local_slice(wqkv, TpLeaf(1, 3), rank, size),
            local_slice(wout, TpLeaf(0, 1), rank, size))


def heads_run(mesh) -> dict:
    """The plain block over this process's heads (``linear_attention_block_torch``
    with the model group): its output and the grads of x, its heads'
    weights and the vectors."""
    from ldm_tpu_torch.ops.linear_attention import linear_attention_block_torch

    (x, wqkv, wout, *vec), dy = heads_inputs()
    wq, wo = head_share(wqkv, wout, mesh.model_rank, mesh.model_size)
    args = [t.clone().requires_grad_() for t in (x, wq, wo, *vec)]
    y = linear_attention_block_torch(*args, heads=4 // mesh.model_size, dim_head=32,
                                     group=mesh.model_group)
    (y * dy).sum().backward()
    return {"y": y.detach(), "grads": [a.grad for a in args]}


def spjax_run(mesh, outdir: str) -> dict:
    """The explicit spatial forward (gathered) and the loss's gradients
    (summed over the model axis) of the UNet in ``spjax_in.pt``."""
    import torch.distributed as dist

    from ldm_tpu_torch.ops.collectives import gather_rows_model
    from ldm_tpu_torch.parallel.sp_explicit import SpatialUNet

    inp = torch.load(os.path.join(outdir, "spjax_in.pt"), weights_only=False)
    model = UNet(**inp["model"])
    model.load_state_dict(inp["state_dict"], strict=True)
    out = SpatialUNet(mesh, model)(mesh.model_rows(inp["x"]), inp["t"], inp["y"])
    target = mesh.model_rows(inp["target"])
    sq = (out - target) ** 2
    (sq.sum() / (sq.numel() * mesh.model_size)).backward()
    grads = {}
    for n, p in model.named_parameters():
        dist.all_reduce(p.grad, group=mesh.model_group)
        grads[n] = p.grad
    return {"out": gather_rows_model(out.detach(), mesh.model_group, 1), "grads": grads}


PP_MICROBATCHES = (1, 2, 4)


def diffusion_steps(forward, params, steps, lr: float, n_steps: int, null_label: int,
                    norm) -> tuple:
    """Adam on ``params`` over ``steps`` (each the whole batch's x0 and y and
    the draws t, eps and the label-drop mask), by the diffusion trainer's
    loss: x_t from (x0, t, eps), the dropped labels to the null label, the
    mean squared error of ``forward(x_t, t, y)`` against eps.  The losses
    and each step's gradient norm (``norm()``)."""
    diffusion = GaussianDiffusion(n_steps)
    opt = torch.optim.Adam(params, lr=lr, foreach=True)
    losses, norms = [], []
    for x0, y, t, eps, drop in steps:
        target, xt, t_in = diffusion.noised(x0, t, eps)
        loss = torch.mean((target - forward(xt, t_in, torch.where(drop, null_label, y))) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        losses.append(loss.item())
        norms.append(float(norm()))
        opt.step()
    return losses, norms


def pp_run(mesh, outdir: str) -> dict:
    """The ``pp`` part: this process's stage of the UNet in ``pp_in.pt``."""
    from ldm_tpu_torch.parallel import pp

    inp = torch.load(os.path.join(outdir, "pp_in.pt"), weights_only=False)

    def stage_of_input():
        stage = pp.pp_stage(mesh, UNet(**inp["model"]))
        part = pp.split_unet_state_dict(inp["state_dict"])[mesh.model_rank]
        stage.load_state_dict(part, strict=True)
        return stage

    stage = stage_of_input()
    x, t, y, target = inp["grad"]
    smp = inp["sample"]
    out = {"fwd": {}, "grads": {}, "x0": {}}
    for m in PP_MICROBATCHES:
        with torch.no_grad():
            out["fwd"][m] = pp.pipeline_unet_apply(mesh, stage, *inp["fwd"], m)
        stage.zero_grad(set_to_none=True)
        loss = torch.mean((pp.pipeline_unet_apply(mesh, stage, x, t, y, m) - target) ** 2)
        loss.backward()
        out["grads"][m] = {n: p.grad.clone() for n, p in stage.named_parameters()}
        out["x0"][m] = GaussianDiffusion(smp["n_steps"]).sample(
            pp.make_pp_apply(mesh, stage, m), smp["classes"], smp["shape"], cfg_scale=3.0,
            null_label=inp["model"]["num_classes"], x_init=smp["x_init"],
            noise=smp["noise"].__getitem__)
    out["names"] = [n for n, _ in stage.named_parameters()]
    out["bytes"] = sum(p.nbytes for p in stage.parameters())
    out["gathered"] = pp.gather_state_dict(stage, mesh)
    tr = inp["train"]
    stage = stage_of_input()
    params = list(stage.parameters())
    out["train"] = diffusion_steps(
        lambda *a: pp.pipeline_unet_apply(mesh, stage, *a, 2), params, tr["steps"], tr["lr"],
        tr["n_steps"], inp["model"]["num_classes"], lambda: pp.grad_norm(stage, mesh))
    out["train_state"] = pp.gather_state_dict(stage, mesh)
    return out


def run(scenario, mesh, outdir) -> dict:
    """The parts of ``scenario`` ("+"-joined), each process's results."""
    from ldm_tpu_torch.parallel import fsdp
    from ldm_tpu_torch.parallel.mesh import shard_batch

    workdir = os.path.join(outdir, "run")
    parts = scenario.split("+")
    out = {}
    if parts[0] in ("dp", "fsdp"):
        cfg = tiny_config(workdir, "fsdp" if parts[0] == "fsdp" else "replicated")
        tr = tiny_trainer(cfg, mesh)
        out.update(history=tr.train(), state=copy.deepcopy(tr.state.state_dict()),
                   step=tr.state.step,
                   scan=tr.epoch_scan is not None, graphed=tr.step_counts["graphed"],
                   sharded=[n for n, p in tr.model.named_parameters() if fsdp.is_sharded(p)])
        # the flagship tree's parameters under the rule
        flag = UNet(**FLAGSHIP)
        shapes = [tuple(p.shape) for p in flag.parameters()]
        fsdp.shard_module(flag, mesh)
        out["flagship_bytes"] = fsdp.sharded_bytes_per_device(flag.parameters())
        out["flagship_bytes_expected"] = state_bytes(shapes, mesh.size)
        out["flagship_bytes_replicated"] = state_bytes(shapes, 1)
        x = torch.from_numpy(global_batches(1)[0]["image"])
        out["gathered"] = torch.equal(mesh.gather_rows(mesh.local_rows(x)), x)
        if parts[0] == "fsdp":
            # resume from the checkpoint the primary process wrote at the end
            with torch.no_grad():
                for p in tr.model.parameters():
                    fsdp.local(p).zero_()
            assert tr.resume_latest()
            out["resumed"] = copy.deepcopy(tr.state.state_dict())
            # a sample grid from the EMA weights gathered into the unsharded copy
            out["grid"] = tr.sample([1, 2, 3], cfg_scale=3.0, method="ddim", ddim_steps=2)
            # the kernel-cache hazard: three more steps, the copies read in each
            out["cache"] = cache_check(tr, shard_batch(mesh, global_batches(1)[0]))
    for part in ("tp", "fsdp_tp", "sp"):
        if part in parts:
            out[part] = model_axis_run(part, mesh, workdir)
    if "heads" in parts:
        out["heads"] = heads_run(mesh)
    if "spjax" in parts:
        out["spjax"] = spjax_run(mesh, outdir)
    if "pp" in parts:
        out["pp"] = pp_run(mesh, outdir)
    if "perbatch" in parts:
        tr = tiny_trainer(tiny_config(os.path.join(workdir, "perbatch")), mesh)
        losses = [tr.train_step(shard_batch(mesh, b))["loss"].item() for b in global_batches()]
        out["perbatch"] = {"losses": losses, "state": copy.deepcopy(tr.state.state_dict())}
    if "bn" in parts:
        # at lr 0 the weights stay the initial ones and the statistics read
        # the data alone; at the config's lr the losses
        for name, sync, lr in (("bn_global", mesh, 0.0), ("bn_per_rank", None, 0.0),
                               ("bn_trained", mesh, 5e-4)):
            tr = classifier_trainer(classifier_config(os.path.join(workdir, name), lr), mesh)
            sync_batch_norm(tr.model, sync)
            losses = [tr.train_step(shard_batch(mesh, b))["loss"].item()
                      for b in global_batches(4)]
            out[name] = {"losses": losses, "stats": running_stats(tr.model)}
    return out


def main() -> None:
    scenario, port, world, rank, outdir = sys.argv[1:6]
    world, rank = int(world), int(rank)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from ldm_tpu_torch.parallel import distributed
    from ldm_tpu_torch.parallel.mesh import create_mesh

    assert distributed.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    try:
        model = 2 if MODEL_AXIS_PARTS & set(scenario.split("+")) else 1
        mesh = create_mesh(model=model, device="cpu")
        assert mesh.size * model == world and mesh.rank * model + mesh.model_rank == rank
        out = run(scenario, mesh, outdir)
        out["primary"] = mesh.is_primary
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
