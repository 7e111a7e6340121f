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
        mesh = create_mesh(device="cpu")
        assert mesh.size == world and mesh.rank == rank
        out = run(scenario, mesh, outdir)
        out["primary"] = mesh.is_primary
        torch.save(out, os.path.join(outdir, f"rank{rank}.pt"))
        mesh.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
