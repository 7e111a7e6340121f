"""The port's data-parallel layer (``ldm_tpu_torch/parallel/``) in one process,
held against the JAX package's: the FSDP leaf rule spec for spec on the
flagship and latent UNets' trees at N=2 and 4, ``per_host_subset`` row for
row, the one-process trainer's losses against the JAX step's from the same
draws (the reference the multi-process tests hold DP and FSDP against), the
device-resident epoch's rows, the graph policy over a gloo group, mesh
serving over two CPU replicas bit for bit, and the runtime flags
(``--mesh`` / ``--distributed``; the refusals of the mesh's model axis).
The multi-process runs are in tests/test_torch_port_multiprocess.py.
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import _torch_mp_worker as w
from ldm_tpu.data.datasets import synthetic_dataset as jax_synthetic_dataset
from ldm_tpu.diffusion.ddpm import GaussianDiffusion as JaxDiffusion
from ldm_tpu.models.unet import UNet as FlaxUNet
from ldm_tpu.parallel import distributed as jax_distributed
from ldm_tpu.parallel.fsdp import fsdp_leaf_sharding
from ldm_tpu.parallel.mesh import create_mesh as jax_create_mesh
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu_torch.data.datasets import synthetic_dataset
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.models.unet import UNet
from ldm_tpu_torch.parallel import distributed, fsdp
from ldm_tpu_torch.parallel.mesh import Mesh, create_mesh
from ldm_tpu_torch.serving.builder import build_generation_service
from ldm_tpu_torch.training.scan_epochs import EpochScan
from ldm_tpu_torch.utils import cli
from ldm_tpu_torch.utils.flax_import import unet_from_flax
from ldm_tpu_torch.utils.graphs import use_graphs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREES = {"flagship": "configs/pixel_diffusion_model_cifar10.yaml",
         "latent": "configs/latent_diffusion_hard.yaml"}


class FakeMesh:
    """A mesh's place without a process group: what the row arithmetic and
    the graph policy read."""

    def __init__(self, rank=0, size=1, backend="gloo"):
        self.rank, self.size, self.backend = rank, size, backend
        self.captures_collectives = backend == "nccl"

    local_rows = Mesh.local_rows


def tree_shapes(name):
    """(JAX leaf shapes, port leaf shapes) of a config's UNet."""
    cfg = load_config(os.path.join(ROOT, TREES[name]))
    params = dict(cfg.model.params)
    size = cfg.data.image_size if name == "flagship" else 4  # the VAE's 4x4 latents
    c = params["in_channels"]
    tree = jax.eval_shape(FlaxUNet(**params).init, jax.random.key(0),
                          jnp.zeros((1, size, size, c)), jnp.zeros((1,), jnp.int32),
                          jnp.zeros((1,), jnp.int32))
    jax_shapes = [tuple(x.shape) for x in jax.tree.leaves(tree)]
    port_shapes = [tuple(p.shape) for p in UNet(**params).parameters()]
    return jax_shapes, port_shapes


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_fsdp_leaf_rule_matches_jax_spec_for_spec(tree, n):
    """The rule is a function of a shape: on every leaf shape of both
    packages' trees (flax's HWIO kernels and torch's OIHW weights alike) the
    port's spec is JAX's ``fsdp_leaf_sharding`` spec."""
    mesh = jax_create_mesh(jax.devices()[:n])
    jax_shapes, port_shapes = tree_shapes(tree)
    assert len(jax_shapes) == len(port_shapes) > 50
    sharded = 0
    for shape in jax_shapes + port_shapes:
        want = tuple(fsdp_leaf_sharding(mesh, jax.ShapeDtypeStruct(shape, jnp.float32)).spec)
        assert fsdp.fsdp_leaf_spec(shape, n) == want, shape
        sharded += bool(want)
    assert sharded > 10  # the rule shards the large leaves of both trees


def test_per_host_subset_matches_jax_row_for_row(monkeypatch):
    """101 rows over 2 processes: 50 each, rows r::2 of the first 100, the
    JAX package's slices exactly (tests/test_multiprocess.py's case)."""
    jds = jax_synthetic_dataset(101, 8, 1)
    pds = synthetic_dataset(101, 8, 1)
    np.testing.assert_array_equal(jds.images, pds.images)
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    for r in range(2):
        monkeypatch.setattr(jax, "process_index", lambda r=r: r)
        want = jax_distributed.per_host_subset(jds)
        got = distributed.per_host_subset(pds, rank=r, world=2)
        assert len(got) == len(want) == 50
        np.testing.assert_array_equal(got.images, want.images)
        np.testing.assert_array_equal(got.labels, want.labels)


def test_one_process_losses_match_the_jax_step(tmp_path):
    """The reference of the multi-process tests (the tiny UNet at global
    batch 16, fp32) against the JAX step over 6 steps from equal weights,
    batches and draws, at the bars of tests/test_torch_port_train_step.py:
    the first step's loss rtol 1e-5 (equal state), the curve rtol 1e-3
    (after a step Adam has turned the two frameworks' rounding into weight
    differences of up to about lr)."""
    cfg = w.tiny_config(tmp_path)
    params = dict(w.MODEL)
    model = FlaxUNet(**params)
    key = jax.random.key(cfg.seed)
    k_init, k_state = jax.random.split(key)
    p0 = jax.jit(model.init)(k_init, jnp.zeros((1, 8, 8, 1)), jnp.zeros((1,), jnp.int32),
                             jnp.zeros((1,), jnp.int32))
    state = JaxState.create(p0, make_optimizer(cfg.lr), k_state, ema_decay=cfg.ema_decay)
    diffusion = JaxDiffusion(cfg.diffusion.n_steps)

    @jax.jit
    def step(state, image, label, drop):
        eps, xt, t = diffusion.noise_batch(jax.random.fold_in(state.step_key(), 1), image)
        y = jnp.where(drop, params["num_classes"], label)

        def loss_fn(p):
            return jnp.mean((eps - model.apply(p, xt, t, y)) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads), loss, t, eps

    torch.set_num_threads(1)
    tr = w.tiny_trainer(cfg)
    tr.model.load_state_dict(unet_from_flax(jax.device_get(p0)), strict=True)
    tr.state.ema.load_state_dict(tr.model.state_dict())
    rng = np.random.default_rng(0)
    want, got = [], []
    for b in w.global_batches():
        drop = rng.random() < 0.1
        state, loss, t, eps = step(state, jnp.asarray(b["image"]), jnp.asarray(b["label"]),
                                   jnp.asarray(drop))
        want.append(float(loss))
        got.append(tr.train_step(b, t=torch.from_numpy(np.array(t)),
                                 eps=torch.from_numpy(np.array(eps)),
                                 drop=torch.tensor(drop))["loss"].item())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=1e-3)


@pytest.mark.parametrize("size", [2, 4])
def test_epoch_rows_under_a_mesh_partition_the_global_batches(size):
    """Every process draws the global permutation and gathers its block of
    each global batch: the blocks in rank order are the one-process batch."""
    ds = synthetic_dataset(40, 8, 1)
    one = EpochScan(ds.images, ds.labels, 8, "cpu")
    one.start_epoch(3, 1)
    parts = []
    for r in range(size):
        scan = EpochScan(ds.images, ds.labels, 8, "cpu", mesh=FakeMesh(r, size))
        scan.start_epoch(3, 1)
        assert scan.x_like.shape[0] == 8 // size
        parts.append([scan.next_batch() for _ in range(scan.n_batches)])
    for i in range(one.n_batches):
        x, y = one.next_batch()
        assert torch.equal(torch.cat([p[i][0] for p in parts]), x)
        assert torch.equal(torch.cat([p[i][1] for p in parts]), y)


def test_graph_policy_follows_the_backend():
    """A gloo group's step runs eagerly by design on a card; asking for the
    graph over it raises; NCCL's may be captured."""
    assert not use_graphs("cuda", None, FakeMesh(backend="gloo"))
    with pytest.raises(ValueError, match="gloo"):
        use_graphs("cuda", True, FakeMesh(backend="gloo"))
    assert use_graphs("cuda", None, FakeMesh(backend="nccl"))
    assert not use_graphs("cpu", None, FakeMesh(backend="gloo"))


def served(cfg, ckpt, mesh, batch_size):
    """A request alone, the same request among others, and the others,
    through a DDIM-3 service at ``batch_size`` over ``mesh`` (None: one
    device); the service's devices."""
    kw = dict(sampler="ddim", ddim_steps=3, max_delay_s=0.05, use_native=False, device="cpu")
    svc = build_generation_service(cfg, str(ckpt), mesh=mesh, batch_size=batch_size,
                                   **kw).start()
    try:
        alone = svc.submit(3, n=3, seed=11).result(timeout=120)
        futs = [svc.submit(c, n=2, seed=c) for c in range(4)]
        mixed = svc.submit(3, n=3, seed=11)
        return (alone, mixed.result(timeout=120),
                [f.result(timeout=120) for f in futs]), svc.devices
    finally:
        svc.stop()


def seeded_unet_checkpoint(tmp_path):
    torch.manual_seed(0)
    ckpt = tmp_path / "unet.pt"
    torch.save(UNet(**w.MODEL).state_dict(), ckpt)
    return ckpt


def test_mesh_serving_over_two_cpu_replicas_is_bit_identical(tmp_path):
    """One replica a device over ["cpu", "cpu"], each sampling its half of
    every batch's slots: a request's images equal the one-device service's
    bit for bit, alone and among others; a batch that does not split over
    the devices raises."""
    torch.set_num_threads(1)
    cfg = w.tiny_config(tmp_path)
    ckpt = seeded_unet_checkpoint(tmp_path)
    with pytest.raises(ValueError, match="divide"):
        build_generation_service(cfg, str(ckpt), mesh=["cpu"] * 3, sampler="ddim",
                                 ddim_steps=3, batch_size=4, use_native=False, device="cpu")
    one, _ = served(cfg, ckpt, None, 4)
    mesh, devices = served(cfg, ckpt, ["cpu", "cpu"], 4)
    assert len(devices) == 2
    np.testing.assert_array_equal(mesh[0], one[0])
    np.testing.assert_array_equal(mesh[1], one[0])
    for a, b in zip(mesh[2], one[2]):
        np.testing.assert_array_equal(a, b)


def test_mesh_serving_contract_is_per_device_batch(tmp_path):
    """The contract a GPU can keep (cuDNN chooses a convolution's algorithm
    by batch size): two replicas at B=4 give each slot what a one-device
    service at B/2 = 2 gives it, bit for bit, alone and among others."""
    torch.set_num_threads(1)
    cfg = w.tiny_config(tmp_path)
    ckpt = seeded_unet_checkpoint(tmp_path)
    half, devices = served(cfg, ckpt, None, 2)
    mesh, _ = served(cfg, ckpt, ["cpu", "cpu"], 4)
    assert devices == [torch.device("cpu")]
    np.testing.assert_array_equal(mesh[0], half[0])
    np.testing.assert_array_equal(mesh[1], half[0])
    for a, b in zip(mesh[2], half[2]):
        np.testing.assert_array_equal(a, b)


def test_model_axis_and_spatial_raise_naming_item_12b(tmp_path):
    """The model axis runs (ROADMAP items 12b.1 and 12b.2: the TP and SP
    tests); the refusals that stay are JAX's own: a mesh that does not cover
    the processes (checked before a group of this process alone is made),
    and spatial activations with sharded parameters."""
    with pytest.raises(ValueError, match="processes"):
        create_mesh(model=2, device="cpu")
    with pytest.raises(ValueError, match="processes"):
        create_mesh(data=2, device="cpu")
    model_axis = argparse.Namespace(device=torch.device("cpu"), group=None, size=1, rank=0,
                                    model_size=2, model_rank=0)
    for mode in ("fsdp", "tp", "fsdp_tp"):
        with pytest.raises(ValueError, match="spatial"):
            w.tiny_trainer(w.tiny_config(tmp_path, mode, activation_sharding="spatial"),
                           mesh=model_axis)


def test_distributed_flag_needs_the_environment(monkeypatch):
    """``--distributed`` with none of the variables raises, as JAX's does;
    without ``--mesh`` / ``--distributed`` there is no mesh (and without
    ``--wandb`` no logger)."""
    for var in ("LDM_TPU_COORDINATOR", "LDM_TPU_NUM_PROCESSES", "LDM_TPU_PROCESS_ID",
                "LDM_TPU_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    ap = argparse.ArgumentParser()
    cli.add_runtime_args(ap)
    with pytest.raises(RuntimeError, match="LDM_TPU_COORDINATOR"):
        cli.runtime_setup(ap.parse_args(["--device", "cpu", "--distributed"]))
    assert cli.runtime_setup(ap.parse_args(["--device", "cpu"])) == (torch.device("cpu"), None,
                                                                      None)
    assert not distributed.initialize(device="cpu")
    assert distributed.process_count() == 1 and distributed.is_primary()


def test_train_entry_point_with_mesh(tmp_path):
    """``python -m ldm_tpu_torch.train <tiny.yaml> --device cpu --mesh``: a
    group of one process (no environment), the run and its files; and two
    processes from the environment (``LDM_TPU_COORDINATOR`` ...), one writer."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs", "smoke_synthetic.yaml")))
    raw.update(workdir=str(tmp_path), epochs=1, batch_size=8, sample_every=0,
               project_name="meshcli")
    raw["model"]["params"].update(channels=8, channel_multipliers=[1])
    raw["data"].update(image_size=8, synthetic_size=160)
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "ldm_tpu_torch.train", str(path), "--device", "cpu"]
    r = subprocess.run(cmd + ["--mesh"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    run = tmp_path / "pixel" / "meshcli"
    assert (run / "checkpoints" / "state.pt").exists()
    (run / "metrics.jsonl").unlink()
    port = _free_port()
    procs = [subprocess.Popen(cmd + ["--distributed"], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, LDM_TPU_COORDINATOR=f"127.0.0.1:{port}",
                                       LDM_TPU_NUM_PROCESSES="2", LDM_TPU_PROCESS_ID=str(r)))
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs[0][-3000:] + logs[1][-3000:]
    records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
    assert sum(1 for rec in records if rec.get("epoch") == 0) == 1
    assert "train_loss" in logs[0] and "train_loss" not in logs[1]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
