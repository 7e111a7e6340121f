"""Data parallelism and FSDP of the port across real processes on the CPU.

Each case spawns 2 or 4 processes of ``tests/_torch_mp_worker.py`` (a gloo
group on a free port, one intra-op thread each, a timeout of its own) and
holds what they computed against one process of the port on the same
data: the tiny UNet (channels 16, multipliers [1], 8 px, T=4, global batch
16, 6 steps) through ``DiffusionTrainer.train()``, losses at rtol 1e-5 and
parameters at atol 5e-3 (the JAX package's DP bar,
``tests/test_sharding.py``: Adam turns the reduction order's rounding into a
few lr a step).  At channels 16 the FSDP rule shards the attention
projections (every leaf of a channels-8 UNet is under its 4,096 elements).

Also: rank-0-only writes, a bitwise resume from an FSDP checkpoint, the
kernel-weight copies of an attention block following the weights across
FSDP steps, the bytes each process holds under the rule, the per-batch
path, and the classifier's BatchNorm reading global-batch statistics.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mp_worker as w
from ldm_tpu_torch.parallel.mesh import shard_batch

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT = 240  # seconds, each process


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(scenario: str, world: int, outdir) -> list:
    """``world`` worker processes of ``scenario``; each one's results."""
    os.makedirs(outdir, exist_ok=True)
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "_torch_mp_worker.py"),
                               scenario, str(port), str(world), str(r), str(outdir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {scenario} failed:\n{logs[r][-4000:]}"
    return [torch.load(os.path.join(outdir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each (scenario, world) spawned once for the module."""
    cache = {}

    def get(scenario, world):
        if (scenario, world) not in cache:
            out = tmp_path_factory.mktemp(f"{scenario.replace('+', '_')}{world}")
            cache[(scenario, world)] = (spawn(scenario, world, out), out)
        return cache[(scenario, world)]
    return get


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """One process of the port: the trainer's run, and the per-batch steps."""
    torch.set_num_threads(1)
    tr = w.tiny_trainer(w.tiny_config(tmp_path_factory.mktemp("ref")))
    hist = tr.train()
    pb = w.tiny_trainer(w.tiny_config(tmp_path_factory.mktemp("refpb")))
    losses = [pb.train_step(b)["loss"].item() for b in w.global_batches()]
    return {"history": hist, "state": tr.state.state_dict(),
            "perbatch": {"losses": losses, "state": pb.state.state_dict()}}


def assert_states_close(got: dict, want: dict, atol: float) -> None:
    for part in ("model", "ema"):
        assert got[part].keys() == want[part].keys()
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), atol=atol,
                                       err_msg=f"{part}.{k}")


CASES = [("dp+perbatch+bn", 2), ("dp", 4), ("fsdp", 2)]


@pytest.mark.parametrize("scenario,world", CASES, ids=["dp2", "dp4", "fsdp2"])
def test_data_parallel_training_matches_one_process(runs, reference, scenario, world):
    outs, _ = runs(scenario, world)
    want = reference["history"]
    for r, o in enumerate(outs):
        assert o["scan"] and o["step"] == 6 and o["primary"] == (r == 0)
        np.testing.assert_allclose(o["history"]["train_loss"], want["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(o["history"]["val_loss"], want["val_loss"], rtol=1e-5)
        assert_states_close(o["state"], reference["state"], atol=5e-3)
        # every process ends with the same whole state
        for k, v in outs[0]["state"]["model"].items():
            assert torch.equal(o["state"]["model"][k], v), k
    # the rule sharded the large leaves under fsdp, nothing under dp
    assert bool(outs[0]["sharded"]) == scenario.startswith("fsdp")


def test_per_batch_path_matches_one_process(runs, reference):
    """``train_step`` on each process's rows of the global batches (the
    draws the global batch's): the one-process steps on the whole batches."""
    outs, _ = runs(*CASES[0])
    for o in outs:
        np.testing.assert_allclose(o["perbatch"]["losses"], reference["perbatch"]["losses"],
                                   rtol=1e-5)
        assert_states_close(o["perbatch"]["state"], reference["perbatch"]["state"], atol=5e-3)


def test_only_the_primary_process_writes(runs):
    """Checkpoints and metrics come from rank 0 alone: one record an epoch."""
    for scenario, world in (CASES[0], CASES[2]):
        _, out = runs(scenario, world)
        run = out / "run" / "pixel" / "mp"
        assert (run / "checkpoints" / "state.pt").exists()
        assert (run / "checkpoints" / "diffusion_model_ema.pt").exists()
        records = [json.loads(ln) for ln in (run / "metrics.jsonl").read_text().splitlines()]
        for epoch in range(w.EPOCHS):
            assert sum(1 for r in records if r.get("epoch") == epoch) == 1


def test_fsdp_sample_grid_from_the_gathered_ema(runs, tmp_path):
    """Under FSDP the grid is sampled from the EMA weights gathered into an
    unsharded copy: every process draws the images one process samples from
    the same EMA weights, bit for bit."""
    outs, _ = runs(*CASES[2])
    torch.set_num_threads(1)
    tr = w.tiny_trainer(w.tiny_config(tmp_path))
    tr.state.ema.load_state_dict(outs[0]["state"]["ema"])
    want = tr.sample([1, 2, 3], cfg_scale=3.0, method="ddim", ddim_steps=2)
    for o in outs:
        assert o["grid"].shape == (3, 8, 8, 1) and o["grid"].dtype == np.uint8
        np.testing.assert_array_equal(o["grid"], want)


def test_fsdp_checkpoint_resume_is_bitwise(runs):
    """The whole state gathered to rank 0's file, read back by every
    process into its shards: the gathered state equals the one saved, bit
    for bit (model, EMA, Adam's moments and step counts)."""
    outs, _ = runs(*CASES[2])
    for o in outs:
        before, after = o["state"], o["resumed"]
        assert after["step"] == before["step"] == 6
        for part in ("model", "ema"):
            for k, v in before[part].items():
                assert torch.equal(after[part][k], v), (part, k)
        for i, st in before["optimizer"]["state"].items():
            for k, v in st.items():
                assert torch.equal(after["optimizer"]["state"][i][k], v), (i, k)


def test_fsdp_kernel_weight_copies_follow_the_weights(runs):
    """FSDP2 all-gathers the weights into storage it keeps (often at the same
    address) and leaves its version counter alone, while Adam moves only the
    shards: an attention block's cached kernel copies must still be made
    again after every step.  Read at the start of each of three steps'
    forwards, the copies equal fresh ones, and the cache key moved at every
    step by more than the weights' addresses (which move or not as the
    allocator pleases): by the state's word that the weights moved."""
    outs, _ = runs(*CASES[2])
    for o in outs:
        sharded = "".join(o["sharded"])
        assert "fn.fn.to_qkv.weight" in sharded and "fn.fn.to_out.0.weight" in sharded
        assert all(fresh for _, fresh in o["cache"]), o["cache"]
        keys = [k for k, _ in o["cache"]]
        for k0, k1 in zip(keys, keys[1:]):
            # (address, version) of the two weights, then the moves counted
            assert (k1[1], k1[3], k1[4]) != (k0[1], k0[3], k0[4]), keys


@pytest.mark.parametrize("scenario,world", [CASES[2], CASES[1]], ids=["n2", "n4"])
def test_fsdp_holds_its_share_of_the_flagship_state(runs, scenario, world):
    """The flagship UNet's parameters under the rule: each process holds the
    bytes the shapes give (sharded leaves 1/N, the rest whole), about 1/N of
    the replicated state."""
    outs, _ = runs(scenario, world)
    for o in outs:
        assert o["flagship_bytes"] == o["flagship_bytes_expected"]
        share = o["flagship_bytes"] / o["flagship_bytes_replicated"]
        assert 1 / world <= share < 1 / world + 0.01, share


def test_classifier_batch_norm_reads_global_statistics(runs, tmp_path):
    """Two processes, 4 steps of the classifier on their rows: BatchNorm's
    running statistics equal one process's on the whole batches (1e-6), and
    with each process's own statistics they do not; the losses of 4 trained
    steps equal one process's (rtol 1e-5).

    The statistics are compared at lr 0 (the weights stay the initial ones):
    trained, the shortcut's conv bias in front of a BatchNorm has a zero
    gradient, so its computed gradient is rounding noise, which Adam turns
    into steps of about lr that land in the running mean (about 2e-5 apart
    after 4 steps at lr 5e-4, whatever the statistics)."""
    torch.set_num_threads(1)
    want = {}
    for name, lr in (("stats", 0.0), ("trained", 5e-4)):
        tr = w.classifier_trainer(w.classifier_config(tmp_path / name, lr))
        losses = [tr.train_step(b)["loss"].item() for b in w.global_batches(4)]
        want[name] = (losses, w.running_stats(tr.model))
    outs, _ = runs(*CASES[0])
    for o in outs:
        losses, stats = want["stats"]
        np.testing.assert_allclose(o["bn_global"]["losses"], losses, rtol=1e-5)
        for k, v in stats.items():
            np.testing.assert_allclose(o["bn_global"]["stats"][k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=0, err_msg=k)
        wrong = o["bn_per_rank"]["stats"]
        assert max(float((wrong[k] - v).abs().max()) for k, v in stats.items()) > 1e-4
        np.testing.assert_allclose(o["bn_trained"]["losses"], want["trained"][0], rtol=1e-5)


@pytest.mark.parametrize("scenario,world", CASES, ids=["dp2", "dp4", "fsdp2"])
def test_gather_rows_inverts_local_rows(runs, scenario, world):
    """Every process's rows gathered in rank order (an all-reduce of
    zero-padded blocks, which gloo offers for CUDA tensors too) are the
    global batch, bit for bit, on every process."""
    outs, _ = runs(scenario, world)
    assert all(o["gathered"] for o in outs)


def test_rows_of_a_global_batch_partition_it():
    """``shard_batch`` under a mesh of P takes rank r's block; the blocks
    in rank order are the batch."""
    class FakeMesh:
        def __init__(self, rank, size):
            self.rank, self.size = rank, size

        def local_rows(self, x):
            from ldm_tpu_torch.parallel.mesh import Mesh

            return Mesh.local_rows(self, x)

    b = w.global_batches(1)[0]
    for p in (1, 2, 4):
        parts = [shard_batch(FakeMesh(r, p), b) for r in range(p)]
        for k in b:
            np.testing.assert_array_equal(np.concatenate([q[k] for q in parts]), b[k])
