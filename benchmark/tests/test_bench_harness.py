"""The harness on the CPU at a tiny size: cells found by name from files
alone, every cell run end to end and checked, the faults each cell can
have seen as incorrect, the rules of ``BENCHMARK.json``, the imports, and
the frozen operation count against the program's own."""

from __future__ import annotations

import ast
import copy
import json
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import harness, yardsticks
from benchmark.spec import HERE, ROOT, load_json
from benchmark.tests.tiny import run_cell, tiny_spec

SPEC = load_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_and_is_correct_at_a_tiny_size(cell, tmp_path, capsys):
    line = run_cell(tiny_spec(tmp_path), cell, capsys)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    e2e = {m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", [cell])}
    assert set(line["metrics"]) == e2e
    assert list(line)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_its_per_layer_metrics(cell, tmp_path, capsys):
    line = run_cell(tiny_spec(tmp_path), cell, capsys, trace=1)
    assert line["correct"] is True
    assert "busy_s" in line["device"] and "window_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in SPEC["per_layer"] if cell in m["workloads"]}
    # the CPU has no device trace: only the host's and the counters' metrics read
    assert set(line["metrics"]) <= names
    for m in SPEC["per_layer"]:
        if m["name"] in line["metrics"]:
            assert m["source"] in ("host_clock", "program_counter")


def test_a_cell_added_as_files_alone_is_found_and_run(tmp_path, capsys):
    """A new configuration and a new cell: two files and two entries, no
    file of the benchmark edited."""
    src = tmp_path / "src"
    src.mkdir()
    cfg = load_json(ROOT / SPEC["configs"][0]["file"])
    cfg["name"] = "cifar10-pixel-added"
    (src / "cifar10-pixel-added.json").write_text(json.dumps(cfg))
    spec = copy.deepcopy(SPEC)
    spec["configs"].append({"name": "cifar10-pixel-added", "source": "test",
                            "file": str(src / "cifar10-pixel-added.json"),
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "pixel-sample-added", "config": "cifar10-pixel-added",
                              "traffic": "ddim-added", "chips": 1, "why": "test"})
    for m in spec["end_to_end"]:
        if m["name"] == "sample_img_per_s":
            m["workloads"].append("pixel-sample-added")
    s = tiny_spec(tmp_path, spec)
    cell = load_json(HERE / "workloads" / "pixel-sample-ddpm400-b128.json")
    cell["params"].update(batch=2, check_images=2)
    (tmp_path / "workloads" / "pixel-sample-added.json").write_text(json.dumps(cell))
    line = run_cell(s, "pixel-sample-added", capsys)
    assert line["correct"] is True
    assert line["attempted"] % 2 == 0 and "sample_img_per_s" in line["metrics"]


# --- the faults a cell can have, planted under the timed path -------------

def _no_update(self):
    self.step_t += 1  # the counter moves, the parameters, Adam and the EMA do not


def _half_mse(self, target, out):
    half = target.shape[0] // 2
    return torch.mean((target[:half].to(torch.float32) - out[:half]) ** 2)


def _altered(fn):
    def wrapped(*a, **k):
        return fn(*a, **k) + 0.25  # every answer altered where it is produced
    return wrapped


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_faults_come_out_incorrect(fault, tmp_path, capsys, monkeypatch):
    from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
    from ldm_tpu_torch.training.state import TrainState

    if fault == "unchanged_state":
        monkeypatch.setattr(TrainState, "update", _no_update)
    else:
        monkeypatch.setattr(DiffusionTrainer, "_mse", _half_mse)
    line = run_cell(tiny_spec(tmp_path), "pixel-train-b64", capsys)
    assert line["correct"] is False


def test_a_fault_past_the_first_epoch_comes_out_incorrect(tmp_path, capsys, monkeypatch):
    """Steps that leave the state unchanged once the feed has left its first
    epoch: the checked steps from the seed read sound, the late step, which
    lies past the window's epoch ends, does not."""
    from ldm_tpu_torch.training.scan_epochs import EpochScan
    from ldm_tpu_torch.training.state import TrainState

    past = {"on": False}
    start, update = EpochScan.start_epoch, TrainState.update

    def start_epoch(self, seed, epoch, order=None):
        past["on"] = epoch > 0
        start(self, seed, epoch, order=order)

    monkeypatch.setattr(EpochScan, "start_epoch", start_epoch)
    monkeypatch.setattr(TrainState, "update",
                        lambda self: _no_update(self) if past["on"] else update(self))
    line = run_cell(tiny_spec(tmp_path), "pixel-train-b64", capsys)
    checks = line["checks"]
    assert line["correct"] is False
    for name in ("grad", "change", "ema_change"):
        assert checks[name]["value"] <= checks[name]["limit"], name
    assert checks["late_ema_change_median"]["value"] > checks["late_ema_change_median"]["limit"]


@pytest.mark.parametrize("cell", ["pixel-sample-ddpm400-b128", "latent-sample-ddpm1000-b128"])
def test_an_altered_sample_comes_out_incorrect(cell, tmp_path, capsys, monkeypatch):
    from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
    from ldm_tpu_torch.models.latent import LatentDiffusionModel

    if cell.startswith("latent"):
        monkeypatch.setattr(LatentDiffusionModel, "sample_images",
                            _altered(LatentDiffusionModel.sample_images))
    else:
        monkeypatch.setattr(GaussianDiffusion, "sample", _altered(GaussianDiffusion.sample))
    line = run_cell(tiny_spec(tmp_path), cell, capsys)
    assert line["correct"] is False


def test_an_altered_served_image_comes_out_incorrect(tmp_path, capsys, monkeypatch):
    from ldm_tpu_torch.serving import service

    pack = service.pack_uint8
    monkeypatch.setattr(service, "pack_uint8", lambda x: pack(-x))
    line = run_cell(tiny_spec(tmp_path), "pixel-serve-ddim50-open", capsys)
    assert line["correct"] is False


# --- BENCHMARK.json ---------------------------------------------------------

def test_benchmark_json_keeps_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for g in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[g]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in SPEC["workloads"]] + \
            [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    assert 1 <= SPEC["run_seconds"] <= 51
    assert 2 + 14 * 24 * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"], []).append(m["name"])
    for cell in CELLS:  # every cell: setup_s, another end-to-end metric, a per-layer one
        assert sum(cell in m.get("workloads", [cell]) for m in SPEC["end_to_end"]) >= 2
        assert any(cell in m["workloads"] for m in SPEC["per_layer"])


# --- imports ----------------------------------------------------------------

def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ldm_tpu_torch_like", types.ModuleType("x"))
    assert "ldm_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ldm_tpu.sub", types.ModuleType("ldm_tpu.sub"))
    assert "ldm_tpu" in harness.forbidden_modules()


def test_a_run_imports_nothing_of_jax_or_the_jax_package(tmp_path):
    code = (
        "import sys, json, tempfile\n"
        "from pathlib import Path\n"
        "from benchmark import run\n"
        "from benchmark.tests.tiny import tiny_spec\n"
        "d = tempfile.mkdtemp()\n"
        "rc = run.main(['--workload', 'pixel-train-b64', '--seed', '5', '--seconds', '0.5',\n"
        "               '--trace', '0'], require_card=False, spec=tiny_spec(Path(d)),\n"
        "              device='cpu')\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "ldm_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "collections", "math", "typing", "numpy", "torch", "benchmark"}
    for path in (HERE / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in allowed, (path.name, n)
                if n.startswith("benchmark"):
                    assert n.startswith("benchmark.reference"), (path.name, n)
    code = ("import sys, benchmark.reference.unet, benchmark.reference.vae, "
            "benchmark.reference.diffusion\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert "ldm_tpu" not in out.stdout and "jax" not in out.stdout, out.stdout


# --- the frozen yardsticks ---------------------------------------------------

@pytest.mark.parametrize("channels,mults", [(16, [1, 2]), (32, [1, 2, 4])])
def test_the_frozen_forward_count_is_the_programs_but_for_attention_association(
        channels, mults):
    """The program's own count (``ldm_tpu_torch/perf/flops.py``) runs its
    plain attention, which multiplies by block-diagonal masks over all 128
    hidden lanes and takes ctx Wout before q; the reference multiplies each
    head's 32 lanes.  Per item and site that is 49,152 N + 32,768 C more
    products in the program's count, and nothing else differs."""
    from ldm_tpu_torch.models.unet import UNet
    from ldm_tpu_torch.perf import flops as program_flops
    from benchmark.reference.unet import attention_sites

    p = dict(in_channels=3, out_channels=3, channels=channels, channel_multipliers=mults,
             with_time_emb=True, num_classes=10)
    side, b = 32, 4
    ours = yardsticks.unet_forward_flops(p, 2 * b, (side, side, 3)) / b
    theirs = program_flops.sampler_flops_per_img_step(UNet(**p), (side, side, 3), batch=b)
    extra = 2 * sum(49152 * n + 32768 * c for n, c in attention_sites(p, side))
    assert theirs - ours == extra


def test_the_bounds_are_the_frozen_arithmetic():
    # the chip_smoke numbers of PERF.md's kernel table: 8 sites, 2B=128 forward
    sites = [(1024, 64), (256, 128), (64, 256), (16, 512), (16, 256), (64, 128), (256, 64),
             (1024, 64)]
    fwd = sum(yardsticks.la_bound_s(128, n, c, False) for n, c in sites) * 1e3
    bwd = sum(yardsticks.la_bound_s(64, n, c, True) for n, c in sites) * 1e3
    assert fwd == pytest.approx(0.0342, abs=1e-4)
    assert bwd == pytest.approx(0.0498, abs=1e-4)
    assert yardsticks.adam_ema_bound_s(20350915) * 1e3 == pytest.approx(0.2187, abs=1e-4)


def test_every_seed_of_the_open_loop_offers_the_same_work():
    from benchmark.traffic.open_poisson import Traffic

    params = load_json(HERE / "workloads" / "pixel-serve-ddim50-open.json")["params"]
    a = Traffic(params, 1, "cpu", 10).schedule(30.0)
    b = Traffic(params, 2**31 + 5, "cpu", 10).schedule(30.0)
    assert [(r.due, r.n) for r in a] == [(r.due, r.n) for r in b]
    assert [r.cls for r in a] != [r.cls for r in b]
    assert len(a) == pytest.approx(params["rate_rps"] * 30, abs=2)
    assert np.mean([r.n for r in a]) == pytest.approx(
        (params["min_images"] + params["max_images"]) / 2, rel=0.02)
