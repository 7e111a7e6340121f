"""The text-to-image cell and the 128 px training cell on the CPU at a tiny
size, end to end through ``benchmark.run``: correct as the program stands,
incorrect with an altered answer, and the traced run's readable metrics.

The text-to-image configuration is cut to a U-Net of 32 channels x 1/2 with
heads of 16 over a (7, 24) context and a VAE of 8 channels x 1/2 at 16 px
(8x8x4 latents), T = 10, DDIM over 3 steps, the program in float32 (a sound
run then reads rounding alone); the training cell is ``tiny.py``'s cut at
the traffic's own doubled size."""

from __future__ import annotations

import copy
import json
from pathlib import Path

import pytest

from benchmark.spec import HERE, ROOT, Spec, load_json
from benchmark.tests.tiny import PARAMS, run_cell, tiny_program

SD_CELL, RES_CELL = "sd21v-txt2img-ddim50-b8", "pixel128-train-b64"


def _spec(tmp: Path, cell: str) -> Spec:
    """BENCHMARK.json with ``cell`` alone, its configuration and traffic
    files cut and written under ``tmp``."""
    tmp = Path(tmp)
    (tmp / "configs").mkdir(exist_ok=True)
    (tmp / "workloads").mkdir(exist_ok=True)
    spec = copy.deepcopy(load_json(ROOT / "BENCHMARK.json"))
    spec["workloads"] = [w for w in spec["workloads"] if w["name"] == cell]
    name = spec["workloads"][0]["config"]
    spec["configs"] = [c for c in spec["configs"] if c["name"] == name]
    c = spec["configs"][0]
    cfg = load_json(ROOT / c["file"])
    t = load_json(HERE / "workloads" / f"{cell}.json")
    if cell == SD_CELL:
        prog = cfg["program"]
        prog["model"]["params"].update(model_channels=32, channel_mult=[1, 2],
                                       num_head_channels=16, context_dim=24)
        prog["autoencoder"]["params"].update(channels=8, channel_multipliers=[1, 2])
        prog["data"]["image_size"] = 16
        prog["diffusion"]["params"]["n_steps"] = 10
        prog["use_amp"] = False
        t["params"].update(batch=2, context_len=7, sampler_steps=3, check_images=3)
    else:
        cfg["program"] = tiny_program(cfg["program"])
        t["params"].update(PARAMS["train"], image_size=32)
    f = tmp / "configs" / f"{name}.json"
    f.write_text(json.dumps(cfg))
    c["file"] = str(f)
    (tmp / "workloads" / f"{cell}.json").write_text(json.dumps(t))
    return Spec(spec, tmp)


@pytest.mark.parametrize("cell", [SD_CELL, RES_CELL])
@pytest.mark.parametrize("trace", [0, 1])
def test_the_new_cells_run_and_are_correct_at_a_tiny_size(cell, trace, tmp_path, capsys):
    line = run_cell(_spec(tmp_path, cell), cell, capsys, trace=trace, seconds=3.0)
    assert line["correct"] is True, line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    spec = load_json(ROOT / "BENCHMARK.json")
    group = spec["per_layer" if trace else "end_to_end"]
    names = {m["name"] for m in group if cell in m.get("workloads", [cell])}
    if trace:  # no device trace on the CPU: the host's metrics alone
        assert set(line["metrics"]) <= names and "busy_s" in line["device"]
        assert "mfu.txt2img" in line["metrics"] or cell != SD_CELL
    else:
        assert set(line["metrics"]) == names
    want = {"image_rel_l2", "v_rel_l2"} if cell == SD_CELL else {
        "grad", "change", "ema_change", "late_loss", "late_ema_change_median"}
    assert set(line["checks"]) == want


def test_the_training_cell_trains_at_the_traffics_size(tmp_path, capsys, monkeypatch):
    from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer

    sizes = []
    init = DiffusionTrainer.__init__

    def record(self, config, *a, **k):
        sizes.append(config.data.image_size)
        init(self, config, *a, **k)

    monkeypatch.setattr(DiffusionTrainer, "__init__", record)
    run_cell(_spec(tmp_path, RES_CELL), RES_CELL, capsys)
    assert sizes == [32]


def test_an_altered_text_to_image_answer_comes_out_incorrect(tmp_path, capsys, monkeypatch):
    from ldm_tpu_torch.models.latent import LatentDiffusionModel

    decode = LatentDiffusionModel.autoencoder_decode
    monkeypatch.setattr(LatentDiffusionModel, "autoencoder_decode",
                        lambda self, z, scale=None: decode(self, z, scale) + 0.25)
    line = run_cell(_spec(tmp_path, SD_CELL), SD_CELL, capsys)
    assert line["correct"] is False
    assert line["checks"]["image_rel_l2"]["value"] > line["checks"]["image_rel_l2"]["limit"]
