"""The real-data drill of tests/test_realdata_drill.py, through the port:
``python -m ldm_tpu_torch.main`` driven by argv with ``--cpu --strict-data``
from fabricated full-format MNIST IDX files on disk (the same writer, the
same tiny config) must run the whole protocol and print root main.py's JSON;
once the files are gone the same argv must raise ``FileNotFoundError``."""

import json
import shutil

import numpy as np
import pytest
import torch
import yaml

from ldm_tpu_torch import main as port_main

from test_realdata_drill import _write_mnist


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the protocol is thousands of small CPU ops, and
    test workers with a full OpenMP team each slow each other down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drill_config(tmp_path):
    """tests/test_realdata_drill.py's config, its targets the JAX names the
    port's registry maps."""
    return {
        "project_name": "drill", "type": "pixel", "debugging": False, "batch_size": 2,
        "epochs": 1, "lr": 5e-4, "use_amp": False, "loss_fn": "mse",
        "early_stopping_patience": 2, "workdir": str(tmp_path / "runs"), "sample_every": 0,
        "diffusion": {"type": "pixel", "cfg_scale": 3,
                      "params": {"n_steps": 8, "n_samples": 4}},
        "model": {"target": "ldm_tpu.models.unet.UNet",
                  "params": {"in_channels": 1, "out_channels": 1, "channels": 8,
                             "channel_multipliers": [1, 2], "num_classes": 10}},
        "data": {"dataset": "MNIST", "image_channels": 1, "image_size": 16,
                 "val_split": 0.1, "data_path": str(tmp_path / "data")},
    }


def test_main_protocol_from_raw_files_strict(tmp_path, capsys):
    _write_mnist(tmp_path / "data")
    cfg_path = tmp_path / "drill.yaml"
    cfg_path.write_text(yaml.safe_dump(drill_config(tmp_path)))
    argv = [str(cfg_path), "--cpu", "--strict-data", "--per-class", "2",
            "--classifier-epochs", "1", "--sampler", "ddim", "--ddim-steps", "4"]

    res = port_main.main(argv)
    out = capsys.readouterr().out
    result = json.loads(out[out.index("{\n"):])
    assert set(result["test_f1"]) == {"exp1", "exp2", "exp3", "exp4", "exp5"}
    assert result["synthetic_size"] == 20  # --per-class 2 x 10 classes
    assert np.isfinite(result["fid_pixel"])
    assert (tmp_path / "runs" / "pixel" / "drill" / "metrics.jsonl").exists()
    # the data came from the files: 64 train images split 32 / 32, 16 test
    loaders = (res.diffusion_trainer.train_loader, res.diffusion_trainer.val_loader)
    assert sum(len(dl.dataset) for dl in loaders) == 32
    test = res.classifier_trainer.test_loader.dataset
    assert test.name == "MNIST" and len(test) == 16
    assert res.synthetic.images.shape == (20, 16, 16, 1)

    # strict mode bites: without the files the same argv fails
    shutil.rmtree(tmp_path / "data")
    with pytest.raises(FileNotFoundError):
        port_main.main(argv)
