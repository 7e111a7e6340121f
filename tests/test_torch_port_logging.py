"""The port's MetricsLogger (ldm_tpu_torch/utils/logging.py) held against
ldm_tpu/utils/logging.py: a twin of each stubbed-wandb test of
tests/test_logging.py, ``quiet``, a non-primary process, and the same calls
fed to both loggers giving the same records, summaries and lines."""

import json
import sys
import types

import numpy as np
import pytest
import torch

from ldm_tpu.utils.logging import MetricsLogger as JaxLogger
from ldm_tpu_torch.parallel import distributed
from ldm_tpu_torch.utils.logging import MetricsLogger


class _WandbStub(types.ModuleType):
    """The wandb surface the logger touches: run, init, log, Image,
    define_metric, Histogram; every call recorded."""

    def __init__(self):
        super().__init__("wandb")
        self.run = None
        self.logged, self.init_calls, self.define_calls = [], [], []

    def init(self, **kw):
        self.init_calls.append(kw)
        self.run = object()
        return self.run

    def log(self, metrics, step=None):
        self.logged.append((dict(metrics), step))

    def define_metric(self, key, summary=None):
        self.define_calls.append((key, summary))

    class Image:
        def __init__(self, data):
            self.data = np.asarray(data)

    class Histogram:
        def __init__(self, data):
            self.data = np.asarray(data)


@pytest.fixture
def stub(monkeypatch):
    s = _WandbStub()
    monkeypatch.setitem(sys.modules, "wandb", s)
    monkeypatch.delenv("WANDB_MODE", raising=False)
    return s


def records(path):
    return [json.loads(line) for line in (path / "metrics.jsonl").read_text().splitlines()]


def test_jsonl_sink_and_close(tmp_path):
    lg = MetricsLogger(str(tmp_path), "proj", quiet=True)
    lg.log({"loss": 1.5, "epoch": 0}, step=0)
    lg.log({"loss": np.float32(0.5), "epoch": 1}, step=1)
    lg.close()  # no-op: writes open and close their file
    lg.log({"loss": torch.tensor(0.25), "epoch": 2}, step=2)
    recs = records(tmp_path)
    assert [r["loss"] for r in recs] == [1.5, 0.5, 0.25]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all("ts" in r for r in recs)


def test_wandb_logs_metrics_and_images(tmp_path, stub):
    lg = MetricsLogger(str(tmp_path), "myproj", use_wandb=True, quiet=True)
    assert stub.init_calls == [{"project": "myproj", "mode": "offline"}]
    lg.log({"loss": np.float32(2.0)}, step=3)
    assert stub.logged[-1] == ({"loss": 2.0}, 3)

    imgs = np.zeros((4, 8, 8, 1), np.uint8)
    path = lg.log_images(imgs, step=5, mode="sample", dirpath=str(tmp_path / "res"))
    metrics, step = stub.logged[-1]
    assert step == 5 and isinstance(metrics["sample/images"][0], _WandbStub.Image)
    assert path == str(tmp_path / "res" / "sample_step5.npy")
    np.testing.assert_array_equal(metrics["sample/images"][0].data, np.load(path))


def test_wandb_images_without_dirpath(tmp_path, stub):
    """A grid reaches wandb when no directory is given; nothing is written."""
    lg = MetricsLogger(None, "p", use_wandb=True, quiet=True)
    imgs = np.random.default_rng(0).integers(0, 256, (4, 8, 8, 3), dtype=np.uint8)
    assert lg.log_images(imgs, step=2, mode="sample") is None
    metrics, step = stub.logged[-1]
    assert step == 2 and metrics["sample/images"][0].data.dtype == np.uint8
    assert list(tmp_path.iterdir()) == []


def test_an_existing_run_and_wandb_mode_are_respected(tmp_path, stub, monkeypatch):
    monkeypatch.setenv("WANDB_MODE", "disabled")
    MetricsLogger(str(tmp_path), "", use_wandb=True)
    assert stub.init_calls == [{"project": "ldm_tpu", "mode": "disabled"}]
    MetricsLogger(str(tmp_path), "again", use_wandb=True)  # a run is live: no second init
    assert len(stub.init_calls) == 1


def test_absent_wandb_module_is_a_noop(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import -> ImportError
    lg = MetricsLogger(str(tmp_path), "p", use_wandb=True, quiet=True)
    lg.log({"loss": 1.0}, step=0)
    lg.define_summaries({"loss": "min"})
    lg.log_images(np.zeros((1, 4, 4, 1), np.uint8), step=0, mode="s")
    assert lg._wandb is None and records(tmp_path)[0]["loss"] == 1.0


def test_log_norms_global_norm(tmp_path, stub):
    lg = MetricsLogger(str(tmp_path), "p", use_wandb=True, quiet=True)
    lg.log_norms("params", [torch.full((3,), 2.0), torch.zeros(4)], step=7)
    metrics, step = stub.logged[-1]
    assert step == 7
    np.testing.assert_allclose(metrics["params_global_norm"], np.sqrt(12.0), rtol=1e-6)
    np.testing.assert_allclose(records(tmp_path)[-1]["params_global_norm"], np.sqrt(12.0),
                               rtol=1e-6)


def test_define_summaries_local_and_wandb(tmp_path, stub):
    lg = MetricsLogger(str(tmp_path), "p", use_wandb=True, quiet=True)
    lg.define_summaries({"m train_loss": "min", "m valid_f1": "max"})
    assert stub.define_calls == [("m train_loss", "min"), ("m valid_f1", "max")]
    lg.log({"m train_loss": 2.0, "m valid_f1": 0.5}, step=0)
    lg.log({"m train_loss": 1.0, "m valid_f1": 0.9}, step=1)
    lg.log({"m train_loss": 3.0, "m valid_f1": 0.2}, step=2)
    summ = json.loads((tmp_path / "summary.json").read_text())
    assert summ == {"m train_loss.min": 1.0, "m valid_f1.max": 0.9}
    with pytest.raises(ValueError):
        lg.define_summaries({"x": "median"})


def test_define_summaries_without_wandb(tmp_path):
    lg = MetricsLogger(str(tmp_path), "p", quiet=True)
    lg.define_summaries({"loss": "min"})
    lg.log({"loss": 5.0}, step=0)
    lg.log({"loss": 3.0, "unrelated": 1.0}, step=1)
    assert json.loads((tmp_path / "summary.json").read_text()) == {"loss.min": 3.0}


def test_log_histograms_jsonl_and_wandb(tmp_path, stub):
    lg = MetricsLogger(str(tmp_path), "p", use_wandb=True, quiet=True)
    named = [("dense.kernel", torch.arange(6, dtype=torch.float32).reshape(2, 3)),
             ("dense.bias", torch.zeros(3))]
    lg.log_histograms("params", named, step=4)
    hrec = records(tmp_path)[-1]["params_histograms(min,max,mean,std)"]
    assert hrec["params/dense.kernel"][:3] == [0.0, 5.0, 2.5]
    np.testing.assert_allclose(hrec["params/dense.kernel"][3], np.arange(6).std(), rtol=1e-6)
    assert hrec["params/dense.bias"] == [0.0, 0.0, 0.0, 0.0]
    metrics, step = stub.logged[-1]
    assert step == 4 and isinstance(metrics["params/dense.kernel"], _WandbStub.Histogram)
    np.testing.assert_array_equal(metrics["params/dense.kernel"].data,
                                  np.arange(6, dtype=np.float32).reshape(2, 3))


def test_quiet_prints_nothing(tmp_path, capsys):
    MetricsLogger(str(tmp_path), quiet=True).log({"loss": 1.0}, step=0)
    assert capsys.readouterr().out == ""
    MetricsLogger(str(tmp_path)).log({"loss": 1.0}, step=0)
    assert capsys.readouterr().out == "step=0 loss=1\n"
    assert len(records(tmp_path)) == 2


def test_a_non_primary_process_writes_and_prints_nothing(tmp_path, stub, capsys, monkeypatch):
    monkeypatch.setattr(distributed, "is_primary", lambda: False)
    lg = MetricsLogger(str(tmp_path / "run"), "p", use_wandb=True)
    lg.define_summaries({"loss": "min"})
    lg.log({"loss": 1.0}, step=0)
    lg.log_images(np.zeros((1, 4, 4, 1), np.uint8), step=0, mode="s",
                  dirpath=str(tmp_path / "res"))
    lg.log_histograms("params", [("w", torch.ones(2))], step=0)
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []
    assert (stub.init_calls, stub.logged, stub.define_calls) == ([], [], [])


def test_same_calls_give_the_jax_loggers_records(tmp_path, capsys):
    """``define_summaries`` and ``log`` calls fed to the JAX and the port
    logger: the same ``metrics.jsonl`` records (``ts`` dropped), the same
    ``summary.json`` and the same stdout lines."""
    calls = [({"m train_loss": 2.0, "m val_loss": np.float32(1.75), "epoch": 0}, 0),
             ({"m train_loss": np.float32(0.5), "m val_loss": 1.25, "epoch": 1}, 1),
             ({"m train_loss": 0.75, "m val_loss": 1.5, "epoch": 2, "note": "x"}, 2),
             ({"fid": 12.5}, 0)]
    out = {}
    for name, cls in (("jax", JaxLogger), ("port", MetricsLogger)):
        lg = cls(str(tmp_path / name), "p")
        lg.define_summaries({"m train_loss": "min", "m val_loss": "min"})
        for metrics, step in calls:
            lg.log(metrics, step=step)
        recs = [{k: v for k, v in r.items() if k != "ts"} for r in records(tmp_path / name)]
        out[name] = (recs, (tmp_path / name / "summary.json").read_text(),
                     capsys.readouterr().out)
    assert out["port"] == out["jax"]
    assert json.loads(out["port"][1]) == {"m train_loss.min": 0.5, "m val_loss.min": 1.25}
