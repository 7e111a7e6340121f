"""Probe 39b: phases B-C of probe 39 again, from the run directory it left
(the port of the JAX package's perf/probe39b_res64_resume.py).

    python -m ldm_tpu_torch.perf.probe39b_res64_resume [--config PATH]
        [--n-fid 2048] [--device cuda|cpu] [--out probe39.json]

The diffusion trainer of configs/protocol_hard_64.yaml restores the run
directory's best state (``<checkpoints>/best_state.pt``, through
``DiffusionTrainer.load_state``); the exp1 classifier loads its best
weights (``<classifier checkpoints>/resnet64_exp1.pt``) where probe 39
left them and trains (phase B) where it did not; then Phase C as probe 39
runs it, after one warm-up batch a sampler.  The draws are probe 39's, so
from the same state the images are probe 39's bit for bit under cuDNN's
deterministic algorithms.

``train`` is read from the run's ``metrics.jsonl`` (its last run: the
records from the last epoch 0 on), not transcribed: the steps (replayed and
eager), the epochs, the last validation loss and the mean of the logged
steps/s (the first epoch logs none); ``classifier`` likewise from the
classifier's.  Every function is probe 39's; prints one line a sampler,
with the card's name and power limit; writes JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.factory import load_config
from ldm_tpu_torch.perf import probe39_res64 as p39
from ldm_tpu_torch.perf.common import device_tag
from ldm_tpu_torch.utils.seed import apply_runtime_flags


def last_run(path: str) -> list:
    """The records of ``metrics.jsonl``'s last run: from its last epoch-0
    record on."""
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    starts = [i for i, r in enumerate(recs) if r.get("epoch") == 0]
    return recs[starts[-1]:] if starts else recs


def train_summary(config: Config) -> dict:
    """Phase A's numbers from the run's metrics."""
    path = os.path.join(config.dirpath, "metrics.jsonl")
    recs = last_run(path)
    epochs = [r for r in recs if "diffusion_model val_loss" in r]
    rates = [r["steps_per_sec"] for r in epochs if "steps_per_sec" in r]
    ends = [r for r in recs if "train_steps_graphed" in r]
    steps = (ends[-1]["train_steps_graphed"] + ends[-1]["train_steps_eager"]) if ends else None
    return {"steps": steps, "epochs_run": len(epochs),
            "final_val_loss": epochs[-1]["diffusion_model val_loss"] if epochs else None,
            "steps_per_sec": float(np.mean(rates)) if rates else None,
            "source": path}


def classifier_from_metrics(clf_cfg: Config, epochs: int) -> dict:
    """The classifier's row from its run's metrics."""
    name = p39.CLF_NAME
    recs = [r for r in last_run(os.path.join(clf_cfg.dirpath, "metrics.jsonl"))
            if f"{name} valid_f1" in r]
    return {"name": name, "epochs": epochs, "epochs_run": len(recs),
            "best_valid_f1": max(r[f"{name} valid_f1"] for r in recs),
            "best_valid_loss": min(r[f"{name} valid_loss"] for r in recs)}


def run(config: Config, n_fid: int = p39.N_FID, clf_epochs: int = p39.CLF_EPOCHS,
        clf_val: int = p39.CLF_VAL, device="cuda", batch: int = p39.B,
        log: Callable[[str], None] = print, tag: str = "") -> dict:
    """Phases B-C from ``config``'s run directory; probe 39's JSON (``train``
    from the metrics), plus ``images`` and the trainers."""
    device = torch.device(device)
    trainer = p39.diffusion_trainer(config, device)
    ckpt = os.path.join(config.checkpoints, "best_state.pt")
    trainer.load_state(ckpt)
    log(f"probe39b restored the best state from {ckpt} (step {trainer.state.step}) [{tag}]")

    clf = p39.classifier_trainer(config, device, clf_epochs, clf_val)
    weights = os.path.join(clf.config.checkpoints, f"{p39.CLF_NAME}.pt")
    if os.path.exists(weights):
        clf.load_best()
        summary = classifier_from_metrics(clf.config, clf_epochs)
        log(f"probe39b loaded the classifier from {weights} [{tag}]")
    else:
        summary = p39.classifier_summary(clf.train(), clf_epochs)
        clf.load_best()

    out = {"device": tag or str(device), "n": n_fid, "image_size": p39.SIZE,
           "t": config.diffusion.n_steps, "train": train_summary(config),
           "classifier": summary}
    c = p39.phase_c(trainer, clf.model, device, n_fid, batch, warm=True, log=log, tag=tag)
    out.update(c["rows"])
    out["launches"] = c["launches"]
    out["images"] = c["images"]
    out["trainer"], out["classifier_trainer"] = trainer, clf
    return out


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=p39.CONFIG)
    ap.add_argument("--n-fid", type=int, default=p39.N_FID)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="write the result here as JSON")
    a = ap.parse_args(argv)
    tag = device_tag(a.device)
    config = load_config(a.config)
    apply_runtime_flags(config)
    out = p39.json_rows(run(config, a.n_fid, device=a.device, tag=tag))
    print(json.dumps(out))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=2)
    return out


if __name__ == "__main__":
    main()
