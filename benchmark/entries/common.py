"""What the entries share: the program's configuration from a
configuration file, the seeded weights loaded into the program, and the
window's clock."""

from __future__ import annotations

import copy
import gc
import time
from typing import Dict

import torch

from benchmark import weights
from benchmark.reference.unet import param_shapes as unet_shapes
from benchmark.reference.vae import param_shapes as vae_shapes

UNET_SALT, VAE_SALT = 1, 2


def program_config(run, workdir: str):
    """The port's ``Config`` from the configuration file's ``program``
    block (the reference's YAML schema), its run directory ``workdir``."""
    from ldm_tpu_torch.config import config_from_dict

    raw = copy.deepcopy(run.config["program"])
    raw["workdir"] = workdir
    return config_from_dict(raw)


def unet_weights(run) -> Dict[str, torch.Tensor]:
    return weights.make(unet_shapes(run.config["program"]["model"]["params"]), run.seed,
                        UNET_SALT, run.device)


def vae_weights(run) -> Dict[str, torch.Tensor]:
    return weights.make(vae_shapes(run.config["program"]["autoencoder"]["params"]), run.seed,
                        VAE_SALT, run.device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def read_peak(run) -> None:
    if run.device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(run.device)


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Window:
    """The measured window: opens on a device sync, closes on one."""

    def __init__(self, run):
        self.run = run
        sync(run.device)
        self.t0 = time.perf_counter()
        run.e2e["setup_s"] = self.t0 - run.t_process

    def open(self) -> bool:
        return time.perf_counter() - self.t0 < self.run.seconds

    def close(self) -> float:
        sync(self.run.device)
        self.run.window_s = time.perf_counter() - self.t0
        return self.run.window_s
