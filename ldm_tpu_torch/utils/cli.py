"""The entry points' shared runtime flags (port of ldm_tpu/utils/cli.py).

``--device``       where to run: ``cuda`` (the default) or ``cpu``
``--cpu``          the same as ``--device cpu`` (the JAX package's flag); an
                   error together with ``--device``
``--wandb``        mirror metrics, sample grids and summaries to wandb
                   (``utils/logging.py``): offline unless ``WANDB_MODE`` says
                   otherwise, a no-op where the module is absent
``--strict-data``  fail if the dataset's files are absent instead of falling
                   back to seeded synthetic images
``--mesh``         data parallel over the process group the environment
                   describes (``parallel/distributed.py::initialize``): one
                   process a device, each with its rows of every global
                   batch; without one, a group of this process alone
``--distributed``  the same, and the environment must describe a group
                   (``LDM_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` /
                   ``_PROCESS_ID``, or ``LDM_TPU_DISTRIBUTED=1`` under
                   torchrun); implies ``--mesh``
"""

from __future__ import annotations

import argparse
from typing import NamedTuple, Optional

import torch

from ldm_tpu_torch.parallel.mesh import Mesh
from ldm_tpu_torch.utils.logging import MetricsLogger


class Runtime(NamedTuple):
    device: torch.device
    mesh: Optional[Mesh]
    logger: Optional[MetricsLogger]


def add_device_args(ap: argparse.ArgumentParser) -> None:
    """``--device`` (default ``cuda``) and ``--cpu``, which sets it to
    ``cpu``; giving both is an argparse error."""
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    group.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                       help="run on the CPU (--device cpu)")


def add_runtime_args(ap: argparse.ArgumentParser) -> None:
    add_device_args(ap)
    ap.add_argument("--wandb", action="store_true",
                    help="mirror metrics to wandb (offline unless WANDB_MODE says otherwise)")
    ap.add_argument("--strict-data", action="store_true",
                    help="no synthetic fallback: fail if dataset files are absent")
    ap.add_argument("--mesh", action="store_true",
                    help="data parallel over the process group the environment describes")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group the environment describes (implies --mesh)")


def runtime_setup(args, config=None) -> Runtime:
    """The device, the mesh and the logger the flags ask for: no mesh
    without ``--mesh`` / ``--distributed``, and under ``--wandb`` a
    ``MetricsLogger`` of ``config``'s run directory and project that mirrors
    to wandb (else None: the trainers make their own).  Under a mesh the
    device is this process's (on CUDA the card of its local rank)."""
    from ldm_tpu_torch.parallel import distributed
    from ldm_tpu_torch.parallel.mesh import create_mesh

    device, mesh = torch.device(args.device), None
    distributed_flag = getattr(args, "distributed", False)
    if distributed_flag or getattr(args, "mesh", False):
        if not distributed.initialize(device=device) and distributed_flag:
            raise RuntimeError(
                "--distributed needs LDM_TPU_COORDINATOR, LDM_TPU_NUM_PROCESSES and "
                "LDM_TPU_PROCESS_ID, or LDM_TPU_DISTRIBUTED=1 with torchrun's RANK, "
                "WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
        mesh = create_mesh(device=device)
        device = mesh.device
    logger = None
    if getattr(args, "wandb", False):
        logger = MetricsLogger(config.dirpath, config.project_name, use_wandb=True)
    return Runtime(device, mesh, logger)
