"""The entry points' shared runtime flags (port of ldm_tpu/utils/cli.py).

``--device``       where to run: ``cuda`` (the default) or ``cpu``; it takes
                   the place of the JAX package's ``--cpu``
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


class Runtime(NamedTuple):
    device: torch.device
    mesh: Optional[Mesh]


def add_runtime_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--strict-data", action="store_true",
                    help="no synthetic fallback: fail if dataset files are absent")
    ap.add_argument("--mesh", action="store_true",
                    help="data parallel over the process group the environment describes")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group the environment describes (implies --mesh)")


def runtime_setup(args) -> Runtime:
    """The device and the mesh the flags ask for (no mesh without
    ``--mesh`` / ``--distributed``).  Under a mesh the device is this
    process's (on CUDA the card of its local rank)."""
    from ldm_tpu_torch.parallel import distributed
    from ldm_tpu_torch.parallel.mesh import create_mesh

    device = torch.device(args.device)
    distributed_flag = getattr(args, "distributed", False)
    if not (distributed_flag or getattr(args, "mesh", False)):
        return Runtime(device, None)
    if not distributed.initialize(device=device) and distributed_flag:
        raise RuntimeError(
            "--distributed needs LDM_TPU_COORDINATOR, LDM_TPU_NUM_PROCESSES and "
            "LDM_TPU_PROCESS_ID, or LDM_TPU_DISTRIBUTED=1 with torchrun's RANK, "
            "WORLD_SIZE, MASTER_ADDR and MASTER_PORT")
    mesh = create_mesh(device=device)
    return Runtime(mesh.device, mesh)
