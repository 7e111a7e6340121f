"""The multi-process runtime (port of ldm_tpu/parallel/distributed.py).

JAX runs one controller process per host and a mesh over the global device
list.  PyTorch's idiom is one process per device, joined by a
``torch.distributed`` process group; the collectives are explicit (or
FSDP2's).  This module is the process-group half:

* :func:`initialize` joins the group the environment describes, from the
  same variables as the JAX package (``LDM_TPU_COORDINATOR`` host:port,
  ``LDM_TPU_NUM_PROCESSES``, ``LDM_TPU_PROCESS_ID``), or with
  ``LDM_TPU_DISTRIBUTED=1`` from torchrun's ``RANK`` / ``WORLD_SIZE`` /
  ``MASTER_ADDR`` / ``MASTER_PORT`` (the launcher's counterpart of the pod's
  autodetect).  The backend follows the device: ``nccl`` on CUDA, ``gloo``
  on the CPU.  Nothing set: no group, and it returns False.
* :func:`process_count` / :func:`process_index` / :func:`is_primary` read the
  default group (1 / 0 / True without one).  Host-side effects (checkpoints,
  ``metrics.jsonl``, sample grids) happen on the primary process only.
* :func:`per_host_subset` is this process's rows ``r::P`` of a dataset, for
  the per-batch loader path; the device-resident epoch instead holds the
  whole set on every process and gathers its rows of each global batch
  (``training/scan_epochs.py``).
* :func:`build_kernels_once`: the primary process compiles the CUDA kernels
  and the host batcher, the others wait at a barrier, so ``nvcc`` runs once.

Nothing here runs at import.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def local_device(device="cuda") -> torch.device:
    """This process's device of ``device``'s type: on CUDA the card of its
    local rank (``LOCAL_RANK``, else the global rank modulo the cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    if "LOCAL_RANK" in os.environ:
        index = int(os.environ["LOCAL_RANK"])
    else:
        index = process_index() % max(torch.cuda.device_count(), 1)
    return torch.device("cuda", index)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device="cuda") -> bool:
    """Join the process group the arguments or the environment describe;
    True if there is one (already joined counts), False if nothing is set.

    ``coordinator_address`` (``LDM_TPU_COORDINATOR``) is the ``host:port`` of
    the rank-0 process's store, with ``num_processes`` and ``process_id``
    (``LDM_TPU_NUM_PROCESSES``, ``LDM_TPU_PROCESS_ID``); else
    ``LDM_TPU_DISTRIBUTED=1`` reads torchrun's variables (``env://``).  On a
    CUDA device the process takes its local card as the current device."""
    if dist.is_initialized():
        return True
    coordinator_address = coordinator_address or os.environ.get("LDM_TPU_COORDINATOR")
    if num_processes is None and "LDM_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["LDM_TPU_NUM_PROCESSES"])
    if process_id is None and "LDM_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["LDM_TPU_PROCESS_ID"])
    backend = backend_for(device)
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs LDM_TPU_NUM_PROCESSES and "
                             "LDM_TPU_PROCESS_ID (or the arguments)")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    elif os.environ.get("LDM_TPU_DISTRIBUTED") == "1":
        dist.init_process_group(backend, init_method="env://")
    else:
        return False
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device(device))
    return True


def initialize_single(device) -> None:
    """A group of one process (an in-memory store), where a mesh needs a
    group and the environment describes none: ``--mesh`` on one card."""
    if not dist.is_initialized():
        dist.init_process_group(backend_for(device), store=dist.HashStore(),
                                rank=0, world_size=1)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side effects; always True
    without a group."""
    return process_index() == 0


def per_host_subset(dataset, rank: Optional[int] = None, world: Optional[int] = None):
    """This process's disjoint slice of a dataset: rows ``r::P`` of the
    dataset truncated to a multiple of P, so every process holds as many
    rows (unequal counts would give the processes batches of different
    shapes, and the next collective would hang).  ``rank`` / ``world``
    default to the default group's."""
    p = process_count() if world is None else int(world)
    r = process_index() if rank is None else int(rank)
    n = len(dataset) - len(dataset) % p
    return dataset.subset(np.arange(r, n, p))


def build_kernels_once(device, group=None) -> None:
    """On a CUDA device: the group's first process builds the kernels
    (``ops/build.py``) and the host batcher (``native/build.py``), then every
    process passes a barrier; each builds nothing again (both builds are
    keyed on their sources and written atomically)."""
    if torch.device(device).type != "cuda":
        return
    if dist.get_rank(group) == 0:
        from ldm_tpu_torch.native.build import lib_path
        from ldm_tpu_torch.ops import build

        build.build()
        lib_path()
    dist.barrier(group)


def per_host_loader(loader, mesh):
    """The per-batch loader path under a mesh: a loader of the same kind
    over this process's :func:`per_host_subset`, at this process's share
    of the global batch (shuffled within the subset, from the same seed)."""
    if loader.batch_size % mesh.size:
        raise ValueError(f"a global batch of {loader.batch_size} does not split over "
                         f"the mesh's data axis ({mesh.size})")
    return type(loader)(per_host_subset(loader.dataset, mesh.rank, mesh.size),
                        loader.batch_size // mesh.size, shuffle=loader.shuffle,
                        seed=loader.seed, drop_last=loader.drop_last,
                        transform=loader.transform, prefetch=loader.prefetch)
