"""The entry points' shared runtime flags (port of ldm_tpu/utils/cli.py).

``--device``       where to run: ``cuda`` (the default) or ``cpu``; it takes
                   the place of the JAX package's ``--cpu``
``--strict-data``  fail if the dataset's files are absent instead of falling
                   back to seeded synthetic images
``--mesh`` / ``--distributed``  accepted and refused: data-parallel and
                   multi-host runs wait for ROADMAP queue 1, item 12
"""

from __future__ import annotations

import argparse

import torch

NOT_PORTED = "is not ported yet: parallelism waits for ROADMAP queue 1, item 12"


def add_runtime_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--strict-data", action="store_true",
                    help="no synthetic fallback: fail if dataset files are absent")
    ap.add_argument("--mesh", action="store_true", help=f"data parallel; {NOT_PORTED}")
    ap.add_argument("--distributed", action="store_true", help=f"multi-host; {NOT_PORTED}")


def runtime_setup(args) -> torch.device:
    """The device the flags ask for; ``--mesh`` / ``--distributed`` raise."""
    for flag in ("mesh", "distributed"):
        if getattr(args, flag, False):
            raise ValueError(f"--{flag} {NOT_PORTED}")
    return torch.device(args.device)
