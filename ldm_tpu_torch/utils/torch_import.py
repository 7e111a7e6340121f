"""Reference torch checkpoints into the port (the twin of
``ldm_tpu/utils/torch_import.py``).

The reference saves weights-only checkpoints, ``torch.save(model.state_dict())``.
The port's modules carry the reference's submodule names and layouts
(NCHW convolution weights, (out, in) linear weights), so such a file loads
with ``load_state_dict(strict=True)`` as it is: an import here is that
load, with the checks the JAX package's mapping makes turned into one
error that names every missing key, extra key and shape mismatch before
anything is loaded.

One difference is kept, as the JAX importer keeps it: the reference's
bottleneck blocks own a time MLP they never call, so its weights sit at
their random init in every reference checkpoint.  The port's UNet owns
them too and uses them only with ``bottleneck_time_emb``;
:func:`without_bottleneck_time_mlp` writes them as zeros, so a model that
uses them computes what the reference (and the JAX import without them)
computes.

Entry point for files: ``python -m ldm_tpu_torch.import_torch_checkpoint``.
"""

from __future__ import annotations

from typing import Dict

import torch

KINDS = ("unet", "autoencoder", "classifier")
# the reference's bottleneck blocks: each owns a time MLP it never calls
BOTTLENECK_TIME_MLP = tuple(f"bottleneck.res{i}.mlp_t.1.{p}" for i in (1, 2)
                            for p in ("weight", "bias"))


def detect_kind(state_dict: Dict[str, torch.Tensor]) -> str:
    """``unet``, ``autoencoder`` or ``classifier`` from a reference
    state_dict's keys (as ``ldm_tpu.utils.torch_import.detect_kind``)."""
    keys = set(state_dict)
    if any(k.startswith("time_emb.") for k in keys):
        return "unet"
    if "quant_conv.weight" in keys:
        return "autoencoder"
    if "final_linear.weight" in keys:
        return "classifier"
    raise ValueError(
        "cannot detect checkpoint kind from keys (expected a reference UNet, "
        "Autoencoder, or ResNetBase state_dict)"
    )


def without_bottleneck_time_mlp(state_dict: Dict[str, torch.Tensor],
                                model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``state_dict`` with the bottleneck blocks' time-MLP weights as zeros
    of ``model``'s shapes (added where the file has none)."""
    want = model.state_dict()
    return dict(state_dict) | {k: torch.zeros_like(want[k], device="cpu")
                               for k in BOTTLENECK_TIME_MLP if k in want}


def check_against_model(state_dict: Dict[str, torch.Tensor], model: torch.nn.Module) -> None:
    """Raise one ``ValueError`` naming what keeps ``state_dict`` from loading
    strictly into ``model``: missing keys, extra keys, shape mismatches."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    got = {k: tuple(v.shape) for k, v in state_dict.items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = {k: (got[k], want[k]) for k in sorted(set(want) & set(got)) if got[k] != want[k]}
    if missing or extra or bad:
        raise ValueError(
            f"checkpoint != the config's model: missing={missing[:6]} ({len(missing)}) "
            f"extra={extra[:6]} ({len(extra)}) shape mismatches (checkpoint vs model)="
            f"{dict(list(bad.items())[:6])} ({len(bad)})"
        )
