"""The port's checkpoints as reference torch checkpoints (the twin of
``ldm_tpu/utils/torch_export.py``).

The port's modules carry the reference's names and layouts, so a
reference-layout state_dict is the model's own: what an export does is
find it in the port's files and write it in the reference's form, CPU
tensors, floating point ones in fp32 (integer buffers such as BatchNorm's
``num_batches_tracked`` as they are).  The reference classes, the port's
(``load_state_dict(strict=True)``) and the JAX package's importers
(``ldm_tpu/utils/torch_import.py``) all read the result.

The port writes two kinds of files: weights-only state_dicts
(``diffusion_model{,_ema}.pt``, ``consistency_model{,_ema}.pt``,
``autoencoder.pt``, a classifier's ``<name>.pt``, and what
``python -m ldm_tpu_torch.import_torch_checkpoint`` writes) and full
training states (``state.pt``, ``best_state.pt``, ``autoencoder_state.pt``:
the model, the EMA model where there is one, Adam's state, the step).
Under FSDP rank 0 writes the full state gathered whole
(``parallel/fsdp.py::full_tree``), so it reads as any other.

Entry point for files: ``python -m ldm_tpu_torch.export_torch_checkpoint``.
"""

from __future__ import annotations

from typing import Dict

import torch

from ldm_tpu_torch.utils.torch_import import detect_kind


def model_state_dict(checkpoint: dict, ema: bool = False) -> Dict[str, torch.Tensor]:
    """The model's state_dict in a loaded checkpoint: a weights-only file is
    one; of a full training state, ``model`` (``ema``: the EMA model)."""
    if not isinstance(checkpoint.get("model"), dict):
        return checkpoint
    if not ema:
        return checkpoint["model"]
    if "ema" not in checkpoint:
        raise ValueError("--ema: this training state has no EMA model")
    return checkpoint["ema"]


def reference_state_dict(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """CPU copies, floating point tensors as fp32, the rest as they are."""
    return {k: (v.detach().to("cpu", torch.float32) if v.is_floating_point()
                else v.detach().cpu()).clone()
            for k, v in state_dict.items()}


def check_kind(state_dict: Dict[str, torch.Tensor], kind: str) -> str:
    """``kind`` (``auto``: the keys') after checking that the keys are those
    of that kind's reference module."""
    found = detect_kind(state_dict)
    if kind not in ("auto", found):
        raise ValueError(f"not a {kind} state_dict: its keys are a reference {found}'s")
    return found


def vae_blocks_per_level(state_dict: Dict[str, torch.Tensor]) -> int:
    """The encoder's res blocks a resolution level in an autoencoder state_dict."""
    return len({k.split(".")[4] for k in state_dict if k.startswith("encoder.down.0.block.")})
