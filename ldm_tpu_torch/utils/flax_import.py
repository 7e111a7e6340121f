"""The weight bridge: a flax UNet parameter tree -> the port's state_dict.

The port's UNet names its submodules in the reference layout that
``ldm_tpu.utils.torch_export.unet_state_dict_from_params`` already emits, so
the bridge is that function plus ``torch.from_numpy``, and
``load_state_dict(strict=True)`` proves the key sets equal.  The export
takes care of the layout details: OIHW conv weights, the spatial flip of the
transposed convs, the zero time MLP of a ``bottleneck_time_emb=False``
bottleneck, and no time MLP on the final head block.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ldm_tpu.utils.torch_export import unet_state_dict_from_params


def unet_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax UNet tree (``{"params": ...}`` or bare; numpy or array-like
    leaves) -> state_dict of float32 CPU tensors for the port's UNet."""
    sd = unet_state_dict_from_params(params)
    # np.array copies: arrays handed over from other frameworks may be read-only
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}
