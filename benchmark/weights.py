"""Seeded weights, made on the device in one draw, and the seeds of every
stream the benchmark draws.

A weight of fan-in f is N(0, 1) / sqrt(f), a bias and a norm's shift
N(0, 0.1^2), a norm's scale 1 + N(0, 0.1^2), an embedding N(0, 1): one
``randn`` of every leaf's elements together, then one scale and one shift a
leaf, spread over its elements.  Both sides get these tensors: the program
through ``load_state_dict``, the reference as they are.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Dict, Tuple

import numpy as np
import torch


def stream_seed(seed: int, *salt: int) -> int:
    """A 63-bit seed for one stream of the run, from (seed, salt...)."""
    words = np.random.SeedSequence([int(seed), *map(int, salt)]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


def generator(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *salt))


def _scale_shift(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) == 1:
        is_norm = "norm" in name or name.endswith("to_out.1.weight") or \
            name.endswith("to_out.1.bias")
        return (0.1, 1.0) if is_norm and leaf == "weight" else (0.1, 0.0)
    if name.startswith("label_emb"):
        return 1.0, 0.0
    fan_in = int(np.prod(shape[1:]))
    if ".ups." in name and name.endswith(".2.weight"):
        fan_in = shape[0]  # a 2x2 stride-2 transposed conv: one tap of each input channel
    return 1.0 / math.sqrt(fan_in), 0.0


def make(shapes: "OrderedDict[str, Tuple[int, ...]]", seed: int, salt: int,
         device) -> Dict[str, torch.Tensor]:
    """Every leaf of ``shapes``, float32 on ``device``, from (seed, salt)."""
    sizes = [int(np.prod(s)) for s in shapes.values()]
    total = sum(sizes)
    flat = torch.randn(total, generator=generator(device, seed, salt), device=device)
    ss = torch.tensor([_scale_shift(k, s) for k, s in shapes.items()], device=device)
    counts = torch.tensor(sizes, device=device)
    flat = torch.addcmul(torch.repeat_interleave(ss[:, 1], counts), flat,
                         torch.repeat_interleave(ss[:, 0], counts))
    return OrderedDict((k, v.view(s)) for (k, s), v in zip(shapes.items(),
                                                          flat.split(sizes)))
