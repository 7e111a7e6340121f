"""Closed batches of prompts: one caller that hands a text-to-image program
its next batch when the last one is done (an offline rendering job over a
list of prompts).

Every input comes from ``--seed`` alone, each stream salted apart, drawn on
the device:

* ``null_context``: the empty prompt's (context_len, context_dim) context,
  one a run.
* ``batch``: batch ``j``'s contexts (B, context_len, context_dim) and x_T
  (B, h, w, c), from a stream of the batch's own, so the reference can
  draw batch ``j`` again by itself.

The contexts stand in for the text encoder's output: N(0, 1).

Parameters (the cell's ``params``): ``batch``, ``context_len``, and
whatever its entry reads.
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.weights import generator

NULL, BATCH = 31, 32


class Traffic:
    def __init__(self, params: dict, seed: int, device, context_dim: int):
        self.params = params
        self.batch_size = int(params["batch"])
        self.context_len = int(params["context_len"])
        self.context_dim = int(context_dim)
        self.seed = int(seed)
        self.device = torch.device(device)

    def null_context(self) -> torch.Tensor:
        g = generator(self.device, self.seed, NULL)
        return torch.randn((self.context_len, self.context_dim), generator=g,
                           device=self.device)

    def batch(self, j: int, shape) -> Tuple[torch.Tensor, torch.Tensor]:
        """(contexts, x_T) of batch ``j``."""
        g = generator(self.device, self.seed, BATCH, j)
        ctx = torch.randn((self.batch_size, self.context_len, self.context_dim), generator=g,
                          device=self.device)
        x_t = torch.randn((self.batch_size, *shape), generator=g, device=self.device)
        return ctx, x_t
