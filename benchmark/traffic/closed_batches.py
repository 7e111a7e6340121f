"""Closed batches: one caller that hands the program its next batch when the
last one is done (a training loop, an offline sampling job).

Every input comes from ``--seed`` alone, each stream salted apart:

* ``dataset``: the train split, uniform uint8 images and uniform labels.
* ``epoch_order``: each epoch's shuffle of the split, cut into full batches.
* ``train_draws``: a training step's t ~ U[0, T), eps ~ N(0, I) and the
  batch-wide label drop (p from the configuration), one stream for the run.
* ``batch``: sampler batch ``j``'s classes (0..K-1 cycled from an offset
  drawn from the seed), x_T and each step's noise, from a stream of the
  batch's own, so the reference can draw batch ``j`` again by itself.

Parameters (the cell's ``params``): ``batch``, and whatever its entry reads.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from benchmark.weights import generator, stream_seed

DATA, ORDER, DRAWS, BATCH = 11, 12, 13, 14


class Traffic:
    def __init__(self, params: dict, seed: int, device, num_classes: int):
        self.params = params
        self.batch_size = int(params["batch"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.num_classes = int(num_classes)
        self._draws = None

    def dataset(self, n: int, shape) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(stream_seed(self.seed, DATA))
        images = rng.integers(0, 256, size=(n, *shape), dtype=np.uint8)
        labels = rng.integers(0, self.num_classes, size=(n,)).astype(np.int64)
        return images, labels

    def epoch_order(self, epoch: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(stream_seed(self.seed, ORDER, epoch))
        b = self.batch_size
        return rng.permutation(n)[: n // b * b].reshape(n // b, b)

    def train_draws(self, n_steps: int, shape, drop_prob: float):
        if self._draws is None:
            self._draws = generator(self.device, self.seed, DRAWS)
        g, b, dev = self._draws, self.batch_size, self.device
        t = torch.randint(0, n_steps, (b,), generator=g, device=dev)
        eps = torch.randn((b, *shape), generator=g, device=dev)
        drop = torch.rand((), generator=g, device=dev) < drop_prob
        return t, eps, drop

    def classes(self, j: int) -> torch.Tensor:
        off = int(np.random.default_rng(stream_seed(self.seed, BATCH, j)).integers(
            self.num_classes))
        return (torch.arange(self.batch_size, device=self.device) + off) % self.num_classes

    def batch(self, j: int, shape) -> Tuple[torch.Tensor, torch.Tensor,
                                            Callable[[int], torch.Tensor]]:
        """(classes, x_T, noise): ``noise(t)`` is the next step's draw (the
        same buffer, refilled)."""
        g = generator(self.device, self.seed, BATCH, j)
        full = (self.batch_size, *shape)
        x_t = torch.randn(full, generator=g, device=self.device)
        buf = torch.empty(full, device=self.device)

        def noise(_t: int) -> torch.Tensor:
            return buf.normal_(generator=g)

        return self.classes(j), x_t, noise
