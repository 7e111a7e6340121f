"""VAE autoencoder trainer (port of ldm_tpu/training/autoencoder_trainer.py).

The loss is the ELBO, summed over the batch as the reference sums it:
reconstruction plus the KL divergence.  ``loss_fn: elbo`` is sigmoid-BCE on
the decoder's output taken as logits against the [0, 1] image; ``elbo_mse``
the squared error on [-1, 1] images (the latent pipeline's first stage).
The sums run in fp32 (the decoder's output and the moments are fp32): at
B=64 and 32x32x3 the summed error is about 1e5, where bf16 would lose its
low digits.  The logged losses are per sample.

A step draws the latent's noise eagerly (a generator seeded from (seed,
step)) into a fixed buffer; the forward, loss, backward and Adam run
eagerly or as one CUDA graph captured once and replayed
(``utils/graphs.py::GraphedStep``), the epoch device-resident where the
loader allows it (``training/scan_epochs.py``), as in the diffusion
trainer.  The JAX state's EMA is updated there and never read; this one
keeps none.  Validation draws from a stream salted 0xAE by batch index;
early stopping keeps the best weights on the device and writes them to
``<checkpoints>/autoencoder.pt`` at the ``checkpoint_every`` cadence and at
the end (the full state, ``autoencoder_state.pt``, at the end alone); a
reconstruction grid is logged every 5 epochs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.models.autoencoder import latent_shape_of
from ldm_tpu_torch.training import checkpoint as ckpt
from ldm_tpu_torch.training.early_stopping import EarlyStopping
from ldm_tpu_torch.training.scan_epochs import EpochScan, build_epoch_scan
from ldm_tpu_torch.training.state import TrainState, step_generator
from ldm_tpu_torch.utils.graphs import GraphedStep, use_graphs
from ldm_tpu_torch.utils.logging import MetricsLogger
from ldm_tpu_torch.utils.seed import check_finite

EVAL_SALT = 0xAE       # the JAX trainer's salts: validation batches and the
RECON_SALT = 0x7EC     # reconstruction grid


def kl_divergence(mu: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    """-0.5 * sum(1 + log(sigma^2) - mu^2 - sigma^2), in fp32."""
    mu, log_var = mu.to(torch.float32), log_var.to(torch.float32)
    return -0.5 * torch.sum(1.0 + log_var - mu ** 2 - torch.exp(log_var))


def elbo_bce(logits: torch.Tensor, target01: torch.Tensor, mu: torch.Tensor,
             log_var: torch.Tensor) -> torch.Tensor:
    """Sum-reduced sigmoid-BCE on [0, 1] targets plus the KLD."""
    bce = F.binary_cross_entropy_with_logits(logits.to(torch.float32),
                                             target01.to(torch.float32), reduction="sum")
    return bce + kl_divergence(mu, log_var)


def elbo_mse(recon: torch.Tensor, target: torch.Tensor, mu: torch.Tensor,
             log_var: torch.Tensor) -> torch.Tensor:
    """Sum-reduced squared error plus the KLD."""
    d = recon.to(torch.float32) - target.to(torch.float32)
    return torch.sum(d * d) + kl_divergence(mu, log_var)


class AutoencoderTrainer:
    def __init__(self, config: Config, model, train_loader, val_loader, device=None,
                 logger: Optional[MetricsLogger] = None, graphs: Optional[bool] = None):
        """``model``: a ``models.autoencoder.Autoencoder`` on ``device``;
        ``graphs`` as for the diffusion trainer."""
        if config.loss_fn not in ("elbo", "elbo_mse"):
            raise ValueError(f"the autoencoder trains with elbo or elbo_mse, got "
                             f"{config.loss_fn!r}")
        self.config = config
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.logger = logger or MetricsLogger(config.dirpath)
        config.create_dirs()
        self.latent_shape = latent_shape_of(model, config.data.image_size)
        self.state = TrainState(model, config.lr, ema=False)
        self._steps = GraphedStep(self._device_step, self.state, self.device,
                                  use_graphs(self.device, graphs))
        self.epoch_scan = build_epoch_scan(train_loader, self.device, enabled=config.scan_epochs)
        self.early_stopping = EarlyStopping(
            patience=config.early_stopping_patience, verbose=True, save_fn=self._save_best,
            min_delta_rel=config.early_stopping_min_delta_rel)
        self._best: Optional[dict] = None
        self._best_dirty = False

    @property
    def model(self):
        return self.state.model

    @property
    def step_counts(self) -> Dict[str, int]:
        return self._steps.counts

    @property
    def graphs(self) -> bool:
        return self._steps.enabled

    @graphs.setter
    def graphs(self, value: bool) -> None:
        self._steps.enabled = bool(value)

    # ------------------------------------------------------------ the step
    def loss(self, image: torch.Tensor, eps: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(the summed ELBO, {"loss", "kld"} per sample) of a [-1, 1] batch,
        the latent drawn with ``eps``."""
        recon, mu, log_var = self.model(image, eps)
        if self.config.loss_fn == "elbo":
            loss = elbo_bce(recon, (image + 1.0) / 2.0, mu, log_var)
        else:
            loss = elbo_mse(recon, image, mu, log_var)
        b = image.shape[0]
        return loss, {"loss": loss.detach() / b, "kld": kl_divergence(mu, log_var).detach() / b}

    def _batch(self, batch: dict):
        image = torch.as_tensor(batch["image"]).to(self.device, torch.float32)
        label = torch.as_tensor(np.asarray(batch["label"])).to(self.device, torch.int64)
        return image, label

    def _eps(self, b: int, generator: torch.Generator) -> torch.Tensor:
        return torch.randn((b,) + self.latent_shape, generator=generator, device=self.device)

    def train_step(self, batch: dict, eps: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on ``{"image": NHWC [-1, 1], "label"}``; ``eps`` (the
        latent's noise) can be given.  Returns ``{"loss", "kld"}`` per
        sample, device scalars."""
        x, y = self._batch(batch)
        return self._step(x, y, eps)

    def scan_step(self, scan: EpochScan, eps: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` on the next row of ``scan``'s epoch."""
        scan.take()
        return self._step(scan.x_like, scan.y_like, eps, scan)

    def _step(self, x, y, eps, scan: Optional[EpochScan] = None):
        if eps is None:
            eps = self._eps(x.shape[0], step_generator(self.config.seed, self.state.step,
                                                       self.device))
        return self._steps((x, y, eps.to(self.device, torch.float32)), scan)

    def _device_step(self, x, _y, eps) -> Dict[str, torch.Tensor]:
        state = self.state
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss(x, eps)
        loss.backward()
        state.update()
        return metrics

    @torch.no_grad()
    def eval_step(self, batch: dict, index: int, eps: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        """The per-sample losses of one validation batch; the noise from the
        batch index's stream unless given."""
        x, _ = self._batch(batch)
        if eps is None:
            eps = self._eps(x.shape[0], step_generator(self.config.seed, index, self.device,
                                                       EVAL_SALT))
        self.model.eval()
        return self.loss(x, eps.to(self.device, torch.float32))[1]

    # ----------------------------------------------------------- persistence
    def _save_best(self, _state) -> None:
        """Improvement hook: a copy of the weights on the device, written at
        the checkpoint cadence and at the end."""
        self._best = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self._best_dirty = True

    def _flush_best(self, full_state: bool = False) -> None:
        d = self.config.checkpoints
        if self._best_dirty:
            ckpt.atomic_save(self._best, f"{d}/autoencoder.pt")
            self._best_dirty = False
        if full_state:
            ckpt.save_state(f"{d}/autoencoder_state.pt", self.state.state_dict(),
                            self.early_stopping.val_loss_min)

    # ---------------------------------------------------------------- epochs
    def _epoch(self, train: bool) -> float:
        scan = self.epoch_scan
        if train and scan is not None:
            scan.start_epoch(self.config.seed, self.state.step // scan.n_batches)
            losses = [self.scan_step(scan)["loss"] for _ in range(scan.n_batches)]
        elif train:
            losses = [self.train_step(b)["loss"] for b in self.train_loader]
        else:
            losses = [self.eval_step(b, i)["loss"] for i, b in enumerate(self.val_loader)]
        if not losses:
            raise ValueError("loader yielded no batches")
        return torch.stack(losses).mean().item()  # the epoch's one host sync

    @torch.no_grad()
    def reconstruct(self, images) -> np.ndarray:
        """Reconstructions of [-1, 1] NHWC images, uint8 NHWC."""
        x = torch.as_tensor(np.asarray(images)).to(self.device, torch.float32)
        gen = step_generator(self.config.seed, 0, self.device, RECON_SALT)
        recon, _, _ = self.model.eval()(x, self._eps(x.shape[0], gen))
        if self.config.loss_fn == "elbo":
            out01 = torch.sigmoid(recon)
        else:
            out01 = ((recon + 1.0) / 2.0).clamp(0.0, 1.0)
        return (out01 * 255.0).to(torch.uint8).cpu().numpy()

    def train(self) -> dict:
        cfg = self.config
        self.logger.define_summaries({"autoencoder train_loss": "min",
                                      "autoencoder val_loss": "min"})
        history = {"train_loss": [], "val_loss": []}
        for epoch in range(cfg.epochs):
            tr = check_finite("autoencoder train_loss", self._epoch(train=True), cfg)
            va = self._epoch(train=False)
            history["train_loss"].append(tr)
            history["val_loss"].append(va)
            self.logger.log({"autoencoder train_loss": tr, "autoencoder val_loss": va,
                             "epoch": epoch}, step=epoch)
            if epoch % 5 == 0:
                batch = next(iter(self.val_loader))
                self.logger.log_images(self.reconstruct(batch["image"][:8]), step=epoch,
                                       mode="reconstruction", dirpath=cfg.results)
            self.early_stopping(va, self.state)
            ce = cfg.checkpoint_every
            if ce > 0 and (epoch + 1) % ce == 0:
                self._flush_best()
            if self.early_stopping.early_stop:
                print("Early stopping")
                break
        self._flush_best(full_state=True)
        print(f"autoencoder steps: {self.step_counts['graphed']} replayed as a CUDA graph, "
              f"{self.step_counts['eager']} eager")
        return history
