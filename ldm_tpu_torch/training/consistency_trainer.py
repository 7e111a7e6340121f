"""Consistency-distillation trainer: teacher DDPM -> 1-4-step student (port
of ldm_tpu/training/consistency_trainer.py).

A frozen teacher (an eps-UNet, typically the EMA weights of a trained run)
is distilled into a student with guidance baked in.  A step (Song et al.
2023, alg. 2; the guidance as in LCM): per sample a boundary segment
``sub[n] -> sub[n+1]`` is drawn with eps; x_{t1} = q_sample(x0, t1, eps); the
teacher takes ONE guided DDIM step t1 -> t0 (eta 0, the CFG pass fused as
one 2B forward); the EMA student's consistency output at t0 is the target
(no gradient); the student's output at t1 is pulled to it by the
pseudo-Huber loss (``huber_c``; 0 is the MSE), in fp32; Adam and the EMA
update follow.  The student and its EMA start as copies of the teacher.

On a CUDA device the step runs as a CUDA graph captured once and replayed
(``utils/graphs.py::GraphedStep``), the epoch device-resident where the
loader allows it (``training/scan_epochs.py``), as in the diffusion
trainer.  The draws (n, eps) are eager, from a generator seeded from
(seed + 7, step), and can be given; everything after them is replayed: the
boundary table lies on the device, made once, and t0 / t1 are gathered from
it inside the graph.  Three weight sets pass through one architecture: the
teacher's kernel weight copies are made once and kept (its weights never
change); the student's and the EMA's are made inside the captured region,
so every replay makes them again from the weights the last step moved.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.diffusion.consistency import (
    boundary_timesteps,
    consistency_fn,
    sample_consistency,
    sampling_timesteps,
)
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.training import checkpoint as ckpt
from ldm_tpu_torch.training.scan_epochs import EpochScan, build_epoch_scan
from ldm_tpu_torch.training.state import TrainState, step_generator
from ldm_tpu_torch.utils.graphs import GraphedStep, use_graphs
from ldm_tpu_torch.utils.logging import MetricsLogger, global_norm

STATE_SEED_OFFSET = 7  # the JAX trainer's state key is key(seed + 7)
SAMPLE_SEED_OFFSET = 11  # and its sample grid's key(seed + 11)


class ConsistencyDistillTrainer:
    """Distill ``teacher`` (an eps-UNet on ``device``) into a student.

    Args:
      config: the teacher's config (schedule, model, data, seed).
      teacher: the frozen teacher; the student and its EMA are copies.
      diffusion: the teacher's ``GaussianDiffusion``.
      train_loader: real data; images and labels are used.
      skip_steps: boundary spacing k: segments (t, t + k) along the ODE.
      cfg_scale: the guidance strength distilled in (default: the config's).
      ema_decay: the target network's EMA decay.
      huber_c: pseudo-Huber constant (iCT); 0 is the MSE.
      lr: the distillation learning rate (default: the config's).
      graphs: None: the replayed step on a CUDA device, eager elsewhere;
        False: the eager step.
    """

    def __init__(self, config: Config, teacher, diffusion: GaussianDiffusion, train_loader,
                 classes, device=None, logger: Optional[MetricsLogger] = None, *,
                 skip_steps: int = 20, cfg_scale: Optional[float] = None,
                 ema_decay: float = 0.95, huber_c: float = 0.03, lr: Optional[float] = None,
                 graphs: Optional[bool] = None):
        self.config = config
        self.device = torch.device(device) if device is not None else next(
            teacher.parameters()).device
        self.diffusion = diffusion
        self.train_loader = train_loader
        self.classes = np.asarray(classes, np.int64)
        self.logger = logger or MetricsLogger(config.dirpath)
        config.create_dirs()
        self.cfg_scale = config.diffusion.cfg_scale if cfg_scale is None else float(cfg_scale)
        self.huber_c = float(huber_c)
        d = config.data
        self.image_shape = (d.image_size, d.image_size, d.image_channels)
        self.sub = boundary_timesteps(diffusion.n_steps, skip_steps)
        self.sub_t = torch.from_numpy(self.sub.astype(np.int64)).to(self.device)

        self.teacher = teacher.requires_grad_(False).eval()
        student = copy.deepcopy(teacher).requires_grad_(True)
        student.drop_kernel_weights()  # the copy's cache holds the teacher's copies
        self.state = TrainState(student, config.lr if lr is None else lr, ema_decay)
        self.state.ema.drop_kernel_weights()

        def drop_copies():
            # the student's and the EMA's kernel weight copies are made inside
            # the captured region; the teacher's stay (its weights never move)
            for m in (self.state.model, self.state.ema):
                m.drop_kernel_weights()

        self._steps = GraphedStep(self._device_step, self.state, self.device,
                                  use_graphs(self.device, graphs), before_capture=drop_copies)
        self.epoch_scan = build_epoch_scan(train_loader, self.device, enabled=config.scan_epochs)

    @property
    def model(self):
        """The student."""
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
    def _batch(self, batch: dict):
        image = torch.as_tensor(batch["image"]).to(self.device, torch.float32)
        label = torch.as_tensor(batch["label"]).to(self.device, torch.int64)
        return image, label

    def train_step(self, batch: dict, n: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One distillation step on ``{"image", "label"}``; ``n`` (int (B,),
        the segment index in [0, len(sub) - 1)) and ``eps`` can be given.
        Returns ``{"loss", "grad_norm"}`` as device scalars."""
        x0, y = self._batch(batch)
        return self._step(x0, y, n, eps)

    def scan_step(self, scan: EpochScan, n: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` on the next row of ``scan``'s epoch."""
        scan.take()
        return self._step(scan.x_like, scan.y_like, n, eps, scan)

    def _step(self, x0, y, n, eps, scan: Optional[EpochScan] = None):
        gen = None
        if n is None or eps is None:
            gen = step_generator(self.config.seed + STATE_SEED_OFFSET, self.state.step,
                                 self.device)
        if n is None:
            n = torch.randint(0, len(self.sub) - 1, (x0.shape[0],), generator=gen,
                              device=self.device)
        if eps is None:
            eps = torch.randn(x0.shape, generator=gen, device=self.device)
        n = n.to(self.device, torch.int64)
        eps = eps.to(self.device, torch.float32)
        return self._steps((x0, y, n, eps), scan)

    def _device_step(self, x0, y, n, eps) -> Dict[str, torch.Tensor]:
        """The step after the draws, on device tensors alone."""
        state, diffusion = self.state, self.diffusion
        t0 = self.sub_t.index_select(0, n)
        t1 = self.sub_t.index_select(0, n + 1)
        x_t1 = diffusion.q_sample(x0, t1, eps)
        with torch.no_grad():
            # the teacher's guided DDIM step t1 -> t0, then the EMA target
            y_in = torch.cat([y, torch.full_like(y, self.teacher.null_label)])
            teach_eps = diffusion._cfg_eps(self.teacher, x_t1, t1, y_in, self.cfg_scale, True)
            x_t0 = diffusion.ddim_step(x_t1, t1, t0, teach_eps, None, eta=0.0)
            target = consistency_fn(diffusion, state.ema, x_t0, t0, y)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        pred = consistency_fn(diffusion, state.model, x_t1, t1, y)
        d2 = (pred - target) ** 2
        c = self.huber_c
        loss = torch.mean(torch.sqrt(d2 + c * c) - c) if c > 0 else torch.mean(d2)
        loss.backward()
        gnorm = global_norm([p.grad for p in state.params()])
        state.update()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    # ----------------------------------------------------------------- train
    def train(self, epochs: Optional[int] = None) -> dict:
        """``epochs`` (default: the config's) epochs; the weights are saved
        at the end.  Returns ``{"loss": the last epoch's, "history"}``."""
        epochs = self.config.epochs if epochs is None else epochs
        history = []
        for epoch in range(epochs):
            t0 = time.monotonic()
            losses = []
            scan = self.epoch_scan
            if scan is not None:
                scan.start_epoch(self.config.seed, self.state.step // scan.n_batches)
                for _ in range(scan.n_batches):
                    losses.append(self.scan_step(scan)["loss"])
            else:
                for batch in self.train_loader:
                    losses.append(self.train_step(batch)["loss"])
            if not losses:
                raise ValueError("train loader yielded no batches")
            loss = torch.stack(losses).mean().item()  # the epoch's one host sync
            dt = time.monotonic() - t0
            history.append(loss)
            self.logger.log({"epoch": epoch, "distill_loss": loss,
                             "steps_per_sec": len(losses) / dt if dt > 0 else 0.0},
                            step=self.state.step)
        self.save()
        print(f"distill steps: {self.step_counts['graphed']} replayed as a CUDA graph, "
              f"{self.step_counts['eager']} eager")
        return {"loss": history[-1] if history else float("nan"), "history": history}

    def save(self) -> None:
        """``consistency_model.pt`` and ``consistency_model_ema.pt`` (state_dicts)."""
        base = self.config.checkpoints
        os.makedirs(base, exist_ok=True)
        ckpt.atomic_save(self.state.model.state_dict(),
                         os.path.join(base, "consistency_model.pt"))
        ckpt.atomic_save(self.state.ema.state_dict(),
                         os.path.join(base, "consistency_model_ema.pt"))

    # ---------------------------------------------------------------- sample
    def sample(self, classes, n_sample_steps: int = 2, use_ema: bool = True,
               generator: Optional[torch.Generator] = None, **kw) -> torch.Tensor:
        """Few-step consistency sampling from the (EMA) student: x0 fp32 on
        the device; ``kw`` go to ``sample_consistency`` (x_init, noise...).
        Without a generator the draws come from one seeded from (seed + 11)."""
        model = (self.state.ema if use_ema else self.state.model).eval()
        if generator is None:
            generator = step_generator(self.config.seed + SAMPLE_SEED_OFFSET, 0, self.device)
        ts = sampling_timesteps(self.diffusion.n_steps, n_sample_steps)
        classes = torch.as_tensor(np.asarray(classes), dtype=torch.int64, device=self.device)
        kw.setdefault("graph", None if self.graphs else False)
        return sample_consistency(self.diffusion, model, classes, self.image_shape, ts=ts,
                                  generator=generator, **kw)
