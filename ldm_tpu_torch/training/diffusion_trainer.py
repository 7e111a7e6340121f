"""Diffusion model trainer (port of ldm_tpu/training/diffusion_trainer.py).

One training step (the JAX ``_step_body``): noise the batch (``noise_batch``),
drop labels for classifier-free guidance (the whole batch at once, or per
sample), the MSE of fp32 eps against the UNet's output, backward, Adam, EMA,
and the global L2 norm of the grads.  Under ``use_amp`` the UNet computes in
bf16 with fp32 parameters, as in the JAX package.  On a CUDA device every
linear-attention block of the step runs the Hopper forward kernel and, in the
backward, the Hopper backward kernel (``LinearAttentionBlockFn``).

Randomness is an input: ``train_step`` and ``eval_step`` take t, eps and the
drop mask, so a test can hand over the JAX draws.  What is not given is
drawn from a generator on the device seeded from (seed, step), the
counterpart of ``fold_in(key, step)``; eval batches and the sample grid have
streams of their own (salted as the JAX trainer salts them).

On a CUDA device the step runs as a CUDA graph captured once and replayed
(``utils/graphs.py``): what the JAX package's jitted, state-donated step is
to its trainer.  The draws stay eager and per step (a generator seeded from
(seed, step), so a resumed run continues the stream) and go into fixed
buffers with the batch; everything after them is replayed: the noising, the
label drop, forward, loss, backward (the attention blocks' backward kernels
included), the gradient norm, Adam, the EMA and the device's step counter.
The graphs are for the first batch shape the trainer meets: one for batches
the caller hands over (copied into its input buffers) and one for the
device-resident epoch (below); the first steps at that shape run eagerly
(they warm the capture up and are real steps), and a batch of another shape
(a last, short batch) runs the eager step.  ``graphs=False`` asks for the
eager step everywhere; on the CPU there is no other.

The epoch is device-resident where the JAX trainer's is a ``lax.scan``
(``training/scan_epochs.py``, ``config.scan_epochs``, the standard loader
with ``drop_last``): the dataset lies on the device as uint8 and each step
gathers its batch there, inside the replayed step.  Otherwise it is a Python
loop over the loader's batches.  Either way the per-step losses stay on the
device and are read once an epoch.  The
validation loss applies the CFG lerp; every ``sample_every`` epochs a sample
grid is drawn from the EMA weights through the ancestral CFG sampler;
early stopping keeps the best state, and full-state checkpoints are written
at the ``checkpoint_every`` cadence and at the end.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.training import checkpoint as ckpt
from ldm_tpu_torch.training.early_stopping import EarlyStopping
from ldm_tpu_torch.training.scan_epochs import EpochScan, build_epoch_scan
from ldm_tpu_torch.training.state import TrainState, step_generator
from ldm_tpu_torch.utils.graphs import WARMUP_STEPS, StepGraph, side_stream, use_graphs
from ldm_tpu_torch.utils.logging import MetricsLogger, Throughput, global_norm

EVAL_SALT = 0x5EED     # the JAX trainer's salts: eval batches and sample grids
SAMPLE_SALT = 0x5A7712
SAMPLERS = ("ddpm", "ddim", "dpmpp")


class DiffusionTrainer:
    def __init__(
        self,
        config: Config,
        model,  # ldm_tpu_torch.models.unet.UNet, on `device`
        diffusion: GaussianDiffusion,
        train_loader,
        val_loader,
        classes,
        device=None,
        logger: Optional[MetricsLogger] = None,
        cfg_scale: Optional[float] = None,
        graphs: Optional[bool] = None,
    ):
        """``graphs``: None runs the train step and the samplers as replayed
        CUDA graphs on a CUDA device and eagerly elsewhere; False asks for
        the eager paths; True on another device raises."""
        if config.loss_fn != "mse":
            raise ValueError("diffusion training uses MSE")
        self.config = config
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self.diffusion = diffusion
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.classes = np.asarray(classes, np.int64)
        self.cfg_scale = config.diffusion.cfg_scale if cfg_scale is None else cfg_scale
        self.logger = logger or MetricsLogger(config.dirpath)
        config.create_dirs()
        d = config.data
        self.image_shape = (d.image_size, d.image_size, d.image_channels)
        self.state = TrainState(model, config.lr, config.ema_decay)
        self.early_stopping = EarlyStopping(
            patience=config.early_stopping_patience, verbose=True,
            save_fn=self._save_best, min_delta_rel=config.early_stopping_min_delta_rel,
        )
        self._best: Optional[dict] = None
        self.graphs = use_graphs(self.device, graphs)
        # the captured steps by batch source: None (the caller's batches) or
        # the EpochScan whose batches the step gathers itself
        self._graphs: Dict[Optional[EpochScan], _TrainGraph] = {}
        self._graph_shape: Optional[tuple] = None  # the batch shape the graphs are for
        self._warm_steps = 0                       # eager steps taken at that shape
        self.step_counts = {"graphed": 0, "eager": 0}
        self._warmed_up = False
        self._last_rates: Dict[str, float] = {}
        self._last_grad_norm = 0.0
        self.epoch_scan = build_epoch_scan(train_loader, self.device,
                                           enabled=config.scan_epochs)

    @property
    def model(self):
        return self.state.model

    @property
    def train_graph(self) -> Optional["_TrainGraph"]:
        """The captured train step on the caller's batches, once there is one."""
        return self._graphs.get(None)

    @property
    def scan_graph(self) -> Optional["_TrainGraph"]:
        """The captured train step of the device-resident epoch, once there is one."""
        return self._graphs.get(self.epoch_scan) if self.epoch_scan is not None else None

    # ------------------------------------------------------------ the step
    def dropped_labels(self, y: torch.Tensor, drop: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """CFG label drop to the null label: one Bernoulli(p) for the whole
        batch (``label_drop_mode: batch``, the reference's) or one per sample
        (``sample``).  ``drop`` (bool, () or (B,)) overrides the draw."""
        return torch.where(self.draw_drop(y, drop, generator), self.model.null_label, y)

    def draw_drop(self, y: torch.Tensor, drop: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """The drop mask of :meth:`dropped_labels` on y's device: ``drop``
        if given, else drawn from ``generator``."""
        dc = self.config.diffusion
        if drop is None:
            shape = tuple(y.shape) if dc.label_drop_mode == "sample" else ()
            drop = torch.rand(shape, generator=generator, device=y.device) < dc.label_drop_prob
        return drop.to(y.device)

    def _batch(self, batch: dict) -> Tuple[torch.Tensor, torch.Tensor]:
        image = torch.as_tensor(batch["image"]).to(self.device, torch.float32)
        label = torch.as_tensor(batch["label"]).to(self.device, torch.int64)
        return image, label

    def train_step(self, batch: dict, t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step on ``{"image": NHWC [-1, 1], "label": int}``.

        Returns ``{"loss", "grad_norm"}`` as device scalars (no host sync).
        The parameters' ``.grad`` keep this step's gradients afterwards.

        The draws (t, eps, the drop mask; whatever is not given) are made
        eagerly from the step's generator.  The rest runs eagerly, or with
        ``graphs`` as one replayed CUDA graph: for the first batch shape met,
        after ``WARMUP_STEPS`` eager steps at that shape; a batch of another
        shape runs the eager step.  ``step_counts`` counts both kinds.
        """
        x0, y = self._batch(batch)  # encode is the identity for pixel DDPM
        return self._step(x0, y, t, eps, drop)

    def scan_step(self, scan: EpochScan, t: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None,
                  drop: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` on the next row of ``scan``'s epoch: the batch
        is gathered on the device, inside the replayed step where there is
        one; the draws are the same as for the same batch handed over."""
        scan.take()
        return self._step(scan.x_like, scan.y_like, t, eps, drop, scan)

    def _step(self, x0, y, t, eps, drop, scan: Optional[EpochScan] = None):
        """The draws from (x0, y)'s shapes, then the step on (x0, y) or on
        ``scan``'s next batch."""
        state = self.state
        gen = None
        if t is None or eps is None or drop is None:
            gen = step_generator(self.config.seed, state.step, self.device)
        t, eps = self.diffusion.draw_t_eps(x0, t, eps, gen)
        drop = self.draw_drop(y, drop, gen)

        if self.graphs:
            if self._graph_shape is None:
                self._graph_shape = tuple(x0.shape)
            if tuple(x0.shape) == self._graph_shape:
                if self._warm_steps >= WARMUP_STEPS:
                    graph = self._graphs.get(scan)
                    if graph is None:
                        graph = self._graphs[scan] = _TrainGraph(self, x0, y, t, eps, scan)
                    self.step_counts["graphed"] += 1
                    return graph.step(x0, y, t, eps, drop)
                self._warm_steps += 1
                self.step_counts["eager"] += 1
                with side_stream(self.device):  # where warm-up for a capture runs
                    out = self._device_step(*_source(x0, y, scan), t, eps, drop)
                state.count_step()
                return out
        self.step_counts["eager"] += 1
        out = self._device_step(*_source(x0, y, scan), t, eps, drop)
        state.count_step()
        return out

    def _device_step(self, x0, y, t, eps, drop) -> Dict[str, torch.Tensor]:
        """Everything of a step after the draws, as a function of device
        tensors alone: the noising, the label drop, forward, loss, backward,
        the gradient norm, Adam and the EMA."""
        state = self.state
        xt = self.diffusion.q_sample(x0, t, eps)
        y = torch.where(drop, state.model.null_label, y)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        eps_theta = state.model(xt, t, y)
        loss = torch.mean((eps.to(torch.float32) - eps_theta) ** 2)
        loss.backward()
        gnorm = global_norm([p.grad for p in state.params()])
        state.update()
        return {"loss": loss.detach(), "grad_norm": gnorm}

    @torch.no_grad()
    def eval_step(self, batch: dict, index: int, t: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Validation loss of one batch (the current weights), with the CFG
        lerp ``uncond + cfg * (cond - uncond)`` when cfg > 0."""
        x0, y = self._batch(batch)
        gen = None
        if t is None or eps is None:
            gen = step_generator(self.config.seed, index, self.device, EVAL_SALT)
        eps, xt, t = self.diffusion.noise_batch(x0, t=t, eps=eps, generator=gen)
        model = self.model.eval()
        eps_theta = model(xt, t, y)
        if self.cfg_scale > 0:
            eps_uncond = model(xt, t, torch.full_like(y, model.null_label))
            eps_theta = eps_uncond + self.cfg_scale * (eps_theta - eps_uncond)
        return torch.mean((eps.to(torch.float32) - eps_theta) ** 2)

    # ------------------------------------------------------------ persistence
    def _save_best(self, _state) -> None:
        """Improvement hook: keep the best state as a copy on the device;
        it is written at the checkpoint cadence and at the end of train()."""
        self._best = _clone(self.state.state_dict())

    def _flush_best(self) -> None:
        if self._best is None:
            return
        d = self.config.checkpoints
        ckpt.atomic_save(self._best["model"], f"{d}/diffusion_model.pt")
        ckpt.atomic_save(self._best["ema"], f"{d}/diffusion_model_ema.pt")
        ckpt.save_state(f"{d}/best_state.pt", self._best, self.early_stopping.val_loss_min)
        self._best = None

    def save_latest(self) -> str:
        return ckpt.save_state(f"{self.config.checkpoints}/state.pt",
                               self.state.state_dict(), self.early_stopping.val_loss_min)

    def load_state(self, path: str) -> None:
        sd = ckpt.load_state(path, map_location=self.device)
        self.state.load_state_dict(sd)
        # a captured step holds the addresses of the optimizer's old state
        self._graphs.clear()
        self._warm_steps = 0
        self.early_stopping.restore(sd.get("best_val_loss", float("inf")))

    def resume_latest(self) -> bool:
        path = ckpt.latest_checkpoint(self.config.checkpoints)
        if path is None:
            return False
        self.load_state(path)
        return True

    # ----------------------------------------------------------------- epochs
    def _train_epoch(self) -> float:
        tput = Throughput()
        losses, gnorms = [], []

        def record(m: Dict[str, torch.Tensor], n: int) -> None:
            losses.append(m["loss"])
            gnorms.append(m["grad_norm"])
            tput.update(n)

        scan = self.epoch_scan
        if scan is not None:
            # the epoch index from the step, as the JAX trainer derives it:
            # a resumed run continues the shuffle stream
            scan.start_epoch(self.config.seed, self.state.step // scan.n_batches)
            for _ in range(scan.n_batches):
                record(self.scan_step(scan), scan.batch_size)
        else:
            for batch in self.train_loader:
                record(self.train_step(batch), len(batch["label"]))
        if not losses:
            raise ValueError("train loader yielded no batches")
        loss = torch.stack(losses).mean().item()  # the epoch's one host sync
        self._last_grad_norm = torch.stack(gnorms).mean().item()
        # the first epoch of the process pays for builds and warm-up: no rate
        self._last_rates = tput.rates() if self._warmed_up else {}
        self._warmed_up = True
        return loss

    def _val_epoch(self) -> float:
        losses = [self.eval_step(batch, i) for i, batch in enumerate(self.val_loader)]
        if not losses:
            raise ValueError("validation loader yielded no batches")
        return torch.stack(losses).mean().item()

    def train(self) -> dict:
        """Epoch loop: train, validate, log, sample grid, early stopping,
        checkpoints (the JAX trainer's ``train``)."""
        cfg = self.config
        self.logger.define_summaries({
            "diffusion_model train_loss": "min",
            "diffusion_model val_loss": "min",
        })
        history = {"train_loss": [], "val_loss": []}
        for epoch in range(cfg.epochs):
            train_loss = self._train_epoch()
            val_loss = self._val_epoch()
            history["train_loss"].append(train_loss)
            history["val_loss"].append(val_loss)
            self.logger.log({
                "diffusion_model train_loss": train_loss,
                "diffusion_model val_loss": val_loss,
                "grad_global_norm": self._last_grad_norm,
                "epoch": epoch,
                **{k: round(v, 3) for k, v in self._last_rates.items()},
            }, step=epoch)
            self.logger.log_norms("params", self.state.params(), step=epoch)
            we = cfg.watch_histograms_every
            if we > 0 and (epoch + 1) % we == 0:
                self.logger.log_histograms("params", self.model.named_parameters(), step=epoch)
            se = cfg.sample_every
            # 0 = never; epoch 0 is skipped: its grid would show untrained noise
            if se > 0 and epoch > 0 and epoch % se == 0:
                images = self.sample(self.classes, cfg_scale=self.cfg_scale)
                self.logger.log_images(images, step=epoch, mode="sample", dirpath=cfg.results)
            self.early_stopping(val_loss, self.state)
            ce = cfg.checkpoint_every
            if ce > 0 and (epoch + 1) % ce == 0:
                self.save_latest()
                self._flush_best()
            if self.early_stopping.early_stop:
                print("Early stopping")
                break
        # leave both the best and the latest state on disk whatever the cadence
        self.save_latest()
        self._flush_best()
        self.logger.log({"train_steps_graphed": self.step_counts["graphed"],
                         "train_steps_eager": self.step_counts["eager"]}, step=cfg.epochs)
        print(f"train steps: {self.step_counts['graphed']} replayed as a CUDA graph, "
              f"{self.step_counts['eager']} eager")
        return history

    # ----------------------------------------------------------------- sample
    def sample(self, classes, cfg_scale: float = 0.0, use_ema: bool = True,
               generator: Optional[torch.Generator] = None, method: str = "ddpm",
               ddim_steps: int = 50, eta: float = 0.0) -> np.ndarray:
        """One image per entry of ``classes``, from the EMA weights by
        default; uint8 NHWC.  ``method``: "ddpm" (the ancestral CFG sampler),
        "ddim" (``ddim_steps`` steps, ``eta``) or "dpmpp" (DPM-Solver++(2M),
        ``ddim_steps`` steps)."""
        model = (self.state.ema if use_ema else self.model).eval()
        if generator is None:
            generator = step_generator(self.config.seed, 0, self.device, SAMPLE_SALT)
        classes = torch.as_tensor(np.asarray(classes), dtype=torch.int64, device=self.device)
        x0 = run_sampler(self.diffusion, method, model, classes, self.image_shape,
                         ddim_steps=ddim_steps, eta=eta, cfg_scale=cfg_scale,
                         null_label=model.null_label, generator=generator,
                         graph=None if self.graphs else False)
        return reverse_transform(x0.cpu().numpy())


def run_sampler(diffusion: GaussianDiffusion, method: str, model, classes, image_shape,
                ddim_steps: int = 50, eta: float = 0.0, **kw) -> torch.Tensor:
    """``diffusion``'s sampler ``method`` ("ddpm", "ddim", "dpmpp"; the
    ``--sampler`` of the entry points); ``kw`` go to it."""
    if method == "ddpm":
        return diffusion.sample(model, classes, image_shape, **kw)
    if method == "ddim":
        return diffusion.sample_ddim(model, classes, image_shape, n_sample_steps=ddim_steps,
                                     eta=eta, **kw)
    if method == "dpmpp":
        return diffusion.sample_dpmpp(model, classes, image_shape, n_sample_steps=ddim_steps,
                                      **kw)
    raise ValueError(f"sampler must be one of {SAMPLERS}, got {method!r}")


def _source(x0, y, scan: Optional[EpochScan]):
    """The step's batch: (x0, y) as given, or ``scan``'s next, gathered on the device."""
    return scan.next_batch() if scan is not None else (x0, y)


class _TrainGraph:
    """The train step after the draws as one CUDA graph, with its fixed input
    buffers (image, label, t, eps, the drop mask) and its outputs.  With a
    ``scan`` the graph gathers its batch from the device-resident epoch
    instead (the scan's row counter advances at every replay) and has no
    image or label buffers.

    Captured after the trainer's eager warm-up steps.  Just before the
    capture both models' cached kernel weight copies are dropped, so the
    attention blocks make them inside the captured region and every replay
    makes them again from the weights Adam has moved; inside, the grads are
    set to None once, so the backward allocates them from the graph's pool
    and every replay writes them in place."""

    def __init__(self, trainer: DiffusionTrainer, x0, y, t, eps,
                 scan: Optional[EpochScan] = None):
        self.trainer = trainer
        self.scan = scan
        state = trainer.state
        self.x0, self.y, self.t, self.eps = (v.clone() for v in (x0, y, t, eps))
        self.drop = torch.zeros(y.shape, dtype=torch.bool, device=y.device)

        def drop_copies():
            for m in (state.model, state.ema):
                m.drop_kernel_weights()

        self.graph = StepGraph(
            lambda: trainer._device_step(*_source(self.x0, self.y, scan), self.t, self.eps,
                                         self.drop),
            trainer.device, warmup=0, before_capture=drop_copies)
        drop_copies()  # the copies made under capture belong to the graph's pool
        self.grads: List[torch.Tensor] = [p.grad for p in state.params()]

    def device_ms(self, replays: int = 10) -> float:
        """The device's time for one replayed step, in ms: ``replays`` real
        steps on the batch and draws the buffers hold (a scan's graph on its
        epoch's first row: the counter is set back before each replay)."""
        ms = self.graph.device_ms(replays, before=None if self.scan is None else
                                  self.scan.row.zero_)
        for _ in range(replays):
            self.trainer.state.count_replayed_step()
        self.trainer.step_counts["graphed"] += replays
        return ms

    def step(self, x0, y, t, eps, drop) -> Dict[str, torch.Tensor]:
        """One replay on these draws and, without a scan, this batch."""
        inputs = [(self.t, t), (self.eps, eps), (self.drop, drop)]
        if self.scan is None:
            inputs += [(self.x0, x0), (self.y, y)]
        for buf, val in inputs:
            buf.copy_(val)  # a () drop mask broadcasts over the batch
        out = self.graph.replay()
        state = self.trainer.state
        state.count_replayed_step()
        params = state.params()
        if params[0].grad is not self.grads[0]:
            # an eager step or another graph put other tensors in .grad:
            # show this step's gradients again
            for p, g in zip(params, self.grads):
                p.grad = g
        # clones: the next replay overwrites the graph's outputs
        return {k: v.clone() for k, v in out.items()}


def _clone(sd):
    """A deep copy of a state_dict-like tree (tensors cloned on their device)."""
    if isinstance(sd, torch.Tensor):
        return sd.detach().clone()
    if isinstance(sd, dict):
        return {k: _clone(v) for k, v in sd.items()}
    if isinstance(sd, (list, tuple)):
        return type(sd)(_clone(v) for v in sd)
    return sd
