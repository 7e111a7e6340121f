"""Diffusion model trainer (port of ldm_tpu/training/diffusion_trainer.py).

One training step (the JAX ``_step_body``): noise the batch (``noise_batch``),
drop labels for classifier-free guidance (the whole batch at once, or per
sample), the MSE of the process's fp32 target against the UNet's output (eps
for ``GaussianDiffusion``; the velocity for ``RectifiedFlow``, whose t is an
fp32 draw in [0, 1]), backward, Adam, EMA, and the global L2 norm of the
grads.  Under ``use_amp`` the UNet computes in
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

Data parallelism (``mesh=``, a ``parallel.Mesh``; the JAX trainer's ``mesh``):
one process a device, each with its rows of every global batch.  A step is
the JAX step on the global batch: every process draws the global batch's
t, eps and drop mask from the same (seed, step) generator and keeps its own
rows (given draws are the global batch's too), so a run of P processes fed
the global batches equals one process fed the same batches; the gradients
and the loss are averaged over the processes before Adam
(``TrainState.reduce_grads``), and ``config.param_sharding`` picks plain DP
or FSDP.  ``train_step`` and ``eval_step`` take this process's rows.  The
device-resident epoch holds the whole set on every process and gathers its
rows of each global batch; the per-batch path reads this process's
``per_host_subset``; validation batches are the global loader's, each
process taking its rows, and the loss is the global batch's.  Checkpoints,
metrics and sample grids are written by the primary process alone; under
FSDP a checkpoint is the whole state, gathered, and the sample grid comes
from the EMA weights gathered into an unsharded copy of the model.  Over a
gloo group the step runs eagerly (``utils/graphs.py::use_graphs``); over
NCCL it is one graph, the all-reduce inside.

The mesh's model axis (``create_mesh(model=k)``, as the JAX trainer takes
it; no flag): under a model axis > 1 every attention block of the model and
the EMA takes the plain path (``LinAttnBlock(impl="torch")``, over the heads
the block holds; the JAX trainer's ``attention_impl="xla_heads"``), so the
step launches no attention kernel.  As under FSDP, the trainer changes the
model it is given in place (its attention path, under TP its attention
weights' shares): it trains that module, where the JAX trainer clones an
immutable one.  ``param_sharding`` ``"tp"`` / ``"fsdp_tp"`` splits the
heads over the axis (``parallel/tp.py``); ``activation_sharding:
spatial`` splits the image rows (``parallel/sp_explicit.py``): each
process takes its rows of its data row's images and of the eps draws, its
squared error is taken over the global element count, and the loss and the
gradients are summed over the model axis and averaged over the data axis.
Spatial parallelism needs replicated parameters and a height that splits
into even rows at every pooled level; the sampler then runs the same
explicit forward on each process's rows of x_T (and of each step's noise)
and gathers the rows.
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.data.transforms import reverse_transform
from ldm_tpu_torch.diffusion.consistency import sample_consistency, sampling_timesteps
from ldm_tpu_torch.diffusion.ddpm import GaussianDiffusion
from ldm_tpu_torch.diffusion.sampling import SamplingProcess
from ldm_tpu_torch.parallel import distributed, fsdp, tp
from ldm_tpu_torch.ops.collectives import gather_rows_model
from ldm_tpu_torch.parallel.mesh import Mesh, shard_batch
from ldm_tpu_torch.parallel.sp_explicit import SpatialUNet, supports_spatial_training
from ldm_tpu_torch.training import checkpoint as ckpt
from ldm_tpu_torch.training.early_stopping import EarlyStopping
from ldm_tpu_torch.training.scan_epochs import EpochScan, build_epoch_scan
from ldm_tpu_torch.training.state import TrainState, step_generator
from ldm_tpu_torch.utils.graphs import CapturedStep, GraphedStep, use_graphs
from ldm_tpu_torch.utils.logging import MetricsLogger, Throughput
from ldm_tpu_torch.utils.seed import check_finite

EVAL_SALT = 0x5EED     # the JAX trainer's salts: eval batches and sample grids
SAMPLE_SALT = 0x5A7712
SAMPLERS = ("ddpm", "ddim", "dpmpp")
CONSISTENCY = "consistency"  # a distilled student's sampler (run_sampler; not a trainer's)


class DiffusionTrainer:
    def __init__(
        self,
        config: Config,
        model,  # ldm_tpu_torch.models.unet.UNet, on `device`
        diffusion: SamplingProcess,  # GaussianDiffusion or RectifiedFlow
        train_loader,
        val_loader,
        classes,
        device=None,
        logger: Optional[MetricsLogger] = None,
        cfg_scale: Optional[float] = None,
        graphs: Optional[bool] = None,
        input_shape: Optional[Tuple[int, int, int]] = None,
        mesh: Optional[Mesh] = None,
    ):
        """``graphs``: None runs the train step and the samplers as replayed
        CUDA graphs on a CUDA device and eagerly elsewhere; False asks for
        the eager paths; True on another device raises.  ``input_shape``:
        (H, W, C) of the diffusion space where it is not the images' (the
        latent trainer's latents).  ``mesh``: data parallelism over its
        processes (the loaders are the global batches')."""
        if config.loss_fn != "mse":
            raise ValueError("diffusion training uses MSE")
        self.mesh = mesh
        if mesh is not None:
            fsdp.check_modes(config.param_sharding, config.activation_sharding)
            distributed.build_kernels_once(mesh.device, mesh.group)
        model_axis = mesh is not None and mesh.model_size > 1
        if model_axis:
            # no kernel splits over heads or rows: the JAX trainer's
            # clone(attention_impl="xla_heads") (ldm_tpu/parallel/tp.py NOTE)
            model.set_attention_impl("torch")
        self.config = config
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self.diffusion = diffusion
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.classes = np.asarray(classes, np.int64)
        self.cfg_scale = config.diffusion.cfg_scale if cfg_scale is None else cfg_scale
        self.logger = logger or MetricsLogger(config.dirpath, config.project_name)
        config.create_dirs()
        d = config.data
        self.image_shape = tuple(input_shape or (d.image_size, d.image_size, d.image_channels))
        self.spatial = model_axis and config.activation_sharding == "spatial"
        if self.spatial:
            if config.param_sharding != "replicated":
                raise ValueError("activation_sharding 'spatial' composes with param_sharding "
                                 f"'replicated' only, got {config.param_sharding!r}")
            levels = len(model.encoder.downs)
            if not supports_spatial_training(mesh, self.image_shape[0], levels):
                raise ValueError(
                    "activation_sharding 'spatial' needs the height to split into even rows "
                    f"at every pooled level: H={self.image_shape[0]} % ({mesh.model_size} * "
                    f"2^{levels}) != 0")
        # under FSDP: an unsharded twin of the model (under fsdp_tp with the
        # TP shares), the gathered weights' home for sampling
        self._unsharded = None
        if mesh is not None and config.param_sharding in ("fsdp", "fsdp_tp"):
            self._unsharded = copy.deepcopy(model).requires_grad_(False).eval()
            if config.param_sharding == "fsdp_tp":
                tp.shard_module(self._unsharded, mesh)
        self.state = TrainState(model, config.lr, config.ema_decay, mesh=mesh,
                                param_sharding=config.param_sharding, spatial=self.spatial)
        # the explicit spatial forwards of the model and the EMA
        self._sp = ({m: SpatialUNet(mesh, m) for m in (self.state.model, self.state.ema)}
                    if self.spatial else {})
        self.early_stopping = EarlyStopping(
            patience=config.early_stopping_patience, verbose=True,
            save_fn=self._save_best, min_delta_rel=config.early_stopping_min_delta_rel,
        )
        self._best: Optional[dict] = None

        def drop_copies():
            # the attention blocks make their kernel weight copies inside the
            # captured region, so every replay makes them again from the
            # weights Adam has moved
            for m in (self.state.model, self.state.ema):
                m.drop_kernel_weights()

        # the step after the draws, eager or replayed: one graph a batch
        # source (None: the caller's batches; or the EpochScan whose batches
        # the step gathers itself).  Over NCCL a step with a model axis > 1
        # is captured as any other (its collectives inside); that needs one
        # card a process, so no run on one card has replayed one
        self._steps = GraphedStep(self._device_step, self.state, self.device,
                                  use_graphs(self.device, graphs, mesh),
                                  before_capture=drop_copies)
        self._warmed_up = False
        self._last_rates: Dict[str, float] = {}
        self._last_grad_norm = 0.0
        self.epoch_scan = build_epoch_scan(train_loader, self.device,
                                           enabled=config.scan_epochs, mesh=mesh)
        # the per-batch path's batches: under a mesh this process's subset
        self._local_loader = None

    def _train_batches(self):
        """The per-batch path's loader: under a mesh a loader over this
        process's ``per_host_subset`` of the train loader's dataset."""
        if self.mesh is None:
            return self.train_loader
        if self._local_loader is None:
            self._local_loader = distributed.per_host_loader(self.train_loader, self.mesh)
        return self._local_loader

    @property
    def primary(self) -> bool:
        """Whether this process writes checkpoints, metrics and grids."""
        return self.mesh is None or self.mesh.is_primary

    @property
    def model(self):
        return self.state.model

    @property
    def graphs(self) -> bool:
        """Whether the train step replays its CUDA graph; settable between
        steps (False: the eager step, the captured graphs kept)."""
        return self._steps.enabled

    @graphs.setter
    def graphs(self, value: bool) -> None:
        self._steps.enabled = bool(value)

    @property
    def step_counts(self) -> Dict[str, int]:
        """Train steps taken so far: {"graphed": replays, "eager": eager steps}."""
        return self._steps.counts

    @property
    def train_graph(self) -> Optional[CapturedStep]:
        """The captured train step on the caller's batches, once there is one."""
        return self._steps.captured.get(None)

    @property
    def scan_graph(self) -> Optional[CapturedStep]:
        """The captured train step of the device-resident epoch, once there is one."""
        return self._steps.captured.get(self.epoch_scan) if self.epoch_scan is not None else None

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

    # hooks of the latent trainer (training/latent_trainer.py); the identity here
    def _encode(self, image: torch.Tensor, *enc: torch.Tensor) -> torch.Tensor:
        """A batch of images in the diffusion space, inside the step."""
        return image

    def _encode_draws(self, image: torch.Tensor, enc: Optional[torch.Tensor],
                      generator: Optional[torch.Generator]) -> tuple:
        """The draws :meth:`_encode` takes (``enc`` if given), after the
        step's own: none here."""
        return ()

    def _postprocess(self, x0: torch.Tensor, decode_scale_override: float = 0.0) -> torch.Tensor:
        """Sampled x0 in image space; ``decode_scale_override`` (the latent
        family's negative control) is ignored here."""
        return x0

    @property
    def output_image_shape(self) -> Tuple[int, int, int]:
        """(H, W, C) of what :meth:`sample` returns."""
        return self.image_shape

    def train_step(self, batch: dict, t: Optional[torch.Tensor] = None,
                   eps: Optional[torch.Tensor] = None,
                   drop: Optional[torch.Tensor] = None,
                   enc: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step on ``{"image": NHWC [-1, 1], "label": int}``.

        Returns ``{"loss", "grad_norm"}`` as device scalars (no host sync).
        The parameters' ``.grad`` keep this step's gradients afterwards.

        The draws (t, eps, the drop mask; whatever is not given) are made
        eagerly from the step's generator.  The rest runs eagerly, or with
        ``graphs`` as one replayed CUDA graph: for the first batch shape met,
        after ``WARMUP_STEPS`` eager steps at that shape; a batch of another
        shape runs the eager step.  ``step_counts`` counts both kinds.
        ``enc``: the latent trainer's encode noise (drawn last).
        """
        x0, y = self._batch(batch)
        return self._step(x0, y, t, eps, drop, enc=enc)

    def scan_step(self, scan: EpochScan, t: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None,
                  drop: Optional[torch.Tensor] = None,
                  enc: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` on the next row of ``scan``'s epoch: the batch
        is gathered on the device, inside the replayed step where there is
        one; the draws are the same as for the same batch handed over."""
        scan.take()
        return self._step(scan.x_like, scan.y_like, t, eps, drop, scan, enc)

    def _space_like(self, image: torch.Tensor) -> torch.Tensor:
        """A tensor of the diffusion space's batch shape: what t and eps are
        drawn for (the images themselves in the pixel families)."""
        if tuple(image.shape[1:]) == self.image_shape:
            return image
        return image.new_empty((image.shape[0],) + self.image_shape)

    def _global_like(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor of the global batch's shape for this process's rows
        ``x`` (``x`` itself without a mesh): what the draws are made for."""
        if self.mesh is None:
            return x
        return x.new_empty(self.mesh.global_shape(x.shape))

    def _local(self, *draws):
        """This process's rows of the global batch's draws."""
        if self.mesh is None:
            return draws
        return tuple(self.mesh.local_rows(d) for d in draws)

    def _step(self, x0, y, t, eps, drop, scan: Optional[EpochScan] = None, enc=None):
        """The draws from (x0, y)'s shapes (the global batch's under a
        mesh, then this process's rows of them), then the step on (x0, y) or
        on ``scan``'s next batch."""
        state = self.state
        gen = None
        if t is None or eps is None or drop is None or enc is None:
            gen = step_generator(self.config.seed, state.step, self.device)
        gx0, gy = self._global_like(x0), self._global_like(y)
        t, eps = self.diffusion.draw_t_eps(self._space_like(gx0), t, eps, gen)
        # a () drop mask broadcasts over the batch
        drop = self.draw_drop(gy, drop, gen).expand(gy.shape)
        draws = self._local(t, eps, drop, *self._encode_draws(gx0, enc, gen))
        return self._steps((x0, y, *draws), scan)

    def _device_step(self, x0, y, t, eps, drop, *enc) -> Dict[str, torch.Tensor]:
        """Everything of a step after the draws, as a function of device
        tensors alone: the encode (the identity in the pixel families), the
        noising, the label drop, forward, the MSE against the process's
        target (eps; a flow's velocity), backward, the gradient norm, Adam
        and the EMA."""
        state = self.state
        x0, eps = self._rows(self._encode(x0, *enc), eps)
        target, xt, t_in = self.diffusion.noised(x0, t, eps)
        y = torch.where(drop, state.model.null_label, y)
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = self._forward(state.model)(xt, t_in, y)
        loss = self._mse(target, out)
        loss.backward()
        loss = state.reduce_grads(loss)
        gnorm = state.norm(p.grad for p in state.params())
        state.update()
        return {"loss": loss, "grad_norm": gnorm}

    def _rows(self, *xs: torch.Tensor) -> tuple:
        """Under spatial parallelism this process's image rows of each NHWC
        tensor; else the tensors."""
        return tuple(self.mesh.model_rows(x) for x in xs) if self.spatial else xs

    def _forward(self, model):
        """``model``'s forward on what :meth:`_rows` gives: the explicit
        spatial one under spatial parallelism."""
        return self._sp[model] if self.spatial else model

    def _mse(self, target: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The mean squared error; under spatial parallelism this process's
        rows' squared errors over the element count of its data row's
        images (the model axis's terms sum to the mean)."""
        sq = (target.to(torch.float32) - out) ** 2
        if self.spatial:
            return sq.sum() / (sq.numel() * self.mesh.model_size)
        return torch.mean(sq)

    @torch.no_grad()
    def eval_step(self, batch: dict, index: int, t: Optional[torch.Tensor] = None,
                  eps: Optional[torch.Tensor] = None,
                  enc: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Validation loss of one batch (the current weights), with the CFG
        lerp ``uncond + cfg * (cond - uncond)`` when cfg > 0.  Under a mesh
        ``batch`` is this process's rows, the draws are the global batch's
        and the loss is the global batch's (a mean over the processes)."""
        x0, y = self._batch(batch)
        gen = None
        if t is None or eps is None or enc is None:
            gen = step_generator(self.config.seed, index, self.device, EVAL_SALT)
        gx0 = self._global_like(x0)
        t, eps = self.diffusion.draw_t_eps(self._space_like(gx0), t, eps, gen)
        t, eps, *enc = self._local(t, eps, *self._encode_draws(gx0, enc, gen))
        x0, eps = self._rows(self._encode(x0, *enc), eps)
        target, xt, t_in = self.diffusion.noised(x0, t, eps)
        model = self._forward(self.model.eval())
        out = model(xt, t_in, y)
        if self.cfg_scale > 0:
            uncond = model(xt, t_in, torch.full_like(y, model.null_label))
            out = uncond + self.cfg_scale * (out - uncond)
        loss = self._mse(target, out)
        if self.mesh is None:
            return loss
        return self.mesh.split_mean_(loss) if self.spatial else self.mesh.all_reduce_mean_(loss)

    # ------------------------------------------------------------ persistence
    def _save_best(self, _state) -> None:
        """Improvement hook: keep the best state as a copy on the device;
        it is written at the checkpoint cadence and at the end of train().
        (Under FSDP every process gathers the whole state.)"""
        self._best = _clone(self.state.state_dict())

    def _flush_best(self) -> None:
        if self._best is None:
            return
        d = self.config.checkpoints
        if self.primary:
            ckpt.atomic_save(self._best["model"], f"{d}/diffusion_model.pt")
            ckpt.atomic_save(self._best["ema"], f"{d}/diffusion_model_ema.pt")
            ckpt.save_state(f"{d}/best_state.pt", self._best, self.early_stopping.val_loss_min)
        self._best = None

    def save_latest(self) -> str:
        """The whole state to ``<checkpoints>/state.pt``, written by the
        primary process (every process calls it: under FSDP the state is
        gathered first)."""
        path = f"{self.config.checkpoints}/state.pt"
        sd = self.state.state_dict()
        if self.primary:
            ckpt.save_state(path, sd, self.early_stopping.val_loss_min)
        return path

    def load_state(self, path: str) -> None:
        """Restore a whole state; under a mesh every process reads the file
        the primary one wrote (after a barrier) and keeps its part."""
        if self.mesh is not None:
            self.mesh.barrier()
        sd = ckpt.load_state(path, map_location=self.device)
        self.state.load_state_dict(sd)
        # a captured step holds the addresses of the optimizer's old state
        self._steps.clear()
        self.early_stopping.restore(sd.get("best_val_loss", float("inf")))

    def resume_latest(self) -> bool:
        if self.mesh is not None:
            self.mesh.barrier()  # the primary's last write is whole
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
                record(self.scan_step(scan), scan.local_batch)
        else:
            for batch in self._train_batches():
                record(self.train_step(batch), len(batch["label"]))
        if not losses:
            raise ValueError("train loader yielded no batches")
        # the epoch's one host sync
        loss = check_finite("diffusion_model train_loss", torch.stack(losses).mean().item(),
                            self.config)
        self._last_grad_norm = torch.stack(gnorms).mean().item()
        # the first epoch of the process pays for builds and warm-up: no rate
        self._last_rates = tput.rates() if self._warmed_up else {}
        self._warmed_up = True
        return loss

    def _val_epoch(self) -> float:
        losses = [self.eval_step(shard_batch(self.mesh, batch), i)
                  for i, batch in enumerate(self.val_loader)]
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
            self.logger.log({"params_global_norm": float(self.state.norm(self.state.params()))},
                            step=epoch)
            we = cfg.watch_histograms_every
            if we > 0 and (epoch + 1) % we == 0:
                self.logger.log_histograms("params", [(n, fsdp.full(p)) for n, p in
                                                      self.model.named_parameters()], step=epoch)
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
               ddim_steps: int = 50, eta: float = 0.0,
               ode_direction: float = 1.0, decode_scale_override: float = 0.0) -> np.ndarray:
        """One image per entry of ``classes``, from the EMA weights by
        default; uint8 NHWC, of :attr:`output_image_shape`.  ``method``: "ddpm" (the ancestral CFG sampler;
        a flow's Euler over ``n_steps``), "ddim" (``ddim_steps`` steps,
        ``eta``; a flow's Euler) or "dpmpp" (DPM-Solver++(2M), ``ddim_steps``
        steps; a flow's Heun).  ``ode_direction`` != 1 is the flow family's
        negative control (passed on only then, as the JAX trainer does: a
        DDPM process has no such argument and raises).
        ``decode_scale_override`` != 0 is the latent family's (see
        :meth:`_postprocess`).  Under a mesh every process samples the whole
        grid from the same draws (under FSDP from the weights gathered into
        an unsharded copy: a collective; under spatial parallelism each
        process its rows, gathered)."""
        x0 = self.sample_x0(classes, cfg_scale, use_ema, generator, method, ddim_steps, eta,
                            ode_direction)
        x0 = self._postprocess(x0, decode_scale_override)
        return reverse_transform(x0.cpu().numpy())

    def sample_x0(self, classes, cfg_scale: float = 0.0, use_ema: bool = True,
                  generator: Optional[torch.Generator] = None, method: str = "ddpm",
                  ddim_steps: int = 50, eta: float = 0.0,
                  ode_direction: float = 1.0) -> torch.Tensor:
        """:meth:`sample`'s draws in the diffusion space, before the
        post-processing: (B, H, W, C) fp32 on the device, whole on every
        process."""
        model = (self.state.ema if use_ema else self.model).eval()
        if self._unsharded is not None:
            self._unsharded.load_state_dict(fsdp.full_tree(model.state_dict()))
            model = self._unsharded
        if generator is None:
            generator = step_generator(self.config.seed, 0, self.device, SAMPLE_SALT)
        classes = torch.as_tensor(np.asarray(classes), dtype=torch.int64, device=self.device)
        kw = {} if ode_direction == 1.0 else {"ode_direction": ode_direction}
        shape = self.image_shape
        if self.spatial:
            # the one-process draws (x_T, then each step's noise), this
            # process's rows of them
            whole = (classes.shape[0],) + tuple(shape)

            def rows_of_draw(*_):
                return self.mesh.model_rows(torch.randn(whole, generator=generator,
                                                        device=self.device))

            kw["x_init"] = rows_of_draw()
            if isinstance(self.diffusion, GaussianDiffusion) and method in ("ddpm", "ddim"):
                kw["noise"] = rows_of_draw  # the samplers that draw a step's noise
            shape = tuple(kw["x_init"].shape[1:])
        x0 = run_sampler(self.diffusion, method, self._forward(model), classes, shape,
                         ddim_steps=ddim_steps, eta=eta, cfg_scale=cfg_scale,
                         null_label=model.null_label, generator=generator,
                         graph=None if self.graphs else False, **kw)
        return gather_rows_model(x0, self.mesh.model_group, 1) if self.spatial else x0


def run_sampler(diffusion: SamplingProcess, method: str, model, classes, image_shape,
                ddim_steps: int = 50, eta: float = 0.0, **kw) -> torch.Tensor:
    """``diffusion``'s sampler ``method`` ("ddpm", "ddim", "dpmpp"; the
    ``--sampler`` of the entry points; a ``RectifiedFlow`` maps them to
    Euler over ``n_steps``, Euler and Heun); ``kw`` go to it.  "consistency"
    samples a distilled student in ``ddim_steps`` steps
    (``sampling_timesteps``) without guidance: ``cfg_scale`` and
    ``null_label`` are dropped, the others go to ``sample_consistency``."""
    if method == "consistency":
        if not isinstance(diffusion, GaussianDiffusion):
            raise ValueError("the consistency sampler needs a GaussianDiffusion, got "
                             f"{type(diffusion).__name__}")
        kw = {k: v for k, v in kw.items() if k not in ("cfg_scale", "null_label")}
        return sample_consistency(diffusion, model, classes, image_shape,
                                  ts=sampling_timesteps(diffusion.n_steps, ddim_steps), **kw)
    if method == "ddpm":
        return diffusion.sample(model, classes, image_shape, **kw)
    if method == "ddim":
        return diffusion.sample_ddim(model, classes, image_shape, n_sample_steps=ddim_steps,
                                     eta=eta, **kw)
    if method == "dpmpp":
        return diffusion.sample_dpmpp(model, classes, image_shape, n_sample_steps=ddim_steps,
                                      **kw)
    raise ValueError(f"sampler must be one of {SAMPLERS}, got {method!r}")


def _clone(sd):
    """A deep copy of a state_dict-like tree (tensors cloned on their device)."""
    if isinstance(sd, torch.Tensor):
        return sd.detach().clone()
    if isinstance(sd, dict):
        return {k: _clone(v) for k, v in sd.items()}
    if isinstance(sd, (list, tuple)):
        return type(sd)(_clone(v) for v in sd)
    return sd
