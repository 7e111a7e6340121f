"""ResNet classifier trainer (port of ldm_tpu/training/resnet_trainer.py).

``run(mode)`` is one pass over a loader ("train", "valid" or "test", with
"pretrain" as an alias of "train") reporting the mean loss, micro / macro F1
and accuracy; ``train()`` is the epoch loop with early stopping on the
validation loss.  The step is softmax cross-entropy on the LOGITS (the
reference's double softmax is not reproduced), Adam with optax's formula, and
BatchNorm's running statistics updated in the forward; each step's confusion
matrix stays on the device and F1 is computed once a pass.

The training pass runs over a device-resident epoch where the JAX trainer
runs a ``lax.scan``: with ``pad_train_to`` a :class:`PaddedEpochScan` of that
capacity, so one set of buffers (and one captured step) serves datasets of
every size up to it (:meth:`set_train_data`, the protocol's five mixes),
else the loader's :class:`EpochScan` where ``build_epoch_scan`` allows one,
else the loader's batches.  The epoch's order comes from (the seed of the
last :meth:`reset`, the epoch index ``step // n_batches``) on the host.

On a CUDA device the train step is a CUDA graph captured once and replayed
(``utils/graphs.py::GraphedStep``, the diffusion trainer's policy): the
first ``WARMUP_STEPS`` steps at the first batch shape run eagerly, then
every step at that shape is a replay of the graph for its batch source (the
epoch's buffers or the caller's batches; another shape runs eagerly),
through every later :meth:`reset` (which re-initializes the weights,
BatchNorm statistics and Adam in place) and :meth:`set_train_data`.  ``graphs=False`` (the entry
point's ``--eager``) asks for the eager step; on the CPU there is no other.
Evaluation and :meth:`features` run eagerly.

The best weights and statistics (by validation loss) are kept on the device
and written to ``<checkpoints>/<name>.pt`` at the checkpoint cadence and at
the end; :meth:`load_best` takes the device copy back (the disk file when
there is none).  The classifier has no EMA: the JAX one's is updated but
never read.

Under data parallelism (``mesh=``; plain DP with replicated parameters, as
the JAX classifier's mesh takes it) each process trains on its rows of every
global batch, BatchNorm normalizes by the global batch's statistics
(``models/resnet.py::sync_batch_norm``), the gradients and the loss are
averaged and the confusion matrices summed over the processes; evaluation
batches are the global loader's, each process taking its rows.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ldm_tpu_torch.config import Config
from ldm_tpu_torch.models.resnet import sync_batch_norm
from ldm_tpu_torch.ops.metrics import confusion_matrix, f1_from_confusion
from ldm_tpu_torch.parallel import distributed
from ldm_tpu_torch.parallel.mesh import global_batch_multiple, shard_batch
from ldm_tpu_torch.training import checkpoint as ckpt
from ldm_tpu_torch.training.early_stopping import EarlyStopping
from ldm_tpu_torch.training.scan_epochs import EpochScan, PaddedEpochScan, build_epoch_scan
from ldm_tpu_torch.training.state import TrainState
from ldm_tpu_torch.utils.graphs import CapturedStep, GraphedStep, use_graphs
from ldm_tpu_torch.utils.logging import MetricsLogger
from ldm_tpu_torch.utils.seed import check_finite

MODES = {"train": "train", "pretrain": "train", "valid": "valid", "test": "test"}


class ResNetTrainer:
    def __init__(
        self,
        config: Config,
        model,  # ldm_tpu_torch.models.resnet.ResNetBase, on `device`
        train_loader,
        val_loader,
        classes,
        test_loader=None,
        logger: Optional[MetricsLogger] = None,
        name: str = "resnet",
        pad_train_to: Optional[int] = None,
        device=None,
        graphs: Optional[bool] = None,
        mesh=None,
    ):
        """``graphs``: None replays the train step as a CUDA graph on a CUDA
        device and runs it eagerly elsewhere; False asks for the eager step;
        True on another device raises.  ``mesh``: data parallelism over its
        processes (the loaders are the global batches')."""
        if mesh is not None and config.param_sharding != "replicated":
            raise ValueError("the classifier trains data-parallel with replicated "
                             f"parameters, got param_sharding {config.param_sharding!r}")
        self.config = config
        self.mesh = mesh
        self.device = torch.device(device) if device is not None else next(
            model.parameters()).device
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.test_loader = test_loader
        self.num_classes = len(classes)
        self.name = name
        self.logger = logger or MetricsLogger(config.dirpath, config.project_name)
        config.create_dirs()
        sync_batch_norm(model, mesh)
        self.state = TrainState(model, config.lr, config.ema_decay, ema=False, mesh=mesh)
        # the step, eager or replayed: one graph a batch source (None: the
        # caller's batches; or the epoch whose batches the step gathers)
        self._steps = GraphedStep(self._device_step, self.state, self.device,
                                  use_graphs(self.device, graphs, mesh))
        if pad_train_to is not None and config.scan_epochs:
            d = config.data
            self.epoch_scan: Optional[EpochScan] = PaddedEpochScan(
                train_loader.batch_size, pad_train_to,
                (d.image_size, d.image_size, d.image_channels), self.device,
                shuffle=bool(train_loader.shuffle), mesh=mesh)
            self.epoch_scan.set_data(train_loader.dataset.images, train_loader.dataset.labels)
        else:
            self.epoch_scan = build_epoch_scan(train_loader, self.device,
                                               enabled=config.scan_epochs, mesh=mesh)
        self.reset(config.seed)

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

    # ------------------------------------------------------------ experiments
    def reset(self, seed: Optional[int] = None, name: Optional[str] = None) -> None:
        """Start afresh without capturing anything again: the weights and
        BatchNorm statistics re-initialized from ``seed`` (the config's by
        default) and Adam zeroed, all in place; early stopping and the best
        copy cleared; the validation loader's shuffle restarted, so a run is
        a function of its seed and data alone, whatever ran before it.  With
        :meth:`set_train_data` this retrains from scratch on another dataset
        (the protocol's experiment loop)."""
        self.seed = self.config.seed if seed is None else int(seed)
        self.model.init_weights(self.seed)
        self.state.restart()
        if self.val_loader is not None:
            self.val_loader.restart()
        self.early_stopping = EarlyStopping(
            patience=self.config.early_stopping_patience, verbose=True,
            save_fn=self._save_best, min_delta_rel=self.config.early_stopping_min_delta_rel)
        self._best: Optional[dict] = None
        self._best_dirty = False
        if name is not None:
            self.name = name

    def set_train_data(self, dataset) -> None:
        """Swap the training dataset (``pad_train_to`` mode only): copied into
        the padded epoch's buffers, nothing captured again."""
        if not isinstance(self.epoch_scan, PaddedEpochScan):
            raise RuntimeError("set_train_data requires pad_train_to (PaddedEpochScan) mode")
        self.epoch_scan.set_data(dataset.images, dataset.labels)
        self.train_loader.dataset = dataset

    # ------------------------------------------------------------------ steps
    def _batch(self, batch: dict):
        image = torch.as_tensor(batch["image"]).to(self.device, torch.float32)
        label = torch.as_tensor(batch["label"]).to(self.device, torch.int64)
        return image, label

    def _device_step(self, x: torch.Tensor, y: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step on device tensors alone: forward in train mode (the
        BatchNorm statistics move), cross-entropy, backward, Adam, and the
        step's confusion matrix."""
        state = self.state
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        logits = state.model(x)
        loss = F.cross_entropy(logits, y)
        loss.backward()
        loss = state.reduce_grads(loss)
        state.update()
        return {"loss": loss, "cm": self._sum(confusion_matrix(logits.detach().argmax(-1), y,
                                                               self.num_classes))}

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes (``t`` without a mesh)."""
        return t if self.mesh is None else self.mesh.all_reduce_(t)

    def train_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """One optimisation step on ``{"image": NHWC [-1, 1], "label": int}``;
        ``{"loss", "cm"}`` as device tensors."""
        return self._steps(self._batch(batch))

    def scan_step(self, scan: EpochScan) -> Dict[str, torch.Tensor]:
        """:meth:`train_step` on the next row of ``scan``'s epoch, gathered on
        the device (inside the replayed step where there is one)."""
        scan.take()
        return self._steps((scan.x_like, scan.y_like), scan)

    @torch.no_grad()
    def eval_step(self, batch: dict) -> Dict[str, torch.Tensor]:
        """Loss and confusion matrix of one batch with the running statistics
        (under a mesh: this process's rows; the global batch's loss and
        matrix)."""
        x, y = self._batch(batch)
        logits = self.model.eval()(x)
        loss = F.cross_entropy(logits, y)
        if self.mesh is not None:
            self.mesh.all_reduce_mean_(loss)
        return {"loss": loss, "cm": self._sum(confusion_matrix(logits.argmax(-1), y,
                                                               self.num_classes))}

    # ------------------------------------------------------------ persistence
    def _save_best(self, _state) -> None:
        """Improvement hook: a device copy of the weights and BatchNorm
        statistics, written at the checkpoint cadence and at the end."""
        self._best = {k: v.detach().clone() for k, v in self.model.state_dict().items()}
        self._best_dirty = True

    def _flush_best(self) -> None:
        if self._best_dirty and (self.mesh is None or self.mesh.is_primary):
            ckpt.atomic_save(self._best, f"{self.config.checkpoints}/{self.name}.pt")
            self._best_dirty = False

    def load_best(self) -> None:
        """The best weights and statistics back into the model, in place: the
        device copy, or ``<checkpoints>/<name>.pt`` when there is none."""
        best = self._best
        if best is None:
            best = torch.load(f"{self.config.checkpoints}/{self.name}.pt",
                              map_location=self.device, weights_only=True)
        self.model.load_state_dict(best, strict=True)

    # ------------------------------------------------------------- embeddings
    @torch.no_grad()
    def features(self, images_m11: np.ndarray, batch_size: int = 256) -> np.ndarray:
        """Pooled penultimate embeddings (the FID feature space) of float
        NHWC images in [-1, 1], in eval mode, as fp32 numpy."""
        model = self.model.eval()
        outs = [model(torch.as_tensor(np.asarray(images_m11[i: i + batch_size], np.float32))
                      .to(self.device), features=True)
                for i in range(0, len(images_m11), batch_size)]
        return torch.cat(outs).cpu().numpy()

    # ------------------------------------------------------------------- run
    def run(self, mode: str, dataloader=None) -> Dict[str, float]:
        """One pass: {"loss", "f1_micro", "f1_macro", "accuracy"}.  The
        losses and confusion matrices stay on the device until the end."""
        if mode not in MODES:
            raise ValueError(f"mode must be one of {sorted(MODES)}, got {mode!r}")
        kind = MODES[mode]
        if dataloader is None:
            dataloader = {"train": self.train_loader, "valid": self.val_loader,
                          "test": self.test_loader}[kind]
        outs: List[Dict[str, torch.Tensor]] = []
        scan = self.epoch_scan
        if kind == "train" and dataloader is self.train_loader and scan is not None:
            if scan.n_batches == 0:
                raise ValueError("the training set has no full batch")
            scan.start_epoch(self.seed, self.state.step // scan.n_batches)
            outs = [self.scan_step(scan) for _ in range(scan.n_batches)]
        elif kind == "train":
            if self.mesh is not None:
                dataloader = distributed.per_host_loader(dataloader, self.mesh)
            outs = [self.train_step(batch) for batch in dataloader]
        else:
            # under a mesh a batch must split over it (the JAX trainer skips
            # the ones that do not: a last, short batch)
            outs = [self.eval_step(shard_batch(self.mesh, batch)) for batch in dataloader
                    if len(batch["label"]) % global_batch_multiple(self.mesh) == 0]
        if not outs:
            raise ValueError(f"{mode} loader yielded no batches")
        cm = torch.stack([o["cm"] for o in outs]).sum(dim=0)
        stats = {k: float(v) for k, v in f1_from_confusion(cm).items() if k != "f1_per_class"}
        stats["loss"] = check_finite(f"{self.name} {mode} loss",
                                     torch.stack([o["loss"] for o in outs]).mean().item(),
                                     self.config)
        return stats

    # ----------------------------------------------------------------- train
    def train(self) -> dict:
        """Epoch loop with early stopping on the validation loss."""
        self.logger.define_summaries({
            f"{self.name} train_loss": "min",
            f"{self.name} valid_loss": "min",
            f"{self.name} train_f1": "max",
            f"{self.name} valid_f1": "max",
        })
        history: dict = {"train": [], "valid": []}
        for epoch in range(self.config.epochs):
            tr = self.run("train")
            va = self.run("valid")
            history["train"].append(tr)
            history["valid"].append(va)
            self.logger.log({
                f"{self.name} train_loss": tr["loss"],
                f"{self.name} train_f1": tr["f1_micro"],
                f"{self.name} valid_loss": va["loss"],
                f"{self.name} valid_f1": va["f1_micro"],
                "epoch": epoch,
            }, step=epoch)
            self.early_stopping(va["loss"], self.state)
            ce = self.config.checkpoint_every
            if ce > 0 and (epoch + 1) % ce == 0:
                self._flush_best()
            if self.early_stopping.early_stop:
                print("Early stopping")
                break
        self._flush_best()
        return history

    def test(self) -> Dict[str, float]:
        """The test pass with the best weights."""
        self._flush_best()
        self.load_best()
        return self.run("test")
