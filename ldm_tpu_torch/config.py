"""Typed YAML config system of the port (the twin of ``ldm_tpu/config.py``).

The port keeps its own copy: it imports nothing of the JAX package.  Same
dataclasses, same defaults, same YAML schema and the same ``load_config``, so
one ``configs/*.yaml`` file drives either package; ``target:`` strings keep
the JAX package's class names, which ``ldm_tpu_torch.registry`` maps to the
port's classes.  Keys that only steer the JAX package's meshes and compiler
are parsed and carried, and the port ignores them.

Schema-compatible with the reference's ``config_files/*.yaml`` and with its
``Config`` attribute-bag, parsed into typed dataclasses with defaults,
validation, and no hidden side effects beyond run-directory creation:

* run directories live under a configurable ``workdir`` (default ``runs/``);
* ``device:`` keys are ignored: the entry points take the device;
* the seed is part of the config (default 42).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import yaml


@dataclasses.dataclass
class DataConfig:
    """Reference: the ``data:`` block (config_files/*.yaml:28-32) +
    AbstractDataset/data_utils semantics (src/AbstractDataset.py:28-55,
    src/data_utils.py:26-56)."""

    dataset: str = "MNIST"
    image_channels: int = 1
    image_size: int = 32
    val_split: float = 0.1
    data_path: str = "data"
    num_classes: int = 10
    # `debugging` in the reference truncates datasets to 20 samples
    # (src/AbstractDataset.py:53-55); kept at the top level for YAML parity but also
    # mirrored here for the data layer.
    debugging: bool = False
    # Size of the SYNTHETIC fallback train split (test split = size // 4).
    # Set to 50_000 to rehearse the CIFAR-10-scale protocol without real data.
    synthetic_size: int = 2048
    # Fallback generator variant: "easy" (separable classes, everything
    # converges to F1=1.0) or "hard" (overlapping class manifolds — the
    # protocol's quality metrics can actually fail; datasets.py).
    synthetic_variant: str = "easy"
    # >0: assemble batches on the native C++ prefetch ring, this many slots
    # deep (ldm_tpu/native) — the torch DataLoader ``num_workers`` analog.
    # Silently synchronous when the native lib is unavailable.
    prefetch_batches: int = 0


@dataclasses.dataclass
class DiffusionConfig:
    """Reference: the ``diffusion:`` block (config_files/*.yaml:6-13) + the schedule
    constants hardcoded in src/DDPM.py:31-43 and src/LatentDiffusionModel.py:41-47."""

    type: str = "pixel"
    target: str = "ldm_tpu.diffusion.ddpm.GaussianDiffusion"
    cfg_scale: float = 3.0
    n_steps: int = 400
    n_samples: int = 100
    schedule: str = "linear"  # "linear" (DDPM) or "sqrt_linear" (LDM variant)
    beta_start: float = 1e-4
    beta_end: float = 0.02
    # Probability of dropping class labels during training for CFG
    # (reference: 0.1, src/DiffusionModelTrainer.py:44-45).
    label_drop_prob: float = 0.1
    # The reference drops labels for the WHOLE batch at once (np.random per batch,
    # src/DiffusionModelTrainer.py:44). "sample" drops per-sample (standard CFG
    # practice, Ho & Salimans 2022); default keeps reference behavior.
    label_drop_mode: str = "batch"
    # Latent diffusion only (reference src/LatentDiffusionModel.py:28,37).
    # A float, or "auto" to calibrate 1/std(latents) on a batch of training
    # images at trainer startup (models/latent.py:calibrate_latent_scaling —
    # the SD constant 0.18215 is only correct for SD's own VAE).
    latent_scaling_factor: Any = 0.18215

    def __post_init__(self) -> None:
        f = self.latent_scaling_factor
        if f != "auto" and (not isinstance(f, (int, float)) or f <= 0):
            raise ValueError(
                f'diffusion.latent_scaling_factor must be a positive number or '
                f'"auto", got {f!r}'
            )


@dataclasses.dataclass
class ModelConfig:
    """Reference: the ``model:`` block (config_files/*.yaml:20-27)."""

    target: str = "ldm_tpu.models.unet.UNet"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Config:
    """Top-level experiment config (reference src/Config.py + YAML schema)."""

    project_name: str = "experiment"
    entity: str = ""
    type: str = "pixel"
    debugging: bool = False
    batch_size: int = 64
    epochs: int = 100
    lr: float = 5e-4
    # torch.cuda.amp in the reference (src/Trainer.py:43); here it selects bf16
    # compute (fp32 params) — no loss scaling is needed on TPU.
    use_amp: bool = True
    loss_fn: str = "mse"
    early_stopping_patience: int = 10
    # Relative min-delta for early stopping (0 = exact reference-parity
    # semantics, where delta=0 counts even exact ties as improvement; see
    # training/early_stopping.py + PARITY.md). 0.01 means an epoch must beat
    # the best val loss by >1% of it to reset patience.
    early_stopping_min_delta_rel: float = 0.0
    seed: int = 42
    workdir: str = "runs"
    ema_decay: float = 0.9999  # EMA is an addition over the reference (BASELINE.md)
    # Run each training epoch as ONE on-device lax.scan over a device-resident
    # dataset (shuffle, gather, noising, step — zero host round-trips per epoch)
    # when the dataset fits in HBM. Falls back to per-batch stepping otherwise.
    scan_epochs: bool = True
    # Parameter placement on a mesh: "replicated" (plain DP), "fsdp"
    # (ZeRO-3-style — params/EMA/Adam moments sharded over the data axis,
    # all-gathered just-in-time by GSPMD; ~N x less optimizer-state HBM per
    # chip), "tp" (Megatron-style attention tensor parallelism over the
    # mesh's model axis; needs create_mesh(model=k)), or "fsdp_tp" (2D:
    # attention TP over model, everything else ZeRO over data). Single-device
    # runs ignore it. See ldm_tpu/parallel/fsdp.py and parallel/tp.py.
    param_sharding: str = "replicated"
    # Activation placement: "batch" (default — each device holds full
    # per-image activations) or "spatial" (SP: H sharded over the mesh's
    # model axis — for resolutions where one image's activations outgrow a
    # chip).  Sampling rides the GSPMD annotation path (parallel/sp.py);
    # training/eval ride the explicit shard_map path with hand-placed
    # halo/psum/gather collectives (parallel/sp_explicit.py) because this
    # jaxlib's GSPMD transpose corrupts annotation-path gradients
    # (perf/probe28_RESULTS.md).
    activation_sharding: str = "batch"
    # Cadence knobs (epochs). The reference samples a grid every 2 epochs
    # (src/DiffusionModelTrainer.py:140-143) and has no periodic full-state
    # checkpoint at all; full-state writes are ~4x model size and cross the
    # host link, so long runs should raise checkpoint_every.
    sample_every: int = 2
    checkpoint_every: int = 1
    # Per-tensor histogram watch cadence in epochs (0 = never) — the heavier
    # equivalent of the reference's wandb.watch(log="all") (main.py:184);
    # global norms are always logged regardless.
    watch_histograms_every: int = 0
    # NaN sanitizer: aborts the program at the op that produced a NaN
    # (jax_debug_nans) — the TPU-native stand-in for the reference's nonexistent
    # numeric debugging story (SURVEY.md §5). Applied by the entry points via
    # ldm_tpu.utils.seed.apply_runtime_flags.
    debug_nans: bool = False
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    # Latent diffusion: the frozen first stage (its arch + trained weights).
    autoencoder: Optional[ModelConfig] = None
    ae_checkpoint: str = ""

    def __post_init__(self) -> None:
        # Cadence knobs feed modulo checks in the trainers — 0 means "never"
        # (handled explicitly there); negative values are config errors.
        for knob in ("sample_every", "checkpoint_every", "watch_histograms_every"):
            v = getattr(self, knob)
            if not isinstance(v, int) or v < 0:
                raise ValueError(
                    f"config.{knob} must be a non-negative int (0 = never), got {v!r}"
                )
        if self.batch_size < 1 or self.epochs < 0:
            raise ValueError(
                f"batch_size >= 1 and epochs >= 0 required, got "
                f"batch_size={self.batch_size}, epochs={self.epochs}"
            )
        if self.param_sharding not in ("replicated", "fsdp", "tp", "fsdp_tp"):
            raise ValueError(
                f"config.param_sharding must be 'replicated', 'fsdp', 'tp', "
                f"or 'fsdp_tp', got {self.param_sharding!r}"
            )
        if self.activation_sharding not in ("batch", "spatial"):
            raise ValueError(
                f"config.activation_sharding must be 'batch' or 'spatial', "
                f"got {self.activation_sharding!r}"
            )

    # ------------------------------------------------------------------ paths
    @property
    def dirpath(self) -> str:
        return os.path.join(self.workdir, self.type, self.project_name)

    @property
    def results(self) -> str:
        return os.path.join(self.dirpath, "results")

    @property
    def checkpoints(self) -> str:
        return os.path.join(self.dirpath, "checkpoints")

    def create_dirs(self) -> None:
        """Create the run directory tree (reference src/Config.py:13-21)."""
        for d in (self.dirpath, self.results, self.checkpoints):
            os.makedirs(d, exist_ok=True)

    # --------------------------------------------------------------- dict API
    def __getitem__(self, key: str) -> Any:
        """Reference code indexes its config like a dict (src/Trainer.py:43-71)."""
        return getattr(self, key)


def _build_dataclass(cls, raw: Dict[str, Any]):
    """Build a dataclass from a raw dict, keeping only known fields."""
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})


def config_from_dict(raw: Dict[str, Any]) -> Config:
    """Parse a raw YAML mapping (reference schema) into a typed Config."""
    raw = dict(raw)

    data_raw = dict(raw.pop("data", {}) or {})
    data_raw.setdefault("debugging", raw.get("debugging", False))
    data = _build_dataclass(DataConfig, data_raw)

    diff_raw = dict(raw.pop("diffusion", {}) or {})
    # Reference nests n_steps/n_samples/device under diffusion.params
    # (config_files/*.yaml:10-13); flatten them.
    diff_params = dict(diff_raw.pop("params", {}) or {})
    diff_params.pop("device", None)
    diff_raw.update(diff_params)
    diffusion = _build_dataclass(DiffusionConfig, diff_raw)

    model_raw = dict(raw.pop("model", {}) or {})
    model = _build_dataclass(ModelConfig, model_raw)

    ae_raw = raw.pop("autoencoder", None)
    autoencoder = _build_dataclass(ModelConfig, dict(ae_raw)) if ae_raw else None

    names = {f.name for f in dataclasses.fields(Config)}
    known = {k: v for k, v in raw.items() if k in names}
    return Config(
        model=model, diffusion=diffusion, data=data, autoencoder=autoencoder, **known
    )


def load_config(path: str) -> Config:
    """Load a YAML config file (ours, or a reference config_files/*.yaml verbatim)."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    return config_from_dict(raw)
