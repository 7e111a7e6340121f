"""The protocol's exp1 classifier (100% real data) under variants: why its
test F1 can sit at chance after a few epochs.

    python -m ldm_tpu_torch.perf.protocol_f1 [--size 2560] [--epochs 2 10]
        [--device cuda|cpu] [--tiny] [--out rows.json]

For each family's config (the pixel config on the easy synthetic CIFAR-10
fallback, the flow config on the hard one) at ``--size`` synthetic train
images, exp1's training set is made as the protocol makes it
(``protocol_splits``, ``_mix`` at exp1's seed), and the protocol's ResNet-18
trains on it from exp1's seed through a :class:`ResNetTrainer` built as the
protocol builds it, under two settings: the protocol's (the config's bf16,
the replayed step on a card) and fp32 eager, for each number of epochs.

Each row gives the test F1 with the running statistics (what the protocol
reports, from the best state by validation loss) and with each test batch's
own statistics (train-mode BatchNorm, the running statistics put back
after), the per-epoch train and validation losses, and how far the running
statistics lag: over every BatchNorm channel, the median of running_var /
the variance of the first test batch's input there, and of |running_mean -
that batch's mean| / its standard deviation.  With momentum 0.99 and
statistics that start at (0, 1), a step count k leaves 0.99**k of the
initial values in.  ``--tiny`` swaps ResNet-18 for a two-block ResNet of
8 and 16 channels, small enough for the CPU.  Prints one line a row; writes
the rows as JSON only to ``--out``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import tempfile
from typing import Optional, Sequence

import numpy as np
import torch

from ldm_tpu_torch.data.loader import DataLoader
from ldm_tpu_torch.experiments import augmentation as aug
from ldm_tpu_torch.factory import build_classifier, compute_dtype, load_config
from ldm_tpu_torch.models.resnet import BatchNorm, ResNetBase
from ldm_tpu_torch.ops.metrics import confusion_matrix, f1_from_confusion
from ldm_tpu_torch.training.resnet_trainer import ResNetTrainer
from ldm_tpu_torch.utils.seed import apply_runtime_flags, set_seed

FAMILIES = {"pixel": "configs/pixel_diffusion_model_cifar10.yaml",
            "flow": "configs/protocol_flow_hard.yaml"}


@torch.no_grad()
def batch_stat_eval(rt: ResNetTrainer, loader) -> dict:
    """Test F1 with each batch's own BatchNorm statistics, and the lag of the
    running statistics behind the first batch's; the model's buffers are
    put back after."""
    model = rt.model
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    seen = {}

    def hook(module, inputs, _out):
        if module not in seen:
            var, mean = torch.var_mean(inputs[0].float(), dim=(0, 2, 3), correction=0)
            seen[module] = (module.running_mean.clone(), module.running_var.clone(), mean, var)

    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
    handles = [m.register_forward_hook(hook) for m in bns]
    try:
        model.train()
        cms = []
        for batch in loader:
            x, y = rt._batch(batch)
            cms.append(confusion_matrix(model(x).argmax(-1), y, rt.num_classes))
    finally:
        for h in handles:
            h.remove()
        model.load_state_dict(saved)
    var_ratio = torch.cat([rv / v.clamp_min(1e-12) for _, rv, _, v in seen.values()])
    mean_shift = torch.cat([(rm - m).abs() / v.clamp_min(1e-12).sqrt()
                            for rm, _, m, v in seen.values()])
    return {"f1_batch_stats": float(f1_from_confusion(torch.stack(cms).sum(0))["f1_micro"]),
            "running_var_over_batch_var_median": float(var_ratio.median()),
            "running_mean_shift_in_std_median": float(mean_shift.median())}


def run(family: str, size: int, epochs: int, amp: bool, graphs: Optional[bool],
        device, tiny: bool = False) -> dict:
    with tempfile.TemporaryDirectory() as workdir:
        config = load_config(FAMILIES[family])
        config = dataclasses.replace(
            config, workdir=workdir, data=dataclasses.replace(config.data, synthetic_size=size))
        set_seed(config.seed)
        apply_runtime_flags(config)
        _, (clf_tr, clf_va), test = aug.protocol_splits(config)
        seed = aug._exp_seed(config.seed, "exp1")
        exp1 = aug._mix(clf_tr, clf_tr, 1.0, 0.0, seed)
        clf_cfg = dataclasses.replace(config, loss_fn="cross-entropy", epochs=epochs,
                                      use_amp=amp, project_name=config.project_name + "_f1")
        bs = config.batch_size
        test_loader = DataLoader(test, bs, shuffle=False, drop_last=False)
        channels = config.data.image_channels
        clf = (ResNetBase(channels, 10, n_blocks=(1, 1), n_channels=(8, 16),
                          dtype=compute_dtype(clf_cfg), device=device) if tiny
               else build_classifier(clf_cfg, channels, 10, device=device))
        rt = ResNetTrainer(
            clf_cfg, clf,
            DataLoader(exp1, bs, seed=config.seed), DataLoader(clf_va, bs, seed=config.seed + 1),
            test.classes, test_loader=test_loader, name="resnet_exp1",
            pad_train_to=len(exp1), device=device, graphs=graphs)
        rt.reset(seed=seed, name="resnet_exp1")
        rt.set_train_data(exp1)
        history = rt.train()
        stats = rt.test()  # the best state by validation loss, as the protocol reports
        row = {"family": family, "arch": "tiny" if tiny else "resnet18", "size": size,
               "train_images": len(exp1), "epochs": epochs,
               "steps": rt.state.step, "dtype": "bf16" if amp else "fp32",
               "graphed": rt.step_counts["graphed"] > 0,
               "f1_running_stats": stats["f1_micro"], "test_loss": stats["loss"],
               "train_loss": [h["loss"] for h in history["train"]],
               "valid_loss": [h["loss"] for h in history["valid"]]}
        row.update(batch_stat_eval(rt, test_loader))
        torch.backends.cudnn.deterministic = False
        return row


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=2560)
    ap.add_argument("--epochs", type=int, nargs="+", default=[2, 10])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true", help="a two-block ResNet (8, 16 channels)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    rows = []
    for family in FAMILIES:
        for epochs in args.epochs:
            for amp, graphs in ((True, None), (False, False)):
                row = run(family, args.size, epochs, amp, graphs, device, args.tiny)
                rows.append(row)
                print(f"protocol_f1 {row['arch']} {family} exp1 {row['train_images']} images, "
                      f"{epochs} epochs ({row['steps']} steps), {row['dtype']} "
                      f"{'graphed' if row['graphed'] else 'eager'}: test F1 running stats "
                      f"{row['f1_running_stats']!r}, batch stats {row['f1_batch_stats']!r}; "
                      f"running_var / batch var median "
                      f"{row['running_var_over_batch_var_median']:.4f}, mean shift median "
                      f"{row['running_mean_shift_in_std_median']:.4f} std; train loss "
                      f"{np.round(row['train_loss'], 4).tolist()}, valid loss "
                      f"{np.round(row['valid_loss'], 4).tolist()}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return rows


if __name__ == "__main__":
    main()
