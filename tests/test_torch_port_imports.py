"""The PyTorch port never imports JAX: every module of ldm_tpu_torch, and
chip_smoke.py, imported in a fresh interpreter, leaves jax and flax out of
sys.modules.  And chip_smoke.py refuses to run without a CUDA card."""

import os
import pkgutil
import subprocess
import sys

import ldm_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_modules():
    return ["ldm_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(ldm_tpu_torch.__path__, "ldm_tpu_torch.")
    ]


def test_port_modules_are_found():
    mods = port_modules()
    for want in ("ldm_tpu_torch.ops.linear_attention", "ldm_tpu_torch.ops.build",
                 "ldm_tpu_torch.models.unet", "ldm_tpu_torch.utils.flax_import",
                 "ldm_tpu_torch.diffusion.schedule", "ldm_tpu_torch.diffusion.ddpm",
                 "ldm_tpu_torch.factory", "ldm_tpu_torch.registry",
                 "ldm_tpu_torch.generate", "ldm_tpu_torch.profile_sampler",
                 "ldm_tpu_torch.train", "ldm_tpu_torch.profile_train",
                 "ldm_tpu_torch.training.state",
                 "ldm_tpu_torch.training.diffusion_trainer",
                 "ldm_tpu_torch.training.checkpoint",
                 "ldm_tpu_torch.training.early_stopping",
                 "ldm_tpu_torch.utils.logging", "ldm_tpu_torch.ops.resnet_block",
                 "ldm_tpu_torch.data.transforms", "ldm_tpu_torch.data.datasets",
                 "ldm_tpu_torch.data.loader", "ldm_tpu_torch.perf.common",
                 "ldm_tpu_torch.perf.probe13", "ldm_tpu_torch.perf.probe13b",
                 "ldm_tpu_torch.perf.probe7", "ldm_tpu_torch.config",
                 "ldm_tpu_torch.utils.images", "ldm_tpu_torch.perf.compare_parent",
                 "ldm_tpu_torch.perf.plan_sweep", "ldm_tpu_torch.diffusion.flow",
                 "ldm_tpu_torch.diffusion.sampling", "ldm_tpu_torch.models.resnet",
                 "ldm_tpu_torch.ops.metrics", "ldm_tpu_torch.ops.fid",
                 "ldm_tpu_torch.training.resnet_trainer",
                 "ldm_tpu_torch.experiments.augmentation", "ldm_tpu_torch.main",
                 "ldm_tpu_torch.parallel.distributed", "ldm_tpu_torch.parallel.mesh",
                 "ldm_tpu_torch.parallel.fsdp", "ldm_tpu_torch.ops.collectives",
                 "ldm_tpu_torch.parallel.tp", "ldm_tpu_torch.parallel.sp_explicit",
                 "ldm_tpu_torch.parallel.pp",
                 "ldm_tpu_torch.train_classifier",
                 "ldm_tpu_torch.import_torch_checkpoint",
                 "ldm_tpu_torch.export_torch_checkpoint", "ldm_tpu_torch.utils.viz",
                 "ldm_tpu_torch.utils.timing", "ldm_tpu_torch.utils.profiling",
                 "ldm_tpu_torch.utils.torch_import", "ldm_tpu_torch.utils.torch_export"):
        assert want in mods


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {port_modules() + ['chip_smoke']!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py reaches everything through the port: it imports no
    ``ldm_tpu`` module, nor jax or flax, itself."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "ldm_tpu_torch" in roots
    assert not roots & {"ldm_tpu", "jax", "jaxlib", "flax"}, roots


def test_chip_smoke_fails_without_cuda():
    """No CPU fallback: without a card it exits nonzero and prints no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "kernels" not in r.stdout
    assert "is_available() is False" in r.stderr
