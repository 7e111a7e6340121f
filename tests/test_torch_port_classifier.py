"""The port's classifier slice held against the JAX package: the ResNet
(ldm_tpu_torch/models/resnet.py) with flax's BatchNorm, one classifier
train step, the on-device F1 (ops/metrics.py, also against sklearn), the
numpy FID (ops/fid.py) and the padded epoch (training/scan_epochs.py
``PaddedEpochScan``), each from the same weights and inputs."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from sklearn.metrics import confusion_matrix as sk_confusion
from sklearn.metrics import f1_score

from ldm_tpu.config import Config as JaxConfig
from ldm_tpu.config import DataConfig as JaxDataConfig
from ldm_tpu.data.datasets import Dataset as JaxDataset
from ldm_tpu.data.loader import DataLoader as JaxLoader
from ldm_tpu.models.resnet import ResNetBase as FlaxResNet
from ldm_tpu.ops import fid as jax_fid
from ldm_tpu.ops import metrics as jax_metrics
from ldm_tpu.training.resnet_trainer import ResNetTrainer as JaxTrainer
from ldm_tpu.training.scan_epochs import PaddedEpochScan as JaxPaddedScan
from ldm_tpu.training.state import TrainState as JaxState, make_optimizer
from ldm_tpu_torch.config import Config, DataConfig
from ldm_tpu_torch.data.datasets import Dataset
from ldm_tpu_torch.data.loader import DataLoader
from ldm_tpu_torch.models.resnet import BatchNorm, ResNetBase
from ldm_tpu_torch.ops import fid, metrics
from ldm_tpu_torch.training.resnet_trainer import ResNetTrainer
from ldm_tpu_torch.utils.flax_import import resnet_from_flax, resnet_state_dict_from_variables

SIZE, C_IN, N_CLASSES = 8, 3, 10
ARCHS = {"basic": dict(n_blocks=(1, 1), n_channels=(8, 16)),
         "bottleneck": dict(n_blocks=(1, 1), n_channels=(8, 16), bottlenecks=(4, 8))}
MODULE_ATOL = 2e-5   # modules: tests/test_torch_parity.py's bound
STATS_ATOL = 1e-6    # BatchNorm running statistics after one train-mode forward
LR = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: test workers share the cores, and the trainers'
    many small CPU ops slow each other down with a full OpenMP team each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def images(seed, n=4, size=SIZE):
    """(n, size, size, 3) fp32 in [-1, 1]; at B=4 and 8px the stem's BatchNorm
    reduces over B*H*W = 64 values, so n/(n-1) is 1.6% of the variance."""
    return np.random.default_rng(seed).uniform(-1, 1, (n, size, size, C_IN)).astype(np.float32)


def flax_pair(arch, seed=0):
    """A flax ResNet with perturbed running statistics (so eval mode reads
    non-trivial ones) and the port's, loaded from it."""
    kw = dict(img_channels=C_IN, out_channels=N_CLASSES, **ARCHS[arch])
    f = FlaxResNet(**kw)
    v = jax.device_get(f.init(jax.random.key(seed), jnp.zeros((1, SIZE, SIZE, C_IN))))
    rng = np.random.default_rng(seed + 100)
    stats = jax.tree.map(lambda a: np.asarray(a) + rng.uniform(0.1, 0.5, a.shape).astype(
        np.float32), v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    t = ResNetBase(**kw)
    t.load_state_dict(resnet_from_flax(v), strict=True)
    return f, v, t


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("mode", ["eval", "train", "features"])
def test_resnet_forward_matches_flax(arch, mode):
    f, v, t = flax_pair(arch)
    x = images(1)
    if mode == "train":
        want, _ = f.apply(v, x, train=True, mutable=["batch_stats"])
        got = t.train()(torch.from_numpy(x))
    else:
        want = f.apply(v, x, train=False, features=mode == "features")
        got = t.eval()(torch.from_numpy(x), features=mode == "features")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=MODULE_ATOL)
    if mode == "eval":
        np.testing.assert_allclose(t(torch.from_numpy(x), probs=True).detach().numpy(),
                                   np.asarray(f.apply(v, x, probs=True)), rtol=0,
                                   atol=MODULE_ATOL)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_running_statistics_after_one_train_forward(arch):
    """Every BatchNorm's running mean and variance after one train-mode
    forward: momentum 0.99 and the BIASED batch variance, 1e-6."""
    f, v, t = flax_pair(arch)
    x = images(2)
    _, upd = f.apply(v, x, train=True, mutable=["batch_stats"])
    t.train()(torch.from_numpy(x))
    want = resnet_state_dict_from_variables({"params": v["params"],
                                             "batch_stats": jax.device_get(upd["batch_stats"])})
    got = t.state_dict()
    for k, w in want.items():
        if "running" in k:
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=STATS_ATOL, err_msg=k)
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 1, k


@pytest.mark.parametrize("cls,passes", [(BatchNorm, True), (torch.nn.BatchNorm2d, False)])
def test_the_stats_check_tells_flax_batchnorm_from_torch(cls, passes):
    """The running-variance check at B*H*W = 64 fails with
    ``nn.BatchNorm2d``'s unbiased update (momentum 0.01 = flax's 0.99)."""
    x = jnp.asarray(images(3)[..., :2] * 3.0)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=1e-5)
    variables = flax_bn.init(jax.random.key(0), x)  # running var 1, as the buffers start
    want_vars = flax_bn.apply(variables, x, mutable=["batch_stats"])[1]["batch_stats"]["var"]
    bn = cls(2, eps=1e-5, momentum=0.01) if cls is torch.nn.BatchNorm2d else cls(2)
    bn.train()(torch.from_numpy(np.array(x)).permute(0, 3, 1, 2))
    err = float(np.abs(bn.running_var.detach().numpy() - np.asarray(want_vars)).max())
    assert (err <= STATS_ATOL) == passes, err


# ------------------------------------------------------------------ the step
def port_config(tmp, **kw):
    return Config(**{**dict(project_name="clf", workdir=str(tmp), batch_size=4, epochs=1,
                            lr=LR, use_amp=False, loss_fn="cross-entropy", seed=0,
                            data=DataConfig(dataset="SYNTHETIC", image_size=SIZE,
                                            image_channels=C_IN)), **kw})


def dataset(seed, n, cls=Dataset):
    rng = np.random.default_rng(seed)
    return cls(rng.integers(0, 256, (n, SIZE, SIZE, C_IN)).astype(np.uint8),
               rng.integers(0, N_CLASSES, n).astype(np.int32), list(range(N_CLASSES)), "t")


def scales(tree, floor_of=None):
    """Each leaf's largest entry, at least 1e-2 of the largest over leaves."""
    floor = 1e-2 * max(float(np.abs(a).max()) for a in (floor_of or tree).values())
    return {k: max(float(np.abs(a).max()), floor) for k, a in tree.items()}


def leaves(params, batch_stats):
    return {k: np.asarray(a, np.float64) for k, a in resnet_state_dict_from_variables(
        {"params": params, "batch_stats": batch_stats}).items()}


def assert_state_close(trainer, params, batch_stats, mu=None, nu=None, skip=()):
    """Port weights, BN buffers (and Adam moments) against the JAX trees:
    each within 1e-4 of its leaf's scale."""
    want = leaves(params, batch_stats)
    got = trainer.model.state_dict()
    sc = scales(want)
    for k, w in want.items():
        if k.endswith("num_batches_tracked") or any(s in k for s in skip):
            continue
        np.testing.assert_allclose(got[k].double().numpy(), w, rtol=0, atol=1e-4 * sc[k],
                                   err_msg=k)
    named = dict(trainer.model.named_parameters())
    for name, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        if tree is None:
            continue
        w = leaves(tree, batch_stats)
        sc = scales({k: a for k, a in w.items() if k in named})
        for k, p in named.items():
            if any(s in k for s in skip):
                continue
            np.testing.assert_allclose(trainer.state.optimizer.state[p][name].double().numpy(),
                                       w[k], rtol=0, atol=1e-4 * sc[k], err_msg=f"{k} {name}")


# the shortcut conv's bias feeds a BatchNorm in train mode: its exact
# gradient is 0, so Adam moves it by rounding noise alone (up to lr a step,
# differently on either side), and the following BatchNorm's running mean
# takes 1 - 0.99 of that bias in
NOISE_LEAVES = ("shortcut.conv.bias", "shortcut.bn.running_mean")


def test_one_classifier_step_matches_the_jax_step(tmp_path):
    """``ResNetTrainer._train_body`` and the port's ``train_step`` from equal
    weights, statistics and batch: loss 1e-5; weights, Adam moments and
    BatchNorm statistics 1e-4 of each leaf's scale."""
    f, v, _ = flax_pair("basic")
    state = JaxState.create({"params": v["params"]}, make_optimizer(LR), jax.random.key(1),
                            batch_stats=v["batch_stats"])
    fake = type("T", (), {"model": f, "num_classes": N_CLASSES})()
    ds = dataset(4, 4)
    x = (ds.images.astype(np.float32) / 255.0 * 2.0 - 1.0)
    new, out = jax.jit(lambda s, b: JaxTrainer._train_body(fake, s, b))(
        state, {"image": jnp.asarray(x), "label": jnp.asarray(ds.labels)})

    clf = ResNetBase(img_channels=C_IN, out_channels=N_CLASSES, **ARCHS["basic"])
    trainer = ResNetTrainer(port_config(tmp_path), clf, DataLoader(ds, 4), None,
                            list(range(N_CLASSES)), device="cpu")
    clf.load_state_dict(resnet_from_flax(v), strict=True)
    m = trainer.train_step({"image": x, "label": ds.labels})
    np.testing.assert_allclose(m["loss"].item(), float(out["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(m["cm"].numpy(), np.asarray(out["cm"]))
    adam = new.opt_state[0]
    assert_state_close(trainer, new.params["params"], jax.device_get(new.batch_stats),
                       adam.mu["params"], adam.nu["params"], skip=NOISE_LEAVES)
    assert trainer.state.step == 1


# ----------------------------------------------------------------- metrics
@pytest.mark.parametrize("seed", [0, 1])
def test_f1_matches_jax_and_sklearn(seed):
    """The confusion matrix equal to JAX's and sklearn's; the per-class and
    micro F1 and the accuracy equal to JAX's bit for bit, the macro F1 (a
    mean of 10 fp32 values, summed in another order) to one fp32 ulp; both
    F1s to sklearn's float64 ones to fp32 rounding; a class never predicted
    and one never present."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 9, 200)      # class 9 never present
    preds = rng.integers(1, 10, 200)      # class 0 never predicted
    cm = metrics.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(labels), 10)
    want = jax_metrics.confusion_matrix(jnp.asarray(preds), jnp.asarray(labels), 10)
    np.testing.assert_array_equal(cm.numpy(), np.asarray(want))
    np.testing.assert_array_equal(cm.numpy(), sk_confusion(labels, preds, labels=range(10)))
    got = metrics.f1_from_confusion(cm)
    jw = jax_metrics.f1_from_confusion(want)
    for k in ("f1_micro", "accuracy", "f1_per_class"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(jw[k]), err_msg=k)
    np.testing.assert_allclose(got["f1_macro"].numpy(), np.asarray(jw["f1_macro"]),
                               rtol=2.0**-23, atol=0)
    for avg in ("micro", "macro"):
        sk = f1_score(labels, preds, labels=list(range(10)), average=avg, zero_division=0)
        np.testing.assert_allclose(float(got[f"f1_{avg}"]), sk, rtol=1e-6)


@pytest.mark.parametrize("what", ["pixel", "features", "frechet", "classifier"])
def test_fid_is_the_jax_fid_bit_for_bit(what):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, (40, 16, 16, 3)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-40, 40, a.shape), 0, 255).astype(np.uint8)
    fa, fb = rng.normal(size=(50, 12)), rng.normal(size=(60, 12)) + 0.3
    if what == "pixel":
        assert fid.pixel_fid(a, b) == jax_fid.pixel_fid(a, b)
    elif what == "features":
        assert fid.fid_from_features(fa, fb) == jax_fid.fid_from_features(fa, fb)
        assert fid.fid_from_features(fa, fa) == jax_fid.fid_from_features(fa, fa)
    elif what == "frechet":
        mu, cov = fa.mean(0), np.cov(fa, rowvar=False)
        assert (fid.frechet_distance(mu, cov, mu + 1, 2 * cov)
                == jax_fid.frechet_distance(mu, cov, mu + 1, 2 * cov))
    else:
        def apply(x):
            return np.asarray(x).reshape(len(x), -1)[:, :10] * 2.0

        xa, xb = a / 127.5 - 1, b / 127.5 - 1
        assert fid.classifier_fid(apply, xa, xb) == jax_fid.classifier_fid(apply, xa, xb)


# ------------------------------------------------------------ padded epoch
def test_padded_epoch_matches_the_jax_padded_scan(tmp_path):
    """One epoch at capacity 4 batches with 3 of them valid (14 samples at
    B=4): JAX's ``PaddedEpochScan`` (4 steps, the 4th masked) and the port's
    (3 replays of the step) fed the same order, recomputed from JAX's epoch
    key: weights and BatchNorm statistics within 1e-4 of each leaf's scale.
    Then ``set_data`` to a smaller mix in the same buffers."""
    b, n, cap = 4, 14, 16
    jds, pds = dataset(6, n, JaxDataset), dataset(6, n, Dataset)
    jcfg = JaxConfig(project_name="clf", workdir=str(tmp_path / "jax"), batch_size=b,
                     epochs=1, lr=LR, use_amp=False, seed=0,
                     data=JaxDataConfig(dataset="SYNTHETIC", image_size=SIZE,
                                        image_channels=C_IN))
    flax = FlaxResNet(img_channels=C_IN, out_channels=N_CLASSES, **ARCHS["basic"])
    jt = JaxTrainer(jcfg, flax, JaxLoader(jds, b, seed=0), JaxLoader(jds, b, seed=1),
                    list(range(N_CLASSES)), pad_train_to=cap)
    assert isinstance(jt._epoch_scan, JaxPaddedScan)
    v0 = jax.device_get({"params": jt.state.params["params"],
                         "batch_stats": jt.state.batch_stats})
    key = jax.random.wrap_key_data(np.array(jax.random.key_data(jt.state.key)))  # run donates
    jt.run("train")

    # JAX's order (scan_epochs.py:170-177): uniform keys, padding sorted last
    epoch_key = jax.random.fold_in(jax.random.fold_in(key, JaxPaddedScan.SHUFFLE_SALT), 0)
    r = jnp.where(jnp.arange(cap) < n, jax.random.uniform(epoch_key, (cap,)), 2.0)
    order = np.asarray(jnp.argsort(r))[: cap // b * b].reshape(cap // b, b)[: n // b]

    clf = ResNetBase(img_channels=C_IN, out_channels=N_CLASSES, **ARCHS["basic"])
    pt = ResNetTrainer(port_config(tmp_path / "port"), clf, DataLoader(pds, b, seed=0),
                       DataLoader(pds, b, seed=1), list(range(N_CLASSES)), pad_train_to=cap,
                       device="cpu")
    clf.load_state_dict(resnet_from_flax(v0), strict=True)
    scan = pt.epoch_scan
    assert (scan.capacity, scan.n_batches) == (cap, 3)
    scan.start_epoch(0, 0, order=order)
    for _ in range(scan.n_batches):
        pt.scan_step(scan)
    assert pt.state.step == 3 == int(jt.state.step)
    assert_state_close(pt, jt.state.params["params"], jax.device_get(jt.state.batch_stats),
                       skip=NOISE_LEAVES)

    ptrs = [t.data_ptr() for t in (scan.images, scan.labels, scan.idx)]
    smaller = dataset(7, 9, Dataset)
    pt.set_train_data(smaller)
    assert [t.data_ptr() for t in (scan.images, scan.labels, scan.idx)] == ptrs
    assert (scan.n, scan.n_batches) == (9, 2)
    assert pt.run("train")["loss"] > 0 and pt.state.step == 5
    with pytest.raises(ValueError, match="capacity"):
        scan.set_data(*(lambda d: (d.images, d.labels))(dataset(8, cap + 1)))


def test_trainer_reset_train_and_test(tmp_path):
    """``reset`` gives the same weights for the same seed, in place;
    ``train`` keeps the best state and writes ``<name>.pt``; ``test`` reads
    the best weights back and its F1 is sklearn's on the same predictions."""
    pds, test = dataset(9, 20), dataset(10, 11)
    clf = ResNetBase(img_channels=C_IN, out_channels=N_CLASSES, **ARCHS["basic"])
    rt = ResNetTrainer(port_config(tmp_path, epochs=2), clf, DataLoader(pds, 4, seed=0),
                       DataLoader(pds, 4, seed=1), list(range(N_CLASSES)),
                       test_loader=DataLoader(test, 4, shuffle=False, drop_last=False),
                       pad_train_to=20, device="cpu")
    first = {k: v.clone() for k, v in clf.state_dict().items()}
    ptr = clf.conv.weight.data_ptr()
    rt.reset(seed=3, name="resnet_a")
    rt.train()
    assert os.path.exists(f"{rt.config.checkpoints}/resnet_a.pt")
    stats = rt.test()
    rt.reset(seed=0)
    assert clf.conv.weight.data_ptr() == ptr and rt.state.step == 0
    for k, v in clf.state_dict().items():
        assert torch.equal(v, first[k]), k

    rt.reset(seed=3, name="resnet_a")
    rt.load_best()  # from the file train() wrote
    x = torch.from_numpy(test.images.astype(np.float32) / 255.0 * 2.0 - 1.0)
    preds = clf.eval()(x).argmax(-1).numpy()
    assert stats["f1_micro"] == pytest.approx(
        f1_score(test.labels, preds, average="micro"), rel=1e-6)
    assert 0.0 <= stats["f1_macro"] <= 1.0 and stats["loss"] > 0


def test_reset_makes_an_experiment_independent_of_what_ran_before(tmp_path):
    """``reset`` restarts the validation loader's shuffle: an experiment
    retrained after another one gives the validation losses, test F1,
    weights and BatchNorm buffers of its first run, bit for bit."""
    a, b, val, test = dataset(9, 20), dataset(11, 20), dataset(12, 10), dataset(10, 11)
    clf = ResNetBase(img_channels=C_IN, out_channels=N_CLASSES, **ARCHS["basic"])
    # 10 validation images at batch 4 with drop_last: each pass's order picks the 8 scored
    rt = ResNetTrainer(port_config(tmp_path, epochs=2), clf, DataLoader(a, 4, seed=0),
                       DataLoader(val, 4, seed=1), list(range(N_CLASSES)),
                       test_loader=DataLoader(test, 4, shuffle=False, drop_last=False),
                       pad_train_to=20, device="cpu")

    def experiment(ds, seed, name):
        rt.reset(seed=seed, name=name)
        rt.set_train_data(ds)
        valid = [h["loss"] for h in rt.train()["valid"]]
        return valid, rt.test()["f1_micro"], {k: v.clone() for k, v in clf.state_dict().items()}

    first = experiment(b, 5, "resnet_b0")
    experiment(a, 3, "resnet_a")
    again = experiment(b, 5, "resnet_b1")
    assert again[:2] == first[:2]
    for k, v in first[2].items():
        assert torch.equal(again[2][k], v), k
