"""The training cell: ``DiffusionTrainer.scan_step`` over the device-resident
epoch, as ``train.py`` trains on a card (the step replayed as a CUDA graph).

Set-up builds the trainer once with the seeded weights and the seeded split,
and drives it through its first ``check_steps`` steps with the window's own
call and feed: on a card the first three run eagerly (the capture's warm-up),
the fourth captures the step and replays it, and the rest are replays.  The
same trainer then steps through the window, crossing epoch boundaries (each
epoch's order from the seed), and ``train_img_per_s`` is the images of every
step the window started over the window's time.  After the window closes the
same call makes one more step, the late step: a replay in a later epoch,
past the window's epoch ends.

Compared (after the window, the program freed), each as a norm against the
reference's by the worst leaf (``harness.worst_leaf``):

* from the seed, the reference following the checked steps on the same
  weights, batches and draws: each leaf's first gradient (from Adam's first
  moment after step 1), and each leaf's change and its EMA's change after
  the last checked step, which the replays moved too;
* the late step, which the reference can only follow from the program's own
  state (its weights, Adam's moments, the EMA and the step count just
  before it): its loss, and each leaf's EMA change by the median leaf's
  gap.  Its gradient (from Adam's first moment before and after:
  ``(m1 - b1 m0) / (1 - b1)``) and each leaf's change are printed, not
  compared: their gaps swing from seed to seed past what separates them
  from the control (``PERF.md``).

The losses of the checked steps are printed beside the reference's, not
compared: neither the float8 control nor a planted fault moves them 3x past
what sound runs read.  Leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the changes
(``harness.moved_leaves``).

Params: ``batch``, ``train_images``, ``check_steps``, ``trace_from`` /
``trace_units`` (the profiled slice, in steps of the window), ``limits``
(one a compared number).
"""

from __future__ import annotations

import tempfile

import torch

from benchmark.entries import common
from benchmark.harness import Check, median_leaf, moved_leaves, rel_gap, worst_leaf
from benchmark.reference import diffusion as ref
from benchmark.reference.arith import Arith, tf32_off
from benchmark.reference.unet import RefUNet, attention_sites
from benchmark.tracing import Slice
from benchmark.yardsticks import train_step_flops

# what the controls put in the program's place (``benchmark/controls.py``):
# the reference's arithmetic, and whether half of each batch is left out
CONTROLS = ("control_fp8", "fault_half_batch")
_STAND_INS = {"control_fp8": (Arith("fp8"), False), "fault_half_batch": (Arith("fp32"), True)}
COMPARED = ("grad", "change", "ema_change", "late_loss", "late_ema_change_median")


def _shape(prog: dict):
    d = prog["data"]
    return (d["image_size"], d["image_size"], d["image_channels"]), d.get("num_classes", 10)


def _snapshot(st, names) -> dict:
    """The state a step moves, by leaf (clones): params, Adam's moments,
    the EMA, and the steps taken."""
    params = st.params()
    adam = [st.optimizer.state[q] for q in params]
    with torch.no_grad():
        return {"params": dict(zip(names, (p.detach().clone() for p in params))),
                "m": dict(zip(names, (a["exp_avg"].clone() for a in adam))),
                "v": dict(zip(names, (a["exp_avg_sq"].clone() for a in adam))),
                "ema": dict(zip(names, (e.detach().clone() for e in st.ema.parameters()))),
                "steps": st.step}


def _norms(tensors) -> list:
    return torch.stack(torch._foreach_norm(list(tensors))).tolist()


def run(run) -> None:
    from ldm_tpu_torch.data.datasets import Dataset
    from ldm_tpu_torch.data.loader import DataLoader
    from ldm_tpu_torch.factory import build_diffusion, build_model
    from ldm_tpu_torch.training.diffusion_trainer import DiffusionTrainer
    from ldm_tpu_torch.utils.logging import MetricsLogger

    p = run.params
    prog = run.config["program"]
    mp = prog["model"]["params"]
    shape, k = _shape(prog)
    b = int(p["batch"])
    traffic = run.gen.Traffic(p, run.seed, run.device, k)
    images, labels = traffic.dataset(int(p["train_images"]), shape)
    w = common.unet_weights(run)

    with tempfile.TemporaryDirectory() as workdir:
        config = common.program_config(run, workdir)
        if config.batch_size != b:
            raise ValueError(f"the cell's batch {b} is not the configuration's "
                             f"{config.batch_size}")
        model = build_model(config, device=run.device)
        model.load_state_dict(w, strict=True)
        diffusion = build_diffusion(config, run.device)
        loader = DataLoader(Dataset(images, labels, list(range(k))), b, shuffle=True,
                            drop_last=True)
        trainer = DiffusionTrainer(config, model, diffusion, loader, None, list(range(k)),
                                   device=run.device, logger=MetricsLogger(quiet=True))
        scan = trainer.epoch_scan
        if scan is None:
            raise RuntimeError("the trainer built no device-resident epoch")
        n_steps, drop_p = config.diffusion.n_steps, config.diffusion.label_drop_prob
        state = {"epoch": -1, "left": 0}

        def step():
            """One step of the window's call and feed; returns its (epoch,
            row), its draws and its outputs."""
            if state["left"] == 0:
                state["epoch"] += 1
                scan.start_epoch(config.seed, state["epoch"],
                                 order=traffic.epoch_order(state["epoch"], len(images)))
                state["left"] = scan.n_batches
            where = (state["epoch"], scan.n_batches - state["left"])
            draws = traffic.train_draws(n_steps, shape, drop_p)
            out = trainer.scan_step(scan, *draws)
            state["left"] -= 1
            return where, draws, out

        # the checked steps: the eager warm-up, the capture, replays
        st = trainer.state
        names = [n for n, _ in st.model.named_parameters()]
        b1 = st.hparams()[1]
        got = {"losses": []}
        checked = []
        for i in range(int(p["check_steps"])):
            where, draws, out = step()
            checked.append((where, tuple(x.clone() for x in draws)))
            got["losses"].append(out["loss"].item())
            if i == 0:
                m1 = [st.optimizer.state[q]["exp_avg"] for q in st.params()]
                got["grad"] = dict(zip(names, (torch.stack(torch._foreach_norm(m1)) /
                                               (1 - b1)).tolist()))
        with torch.no_grad():
            got["change"] = dict(zip(names, _norms(
                torch._foreach_sub(st.params(), [w[n] for n in names]))))
            got["ema_change"] = dict(zip(names, _norms(
                torch._foreach_sub(list(st.ema.parameters()), [w[n] for n in names]))))

        # the window
        sl = Slice(run.device) if run.traced else None
        if sl is not None:
            sl.warm()
        t_from, t_units = int(p.get("trace_from", 40)), int(p.get("trace_units", 20))
        outs = []
        common.reset_peak(run.device)
        win = common.Window(run)
        while True:
            if sl is not None and len(outs) == t_from:
                sl.start()
            outs.append(step()[2]["loss"])
            if sl is not None and sl.open and len(outs) == t_from + t_units:
                sl.units = t_units
                sl.stop()
            if not win.open():
                break
        window_s = win.close()
        common.read_peak(run)
        run.units = run.attempted = len(outs)
        run.failed = int((~torch.isfinite(torch.stack(outs))).sum())
        run.e2e["train_img_per_s"] = run.units * b / window_s
        run.trace = sl.reduce() if sl is not None else None
        run.n_params = sum(v.numel() for v in w.values())

        # the late step: the window's call once more, from the state it left
        before = _snapshot(st, names)
        late_where, late_draws, out = step()
        after = _snapshot(st, names)
        got["late_loss"] = out["loss"].item()
        with torch.no_grad():
            got["late_grad"] = dict(zip(names, _norms(
                (after["m"][n] - b1 * before["m"][n]) / (1 - b1) for n in names)))
            got["late_change"] = dict(zip(names, _norms(
                after["params"][n] - before["params"][n] for n in names)))
            got["late_ema_change"] = dict(zip(names, _norms(
                after["ema"][n] - before["ema"][n] for n in names)))
        del trainer, model, scan, loader, outs, st, after
    common.free(run.device)

    run.flops = run.units * train_step_flops(mp, b, shape)
    run.bwd_sites = [(b, n, c) for n, c in attention_sites(mp, shape[0])]

    # the reference: the same weights, batches and draws; the late step from
    # the program's state before it
    tf32_off()
    feed = _Feed(run, traffic, images, labels)
    batches = [feed.batch(where, draws) for where, draws in checked]
    late = feed.batch(late_where, late_draws)
    want = reference(run, w, batches, Arith("fp32"))
    want.update(late_step(run, before, late, Arith("fp32")))
    run.note(f"train check: late step at epoch {late_where[0]} row {late_where[1]}, "
             f"after {before['steps']} steps")
    judge(run, got, want)
    for what in run.stand_ins:  # the controls, on these inputs (benchmark/controls.py)
        c = reference(run, w, batches, *_STAND_INS[what])
        c.update(late_step(run, before, late, *_STAND_INS[what]))
        run.stood_in.append((what, c, want))


class _Feed:
    """The batches the program's steps gathered, made again by the
    benchmark from the seeded split and each epoch's seeded order."""

    def __init__(self, run, traffic, images, labels):
        self.traffic, self.n = traffic, len(images)
        self.table = torch.arange(256, dtype=torch.float32, device=run.device) / 255.0 * 2 - 1
        self.images = torch.from_numpy(images).to(run.device)
        self.labels = torch.from_numpy(labels).to(run.device)
        self.orders = {}

    def batch(self, where, draws) -> tuple:
        epoch, row = where
        if epoch not in self.orders:
            self.orders[epoch] = self.traffic.epoch_order(epoch, self.n)
        rows = torch.from_numpy(self.orders[epoch][row]).to(self.images.device)
        return (self.table[self.images[rows].long()], self.labels[rows], *draws)


def _model(run, arith: Arith):
    mp = run.config["program"]["model"]["params"]
    return lambda params: RefUNet(params, mp, arith)


def _schedule(run):
    dc = run.config["program"]["diffusion"]
    return ref.Schedule(dc["params"]["n_steps"], dc.get("schedule", "linear"),
                        dc.get("beta_start", 1e-4), dc.get("beta_end", 0.02), run.device)


def _half(batch, b: int, half: bool) -> tuple:
    """``batch`` with the first half of its rows alone, where ``half``."""
    return tuple(x[: b // 2] if half and x.dim() and x.shape[0] == b else x for x in batch)


def reference(run, weights, batches, arith: Arith, half: bool = False) -> dict:
    """The checked steps as the reference takes them in ``arith`` (with half
    of each batch, where ``half``): the losses, the first gradient and the
    changes."""
    prog = run.config["program"]
    b = int(run.params["batch"])
    return ref.train_steps(_schedule(run), _model(run, arith), weights,
                           [_half(x, b, half) for x in batches], _shape(prog)[1], prog["lr"],
                           prog["ema_decay"])


def late_step(run, state, batch, arith: Arith, half: bool = False) -> dict:
    """The late step as the reference takes it from ``state``."""
    prog = run.config["program"]
    b = int(run.params["batch"])
    r = ref.step_from(_schedule(run), _model(run, arith), state, _half(batch, b, half),
                      _shape(prog)[1], prog["lr"], prog["ema_decay"])
    return {"late_" + k: v for k, v in r.items()}


def judge(run, got: dict, want: dict) -> None:
    """Hold ``got`` (the program's answers, or a control's) against the
    float32 reference's ``want``: the compared numbers, with their limits,
    into ``run.checks``.  The checked steps by the worst leaf; the late
    step by its loss and by the median leaf's EMA change (its worst leaf
    swings from seed to seed; ``PERF.md``).  The rest is printed."""
    lim = run.params["limits"]
    keep = moved_leaves(want["grad"])
    keep_late = moved_leaves(want["late_grad"])
    values, worst = {}, {}
    for name in ("grad", "change", "ema_change"):
        values[name], worst[name] = worst_leaf(got[name], want[name],
                                               None if name == "grad" else keep)
    values["late_loss"] = rel_gap(got["late_loss"], want["late_loss"])
    for name in ("late_grad", "late_change", "late_ema_change"):
        k = None if name == "late_grad" else keep_late
        values[name + "_median"] = median_leaf(got[name], want[name], k)
        worst[name] = worst_leaf(got[name], want[name], k)
    run.note(f"train check: losses {got['losses']} reference {want['losses']} (gaps "
             f"{[rel_gap(a, b) for a, b in zip(got['losses'], want['losses'])]}); late loss "
             f"{got['late_loss']!r} reference {want['late_loss']!r}; "
             f"{len(keep)} and {len(keep_late)} of {len(want['grad'])} leaves moved; "
             f"printed, not compared: {[(n, values[n]) for n in values if n not in COMPARED]}; "
             f"worst leaves {worst}")
    run.checks += [Check(n, values[n], lim[n]) for n in COMPARED if n in lim]
