"""What the probes share: the card check, CUDA-graph timing and the
kernels' launch counts."""

from __future__ import annotations

import contextlib
import subprocess

import torch

from ldm_tpu_torch.ops import launch_counts


def require_cuda(name: str) -> torch.device:
    """The card, or exit: a probe measures the card and has no CPU result.
    Products in fp32 stay fp32 (TF32 off), as the plain versions assume."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{name}: torch.cuda.is_available() is False; "
                         "this probe runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def device_tag(device) -> str:
    """What a probe's lines name: on a card its name and power limit (the
    TF32 products off, as the kernels' plain versions assume), else the
    device's type; a card asked for and absent exits."""
    device = torch.device(device)
    if device.type != "cuda":
        return f"{device.type}, no card"
    require_cuda(f"--device {device}")
    return card()


def sync(device) -> None:
    """Wait for ``device`` (a card; nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_graph_ms(fn, iters: int = 20, warmup: int = 3, replays: int = 3) -> float:
    """Mean device time of fn() in ms with the host out of the way: `iters`
    calls captured into one CUDA graph, the graph replayed, CUDA events
    around the replays.  Events around eager calls would time the host for
    kernels shorter than a launch from Python takes.  fn must not
    synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


@contextlib.contextmanager
def counting(into: dict, key: str):
    """``into[key]``: the launches the body made, by kernel name."""
    before = launch_counts()
    yield
    into[key] = {k: v - before[k] for k, v in launch_counts().items()}
