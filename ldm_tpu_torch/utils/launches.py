"""Kernel launches, counted where they happen: one registry for the port.

An op counts its launches here as it launches, under the name of the
library it calls (``count("group_norm_silu")``; ``ops.launch_counts()``
reads every production library's), and a sub-count under a dotted name
(``linear_attention_fwd.persistent``, ``softmax_attention.self``).

A replayed CUDA graph runs no Python, so ``utils/graphs.py::StepGraph``
takes what its capture counted (:func:`snapshot`, :func:`since`), puts the
counts back (:func:`restore`: a capture runs nothing) and adds it at every
replay (:func:`add`): every count stays what an eager loop would give.
"""

from __future__ import annotations

import threading

_LOCK = threading.Lock()  # the service's threads count too
_COUNTS: dict = {}


def count(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def read(name: str) -> int:
    return _COUNTS.get(name, 0)


def snapshot() -> dict:
    with _LOCK:
        return dict(_COUNTS)


def since(before: dict) -> dict:
    """What was counted after ``before`` (a :func:`snapshot`), by name."""
    return {k: v - before.get(k, 0) for k, v in snapshot().items() if v != before.get(k, 0)}


def restore(before: dict) -> None:
    """Every count back to ``before`` (a :func:`snapshot`; ``{}`` zeroes them)."""
    with _LOCK:
        for name in _COUNTS:
            _COUNTS[name] = before.get(name, 0)


def add(counts: dict) -> None:
    for name, n in counts.items():
        count(name, n)
