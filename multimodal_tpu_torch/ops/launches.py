"""Counts of kernel launches, by kernel name.

Each wrapper of a hand-written kernel adds one where it launches its kernel and nowhere
else (a call that runs the plain PyTorch version counts nothing), so a run can show that
its path went through the kernels: reset, drive the path, read."""

from __future__ import annotations

import threading

_lock = threading.Lock()
_counts: dict = {}


def register(*names: str):
    """Make ``names`` appear in ``launch_counts()`` from the start, at zero."""
    with _lock:
        for name in names:
            _counts.setdefault(name, 0)


def count(name: str):
    with _lock:
        _counts[name] += 1


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name (plain-version calls excluded)."""
    with _lock:
        return dict(_counts)


def reset_launch_counts():
    with _lock:
        for name in _counts:
            _counts[name] = 0
