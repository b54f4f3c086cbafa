"""Profiling: a ``torch.profiler`` trace context and summaries of the chrome traces it writes
(port of ``multimodal_tpu/profiling.py``, whose XPlane reader becomes a reader of
torch.profiler's chrome-trace JSON).

    with trace("logs/run/profile"):
        for _ in range(3):
            step(...)
    print_op_summary("logs/run/profile")

``trace`` records the CPU and, where there is a card, CUDA activity, and writes one
``trace-<ns>.json`` into its directory when the body ends (the newest is the one read).
``trace_op_summary`` sums the complete events of one kind per device: on ``"cuda"`` the
kernels (``cat`` "kernel"), keyed ``cuda:<device>``; on ``"cpu"`` the operators (``cat``
"cpu_op"), keyed ``cpu``. ``trace_line_summary`` keeps each stream (each host thread on the
CPU) apart, with the union of its intervals beside their sum, so overlapping spans are not
counted as busy twice. Durations in a chrome trace are microseconds; every summary is in ms.
"""

from __future__ import annotations

import collections
import contextlib
import decimal
import glob
import json
import os
import time

_CATEGORIES = {"cuda": "kernel", "cpu": "cpu_op"}


@contextlib.contextmanager
def trace(trace_dir: str):
    """Profile the body with ``torch.profiler`` (CPU, and CUDA where a card is present) and
    write its chrome trace into ``trace_dir``; the caller synchronizes the device before the
    body ends if its last kernels should be in the trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield trace_dir
    prof.export_chrome_trace(os.path.join(trace_dir, f"trace-{time.time_ns()}.json"))


def _newest_events(trace_dir: str) -> list:
    paths = glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
    if not paths:
        raise FileNotFoundError(f"no chrome trace (*.json) under {trace_dir}")
    with open(max(paths, key=lambda p: (os.path.getmtime(p), p))) as f:
        # exact decimals: a timestamp in microseconds since the epoch, to the nanosecond, has
        # more digits than a float holds
        data = json.load(f, parse_float=decimal.Decimal)
    return data["traceEvents"] if isinstance(data, dict) else data


def _events(trace_dir: str, device: str) -> list:
    """The newest trace's complete events of ``device``'s kind, as (device key, line key,
    name, start us from the first event's, duration us)."""
    if device not in _CATEGORIES:
        raise ValueError(f"device must be one of {sorted(_CATEGORIES)}, got {device!r}")
    out = []
    for e in _newest_events(trace_dir):
        if e.get("ph") != "X" or e.get("cat") != _CATEGORIES[device]:
            continue
        args = e.get("args") or {}
        if device == "cuda":
            key = f"cuda:{args.get('device', e.get('pid'))}"
            line = f"stream {args.get('stream', e.get('tid'))}"
        else:
            key, line = "cpu", f"thread {e.get('tid')}"
        out.append((key, line, e["name"], decimal.Decimal(e["ts"]),
                    float(e.get("dur", 0.0))))
    t0 = min((ev[3] for ev in out), default=0)
    return [(k, ln, n, float(ts - t0), dur) for k, ln, n, ts, dur in out]


def trace_op_summary(trace_dir: str, device: str = "cuda") -> dict:
    """{device key: {'total_ms', 'ops': [(name, ms), ...] by time, 'launches': {name: n}}}
    over the newest trace under ``trace_dir``."""
    ms: dict = collections.defaultdict(collections.Counter)
    launches: dict = collections.defaultdict(collections.Counter)
    for key, _, name, _, dur in _events(trace_dir, device):
        ms[key][name] += dur / 1e3
        launches[key][name] += 1
    return {key: {"total_ms": sum(ops.values()), "ops": ops.most_common(),
                  "launches": dict(launches[key])} for key, ops in ms.items()}


def _union_us(intervals: list) -> float:
    ivs = sorted(intervals)
    occ, (cs, ce) = 0.0, ivs[0]
    for s, e in ivs[1:]:
        if s > ce:
            occ += ce - cs
            cs, ce = s, e
        else:
            ce = max(ce, e)
    return occ + ce - cs


def trace_line_summary(trace_dir: str, device: str = "cuda") -> dict:
    """{device key: {line: {'events', 'sum_ms', 'occupancy_ms', 'ops': [(name, ms), ...]}}}:
    one line per CUDA stream (per host thread on ``"cpu"``); ``occupancy_ms`` is the union of
    the line's intervals, its busy time."""
    lines: dict = collections.defaultdict(lambda: collections.defaultdict(list))
    for key, line, name, ts, dur in _events(trace_dir, device):
        lines[key][line].append((name, ts, dur))
    out: dict = {}
    for key, by_line in lines.items():
        out[key] = {}
        for line, events in by_line.items():
            ops: collections.Counter = collections.Counter()
            for name, _, dur in events:
                ops[name] += dur / 1e3
            out[key][line] = {
                "events": len(events),
                "sum_ms": sum(ops.values()),
                "occupancy_ms": _union_us([(ts, ts + dur) for _, ts, dur in events]) / 1e3,
                "ops": ops.most_common(),
            }
    return out


def print_op_summary(trace_dir: str, top: int = 25, device: str = "cuda"):
    for key, info in trace_op_summary(trace_dir, device).items():
        print(f"== {key}: {info['total_ms']:.2f} ms total")
        for name, ms in info["ops"][:top]:
            pct = 100.0 * ms / max(info["total_ms"], 1e-9)
            print(f"  {ms:9.3f} ms {pct:5.1f}%  {name[:100]}")
