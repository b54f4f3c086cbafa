"""The port's profiler (``multimodal_tpu_torch/profiling.py``) and the CLI's
``--profile-steps``, on the CPU: the chrome-trace summaries on hand-written traces with known
durations and overlaps, held to the JAX package's XPlane summaries of the same events; a real
CPU ``torch.profiler`` trace; and the CLI tracing exactly N steps (one "train_step" span
each), or those an epoch shorter than N has left. Durations compared to 1e-9 ms."""

import json
import os

import pytest
import torch

from multimodal_tpu.profiling import xplane_line_summary, xplane_op_summary
from multimodal_tpu_torch.profiling import (
    print_op_summary,
    trace,
    trace_line_summary,
    trace_op_summary,
)
from multimodal_tpu_torch.train.run import main
from test_profiling import _event, _line, _metadata_entry, _plane, _write_space

# (stream, name, start ms, duration ms): stream 7 two back-to-back kernels; stream 9 two
# overlapping 2 ms spans offset by 1 ms and a disjoint 1 ms one (sum 5, union 4)
KERNELS = [(7, "gemm_kernel", 0.0, 1.0), (7, "gemm_kernel", 1.0, 1.0),
           (9, "copy_kernel", 0.0, 2.0), (9, "copy_kernel", 1.0, 2.0),
           (9, "copy_kernel", 10.0, 1.0), (7, "add_kernel", 3.0, 0.5)]


def chrome_trace(path, kernels, cpu_ops=()):
    events = [{"ph": "X", "cat": "kernel", "name": name, "pid": 0, "tid": stream,
               "ts": start * 1e3, "dur": dur * 1e3, "args": {"device": 0, "stream": stream}}
              for stream, name, start, dur in kernels]
    events += [{"ph": "X", "cat": "cpu_op", "name": name, "pid": 1, "tid": 5,
                "ts": start * 1e3, "dur": dur * 1e3} for name, start, dur in cpu_ops]
    events.append({"ph": "i", "cat": "kernel", "name": "not a span", "pid": 0, "tid": 7,
                   "ts": 0.0})
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "trace.json"), "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def xplane_of(tmp_path, kernels):
    """The same events as one XPlane device plane, a line per stream (ps)."""
    names = sorted({name for _, name, _, _ in kernels})
    meta = {name: i + 1 for i, name in enumerate(names)}
    lines = []
    for stream in sorted({s for s, _, _, _ in kernels}):
        lines.append(_line(f"stream {stream}", [
            _event(meta[n], int(start * 1e9), int(dur * 1e9))
            for s, n, start, dur in kernels if s == stream]))
    plane = _plane("cuda:0", lines, [_metadata_entry(i, n) for n, i in meta.items()])
    return _write_space(tmp_path, [plane])


def test_summaries_equal_the_xplane_summaries_of_the_same_events(tmp_path):
    root = chrome_trace(tmp_path / "chrome", KERNELS)
    ops = trace_op_summary(root)
    want = xplane_op_summary(xplane_of(tmp_path / "xplane", KERNELS), plane_filter="cuda")
    assert set(ops) == set(want) == {"cuda:0"}
    assert abs(ops["cuda:0"]["total_ms"] - want["cuda:0"]["total_ms"]) < 1e-9
    assert ops["cuda:0"]["ops"] == [("copy_kernel", 5.0), ("gemm_kernel", 2.0),
                                    ("add_kernel", 0.5)]
    assert [n for n, _ in want["cuda:0"]["ops"]] == [n for n, _ in ops["cuda:0"]["ops"]]
    assert ops["cuda:0"]["launches"] == {"gemm_kernel": 2, "copy_kernel": 3, "add_kernel": 1}

    lines = trace_line_summary(root)["cuda:0"]
    want_lines = xplane_line_summary(xplane_of(tmp_path / "xplane2", KERNELS),
                                     plane_filter="cuda")["cuda:0"]
    assert set(lines) == set(want_lines) == {"stream 7", "stream 9"}
    for name, info in lines.items():
        for key in ("events", "sum_ms", "occupancy_ms"):
            assert abs(info[key] - want_lines[name][key]) < 1e-9, (name, key)
    assert lines["stream 9"]["sum_ms"] == 5.0 and lines["stream 9"]["occupancy_ms"] == 4.0
    assert lines["stream 7"]["occupancy_ms"] == 2.5 == lines["stream 7"]["sum_ms"]


def test_device_filter_and_the_newest_trace(tmp_path, capsys):
    root = chrome_trace(tmp_path, KERNELS[:1], cpu_ops=[("aten::mm", 0.0, 3.0),
                                                         ("aten::add", 1.0, 1.0)])
    assert set(trace_op_summary(root, "cuda")) == {"cuda:0"}
    cpu = trace_op_summary(root, "cpu")
    assert cpu["cpu"]["ops"] == [("aten::mm", 3.0), ("aten::add", 1.0)]
    assert trace_line_summary(root, "cpu")["cpu"]["thread 5"]["occupancy_ms"] == 3.0
    with pytest.raises(ValueError, match="device"):
        trace_op_summary(root, "tpu")
    later = tmp_path / "later"
    chrome_trace(later, KERNELS[2:3])
    os.utime(later / "trace.json", (os.path.getmtime(root + "/trace.json") + 5,) * 2)
    assert trace_op_summary(root)["cuda:0"]["ops"] == [("copy_kernel", 2.0)]  # the newest
    print_op_summary(root)
    assert "copy_kernel" in capsys.readouterr().out
    with pytest.raises(FileNotFoundError):
        trace_op_summary(str(tmp_path / "empty"))


def test_a_real_cpu_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path)):
        for _ in range(3):
            x = torch.mm(x, x).tanh()
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".json")]
    assert path.startswith("trace-")
    info = trace_op_summary(str(tmp_path), "cpu")["cpu"]
    assert info["launches"]["aten::mm"] == 3 and info["launches"]["aten::tanh"] == 3
    assert info["total_ms"] > 0.0
    for line in trace_line_summary(str(tmp_path), "cpu")["cpu"].values():
        assert line["occupancy_ms"] <= line["sum_ms"] + 1e-9


def _train_step_spans(profile_dir) -> list:
    (path,) = [os.path.join(profile_dir, p) for p in os.listdir(profile_dir)]
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == "train_step" and e.get("ph") == "X"]


@pytest.mark.parametrize("profile_steps,traced", [(2, 2), (10, 3)],
                         ids=["two-of-four", "longer-than-the-epoch"])
def test_cli_profile_steps(tmp_path, profile_steps, traced):
    """--profile-steps N: one trace under <logs>/<name>/profile of exactly N steps after the
    first; N past the epoch's end still writes it, with the 3 steps the 4-step epoch had
    left."""
    argv = ["--dataset-type", "synthetic", "--model", "tiny-test", "--device", "cpu",
            "--batch-size", "8", "--train-num-samples", "32", "--epochs", "2",
            "--precision", "fp32", "--logs", str(tmp_path), "--name", "run",
            "--profile-steps", str(profile_steps)]
    assert main(argv) == 0
    spans = _train_step_spans(tmp_path / "run" / "profile")
    assert len(spans) == traced  # epoch 0 only: epoch 1's 4 steps are not traced
    ops = trace_op_summary(str(tmp_path / "run" / "profile"), "cpu")["cpu"]
    assert ops["launches"]["aten::_foreach_norm"] == traced  # the optimizer's clip, once a step
