"""Time the flash-attention kernels in bfloat16 on the card, and the ring's schedule on them.

    python -m multimodal_tpu_torch.bench_flash [--root DIR] [--ring]

For each shape (the long-context text tower's calls: B=8 and B=32 at S=2048, B=2 at S=4096,
and D=128 at S=2048; 8 heads, causal) it times the forward, dQ and dK/dV kernels on the
operator's own tensors with CUDA events over repeated launches, prints each with the rate it
stands for (the forward forms two products of 2 x pairs x D FLOPs, dQ three, dK/dV four), and
times ``F.scaled_dot_product_attention`` forward and one backward beside them (the port never
calls it). ``--ring`` adds the ring's schedule (``ring_attention_blocks``, 4 blocks of B=2
S=8192 H=8 D=64, forward and backward, full and causal) and one flash call over the whole
sequence: wall ms (CUDA events around whole runs, host work included) and device ms (the
kernels' time from ``torch.profiler``).

``--root DIR`` imports ``multimodal_tpu_torch`` from DIR instead of this checkout, so that two
trees (a parent commit unpacked with ``git archive``, a patched copy) are timed by the same
script in one call, in turns. It needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SHAPES = [(8, 2048, 8, 64), (32, 2048, 8, 64), (2, 4096, 8, 64), (2, 2048, 8, 128)]
ROUNDS = 30


def events_ms(torch, fn, rounds: int = ROUNDS) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(rounds):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / rounds


def device_ms(torch, fn, rounds: int = 5) -> float:
    """The kernels' device time per call, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:  # kernels, not their operators
            t = getattr(ev, "self_device_time_total", None)
            total += ev.self_cuda_time_total if t is None else t
    return total / rounds / 1e3


def kernels(torch, fl, tag: str):
    import torch.nn.functional as F

    for b, s, h, d in SHAPES:
        g = torch.Generator(device="cuda").manual_seed(s + d)
        q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = fl.flash_attention_fwd(q, k, v, causal=True)
        delta = fl.flash_delta(out, do)
        ms = {
            "fwd": events_ms(torch, lambda: fl.flash_attention_fwd(q, k, v, causal=True)),
            "dq": events_ms(torch, lambda: fl.flash_attention_dq(q, k, v, do, lse, delta,
                                                                 causal=True)),
            "dkv": events_ms(torch, lambda: fl.flash_attention_dkv(q, k, v, do, lse, delta,
                                                                   causal=True)),
        }
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa = F.scaled_dot_product_attention(*leaves, is_causal=True)
        sdpa_fwd = events_ms(torch, lambda: F.scaled_dot_product_attention(*leaves,
                                                                           is_causal=True))
        sdpa_bwd = events_ms(torch, lambda: torch.autograd.grad(
            sdpa, leaves, do.transpose(1, 2), retain_graph=True))
        pairs = b * h * s * (s + 1) / 2 * d
        rates = {"fwd": 4, "dq": 6, "dkv": 8}
        print(f"[{tag}] B={b} S={s} H={h} D={d} causal bf16: " + " ".join(
            f"{name} {t:.4f} ms ({rates[name] * pairs / t / 1e9:.1f} TFLOP/s)"
            for name, t in ms.items()) + f"; SDPA forward {sdpa_fwd:.4f}, backward "
            f"{sdpa_bwd:.4f}", flush=True)


def ring(torch, tag: str):
    from multimodal_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_tpu_torch.ops.ring_attention import ring_attention_blocks

    b, s, h, d = 2, 8192, 8, 64
    for causal in (False, True):
        g = torch.Generator(device="cuda").manual_seed(s + causal)
        q, k, v = (torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)
                   .requires_grad_(True) for _ in range(3))
        ct = torch.randn(b, s, h, d, generator=g, device="cuda").to(torch.bfloat16)

        def blocks():
            out = ring_attention_blocks(q, k, v, 4, causal=causal)
            return torch.autograd.grad(out, (q, k, v), ct)

        def whole():
            out = flash_attention(q, k, v, causal=causal)
            return torch.autograd.grad(out, (q, k, v), ct)

        for name, fn in (("ring", blocks), ("one call", whole)):
            print(f"[{tag}] ring B={b} S={s} H={h} D={d} causal={causal} bf16 {name}: wall "
                  f"{events_ms(torch, fn, 10):.3f} ms, device {device_ms(torch, fn):.3f} ms",
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import multimodal_tpu_torch from this tree")
    ap.add_argument("--tag", default=None, help="the label of every line (default: the root)")
    ap.add_argument("--ring", action="store_true", help="also time the ring's schedule")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
        for name in [m for m in sys.modules if m.startswith("multimodal_tpu_torch")]:
            del sys.modules[name]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_flash needs an NVIDIA GPU (there is no CPU fallback)")
    from multimodal_tpu_torch.ops import _build
    from multimodal_tpu_torch.ops import flash_attention as fl

    tag = args.tag or args.root or "tree"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build()
    print(f"[{tag}] flash kernels from {os.path.dirname(fl.__file__)} [{card}]", flush=True)
    kernels(torch, fl, tag)
    if args.ring:
        ring(torch, tag)


if __name__ == "__main__":
    main()
