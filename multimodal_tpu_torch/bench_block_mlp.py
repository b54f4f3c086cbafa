"""How many blocks the fused MLP backward's weight-gradient launches should aim for, and
where the forward's time goes.

    python -m multimodal_tpu_torch.bench_block_mlp [--forward] [--root DIR] [--tag T]

The backward kernel forms dW1 and dW2 as products over the token rows, split into runs of
rows with one f32 partial sum each (``ops/block_mlp.py:_wgrad_splits``). This script times
the whole backward call (CUDA events) at the B=256 token counts of ViT-B/32, ViT-B/16 and
ViT-L/14 (B=64) for a sweep of the block target ``WGRAD_BLOCKS``, 1 meaning no split but for
the float32 row cap (``WGRAD_F32_MAX_ROWS``), holds every output to the plain version at each
setting (the largest error / max|plain| beside each time), and prints the card's name and
power limit beside the times. With ``--forward`` it times the forward call instead, at the
same shapes, both dtypes, with the residual: the whole call by CUDA events, and by
``torch.profiler`` the device time of c_fc, of c_proj and of the rest (row statistics, the
wrapper's casts), with the two products' TFLOP/s.

``--root DIR`` imports ``multimodal_tpu_torch`` from DIR instead of this checkout, so that two
trees (a parent commit unpacked with ``git archive``, a patched copy) are timed by the same
script in one call, in turns; ``--tag`` labels every line (default: the root). It needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

SHAPES = [  # (name, token rows, width, hidden, act)
    ("B/32 vision", 256 * 50, 768, 3072, "quick_gelu"),
    ("B/32 text", 256 * 77, 512, 2048, "quick_gelu"),
    ("B/16 vision", 256 * 197, 768, 3072, "quick_gelu"),
    ("L/14 vision", 64 * 257, 1024, 4096, "gelu"),
]
TARGETS = (1, 264, 528, 1056, 2112, 4224, 8448)


def _operands(t, w, hid, dtype):
    g = torch.Generator(device="cuda").manual_seed(t + hid)
    rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
    x, dy = rnd(t, w).to(dtype), rnd(t, w).to(dtype)
    w1, b1 = (rnd(w, hid) * w ** -0.5).to(dtype), (rnd(hid) * 0.02).to(dtype)
    w2, b2 = (rnd(hid, w) * hid ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)
    gamma, beta = 1 + 0.1 * rnd(w), 0.1 * rnd(w)
    return x, dy, gamma, beta, w1, b1, w2, b2


def _events_ms(run, iters: int = 8) -> float:
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(3):
        run()
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launch_of(kernel: str) -> str:
    """The forward's launch a kernel name stands for: the projection GEMM's instantiation
    with the LN load (mma_gemm_kernel, or wgmma_gemm_kernel in bfloat16) is c_fc (h and g),
    any other instantiation c_proj; anything else is "other" (the row statistics, the
    wrapper's casts of gamma and beta)."""
    from multimodal_tpu_torch.ops._build import gemm_signature

    signature = gemm_signature(kernel)
    if signature is None:
        return "other"
    return "c_fc" if signature[3] == "LN" else "c_proj"


def forward(bm, card: str, tag: str):
    iters = 8
    print(f"[{tag}] block_mlp forward with the residual: ms per call (CUDA events), device ms of "
          f"each launch (torch.profiler over {iters} calls) and the products' TFLOP/s [{card}]")
    for dtype in (torch.float32, torch.bfloat16):
        for name, t, w, hid, act in SHAPES:
            x, _, gamma, beta, w1, b1, w2, b2 = _operands(t, w, hid, dtype)
            run = lambda: bm.block_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, act=act)  # noqa: E731
            want = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act)
            err = max(((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                      for a, r in zip(run(), want))
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            if not err <= tol:
                raise SystemExit(f"{name} {dtype}: error {err:.2e} x max|plain|")
            del want
            ms = _events_ms(run, iters)
            acts = [torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(iters):
                    run()
                torch.cuda.synchronize()
            parts = dict.fromkeys(("other", "c_fc", "c_proj"), 0.0)
            for ev in prof.key_averages():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total", None)
                us = ev.self_cuda_time_total if us is None else us
                parts[launch_of(ev.key)] += us / 1e3 / iters
            gflop = 2 * t * w * hid / 1e9
            print(f"[{tag}]   {name} T={t} W={w} H={hid} {act} "
                  f"{str(dtype).replace('torch.', '')}: {ms:.4f} ms; other {parts['other']:.4f}, c_fc {parts['c_fc']:.4f} "
                  f"({gflop / parts['c_fc']:.1f} TFLOP/s), c_proj {parts['c_proj']:.4f} "
                  f"({gflop / parts['c_proj']:.1f} TFLOP/s); err {err:.1e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--root", default=None, help="import multimodal_tpu_torch from this tree")
    ap.add_argument("--tag", default=None, help="the label of every line (default: the root)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_block_mlp needs an NVIDIA GPU (there is no CPU fallback)")
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
        for name in [m for m in sys.modules if m.startswith("multimodal_tpu_torch")]:
            del sys.modules[name]
    from multimodal_tpu_torch.ops import _build
    from multimodal_tpu_torch.ops import block_mlp as bm

    tag = args.tag or args.root or "tree"

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    _build.build()
    print(f"[{tag}] block_mlp kernels from {os.path.dirname(bm.__file__)} [{card}]", flush=True)
    if args.forward:
        forward(bm, card, tag)
        return
    default = bm.WGRAD_BLOCKS
    print(f"[{tag}] block_mlp backward, ms per call by weight-gradient block target "
          f"(default {default}) [{card}]")
    for dtype in (torch.float32, torch.bfloat16):
        for name, t, w, hid, act in SHAPES:
            x, dy, gamma, beta, w1, b1, w2, b2 = _operands(t, w, hid, dtype)
            h = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act)[1]
            run = lambda: bm.block_mlp_bwd(x, dy, h, gamma, beta, w1, w2, act=act)  # noqa: E731
            want = bm.block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2, act=act)
            tol = 1e-4 if dtype == torch.float32 else 2e-2
            cells = []
            for target in TARGETS:
                bm.WGRAD_BLOCKS = target
                err = max(((a.float() - r.float()).abs().max() / r.float().abs().max()).item()
                          for a, r in zip(run(), want))
                if not err <= tol:
                    raise SystemExit(f"{name} {dtype} target {target}: error {err:.2e} x max")
                cells.append(f"{target} (x{bm._wgrad_splits(t, w, hid, dtype)}): "
                             f"{_events_ms(run):.4f} err {err:.1e}")
            bm.WGRAD_BLOCKS = default
            print(f"[{tag}]   {name} T={t} W={w} H={hid} {str(dtype).replace('torch.', '')}: "
                  + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
