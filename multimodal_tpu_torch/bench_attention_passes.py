"""Device time of the fused attention pair's kernels, by shape and dtype.

    python -m multimodal_tpu_torch.bench_attention_passes [--root DIR] [--tag T]

The fused attention pair's bfloat16 backward is two kernels of its own
(``ops/csrc/fused_attention.cu``): a dQ kernel (``fused_dq_kernel``, wgmma fed by TMA) that also
writes each query row's statistics, then a dK/dV kernel (``fused_dkv_kernel``). Its float32
backward is ``fused_delta_kernel`` (delta = rowsum(do * out), counted with the dQ stage) then the
flash dQ and dK/dV kernels (``flash_dq_kernel``, ``flash_dkv_kernel`` on 3xTF32) on the forward's
lse (the ``other`` cell: every kernel of the pair that no stage names). Its bfloat16 forward is ``fused_fwd_kernel``, its
float32 forward the forward core of ``ops/csrc/attention_passes.cuh``, whose backward passes (the
dQ pass and the dK/dV pass) the block-attention kernels keep; a tree from before the fused
backward had kernels of its own ran those passes for it too, and the lines name each family by
stage. This script launches the pair at the shapes the main paths give it (ViT-B/16's S=197,
ViT-B/32's S=50 and causal S=77 at B=256, the same at B=1 as a served request has them, head
dims 80 and 128 at longer S), reads each kernel's device time from ``torch.profiler``, and
prints it with the rate it stands for: the forward forms two products of 2 B H S^2 D FLOPs a
head (logits, p v), the dQ stage is counted at five (logits twice, dp twice or p v, ds k; the
bfloat16 dQ kernel forms five, the float32 flash one three), the dK/dV stage at four (half of each
under the causal mask). ``F.scaled_dot_product_attention``, forward and backward, is timed
beside them with CUDA events (the port never calls it), and so are the flash kernels on the same
tensors as ``[B, S, H, D]``: the backward pair (``flash_dq_kernel`` and ``flash_dkv_kernel``,
lse and delta formed by plain torch outside the time) in both dtypes and in bfloat16 the flash
forward (``flash_fwd_kernel``), the floor a kernel of the flash design sets at these shapes.
``--root DIR`` imports ``multimodal_tpu_torch`` from DIR instead of this checkout, so that one
call times two trees (a parent commit unpacked with ``git archive``) in turns. It needs an
NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

SHAPES = [  # (batch, seq, heads, head_dim, causal)
    (256, 197, 12, 64, False), (256, 50, 12, 64, False), (256, 77, 8, 64, True),
    (1, 197, 12, 64, False), (1, 50, 12, 64, False), (1, 77, 8, 64, True),
    (64, 257, 16, 80, False), (32, 512, 8, 128, True),
]
# the kernels of a tree at or after the fused backward's own kernels (fused_dq*, fused_dkv* in
# bfloat16, the flash pair in float32) and of one before them (the block kernels' passes,
# attn_bwd_*); products a (query, key) pair
PASSES = (("forward", ("attention_", "fused_fwd_kernel"), 2),
          ("dQ", ("attn_bwd_dq_", "fused_dq_", "flash_dq_kernel", "fused_delta_kernel"), 5),
          ("dK/dV", ("attn_bwd_dkv_", "fused_dkv_", "flash_dkv_kernel"), 4))
ROUNDS = 10


def events_ms(torch, fn) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ROUNDS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ROUNDS


def device_ms(torch, fn, key) -> float:
    """Device time per call of ``fn``'s kernels whose names hold one of ``key``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ROUNDS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages() if any(k in e.key for k in key))
    return us / ROUNDS / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import multimodal_tpu_torch from this tree")
    ap.add_argument("--tag", default=None, help="the label of every line (default: the root)")
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
        for name in [m for m in sys.modules if m.startswith("multimodal_tpu_torch")]:
            del sys.modules[name]
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_passes needs an NVIDIA GPU (there is no CPU fallback)")
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from multimodal_tpu_torch.ops import flash_attention as fl
    from multimodal_tpu_torch.ops import fused_attention as fa

    takes_fwd = hasattr(fa, "fused_attention_fwd")  # a tree before it has no such backward
    tag = args.tag or args.root or "tree"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[{tag}] attention pair from {os.path.dirname(fa.__file__)}, device ms per launch "
          f"(TFLOP/s), SDPA forward / backward ms, bf16 flash forward ms [{card}]", flush=True)
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, d, causal in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(s)
            q, k, v, do = (torch.randn(b, s, h * d, generator=g, device="cuda").to(dtype)
                           for _ in range(4))
            kw = dict(heads=h, causal=causal)
            # a tree whose float32 backward reads the forward's out and lse takes them as the
            # operator hands them over
            bwd_kw = (dict(zip(("out", "lse"), fa.fused_attention_fwd(q, k, v, **kw)), **kw)
                      if takes_fwd else kw)

            def pair():
                fa.fused_attention(q, k, v, **kw)
                fa.fused_attention_bwd(q, k, v, do, **bwd_kw)

            for _ in range(3):
                pair()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ROUNDS):
                    pair()
                torch.cuda.synchronize()
            unit = 2 * b * h * s * s * d * (0.5 if causal else 1.0)  # FLOPs of one product
            cells = []
            rows = [e for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA]  # the kernels
            other = sum(e.device_time_total for e in rows) / ROUNDS / 1e3
            for name, key, products in PASSES:
                us = sum(e.device_time_total for e in rows if any(k in e.key for k in key))
                ms = us / ROUNDS / 1e3
                other -= ms
                cells.append(f"{name} {ms:.4f} ({products * unit / ms / 1e9:.1f})")
            cells.append(f"other {other:.4f}")
            heads_first = lambda t: t.view(b, s, h, d).transpose(1, 2)  # noqa: E731
            leaves = [heads_first(t).detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            lib_fwd = events_ms(torch, lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in leaves), is_causal=causal))
            lib_bwd = events_ms(torch, lambda: torch.autograd.grad(out, leaves, heads_first(do),
                                                                   retain_graph=True))
            # the flash kernels on the same tensors: the packed tensors are [B, S, H, D] as
            # they lie; the backward pair takes lse and delta = rowsum(do * out) formed by
            # plain torch, outside the time
            as_heads = lambda t: t.view(b, s, h, d)  # noqa: E731
            qs, ks, vs, dos = (as_heads(t) for t in (q, k, v, do))
            out_h, lse = fl.flash_attention_reference(qs, ks, vs, causal=causal)
            delta = fl.flash_delta(out_h, dos)
            floor = "; flash dQ + dK/dV {:.4f}".format(device_ms(
                torch, lambda: (fl.flash_attention_dq(qs, ks, vs, dos, lse, delta, causal=causal),
                                fl.flash_attention_dkv(qs, ks, vs, dos, lse, delta,
                                                       causal=causal)),
                ("flash_dq_kernel", "flash_dkv_kernel")))
            if dtype == torch.bfloat16:
                floor += "; flash forward {:.4f}".format(device_ms(
                    torch, lambda: fl.flash_attention_fwd(qs, ks, vs, causal=causal),
                    ("flash_fwd_kernel",)))
            name = str(dtype).replace("torch.", "")
            print(f"[{tag}] {name:<8} B={b:<3} S={s:<3} H={h:<2} D={d:<3} causal={causal!s:<5} "
                  f"{'; '.join(cells)}; SDPA {lib_fwd:.4f} / {lib_bwd:.4f}{floor}", flush=True)


if __name__ == "__main__":
    main()
