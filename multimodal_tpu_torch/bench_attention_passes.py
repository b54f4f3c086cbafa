"""Device time of the fused attention pair's kernels and of the block-attention kernels' launches,
by shape and dtype.

    python -m multimodal_tpu_torch.bench_attention_passes [--root DIR] [--tag T] [--part P]

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

``--part block`` (or ``all``, the default) times the bfloat16 block-attention operators
(``ops/csrc/block_attention_{fwd,bwd}.cu``, both forms) at B=256 on ViT-B/32's and ViT-B/16's
shapes, launch by launch: each kernel's device time by name, summed into the projection GEMMs
(``mma_gemm_kernel`` or ``wgmma_gemm_kernel``, each instantiation by form, load and store), the
attention core or the backward's dQ and dK/dV passes, and the LayerNorm launches, with the rate
of the whole call (the FLOPs chip_smoke.py's ``block_bound`` counts) and the host's time a call
(the wrapper, the tensor maps' encoding and the launches), and the host time of one tensor map's
encode (the driver's ``cuTensorMapEncodeTiled`` through ctypes). Beside them the plain
bfloat16 wgmma GEMM at M = B*S, N = K = W, as the fused MLP runs it with H = W: its c_proj (NN,
round store) and its dln (NT, float32 out).
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
BLOCK_SHAPES = [  # (case, batch, seq, width, heads, causal, LN form): bfloat16, fwd and bwd
    ("vision", 256, 50, 768, 12, False, False), ("shared-text", 256, 77, 768, 12, True, False),
    ("vclip-text", 256, 78, 512, 8, True, False), ("vision-S197", 256, 197, 768, 12, False, False),
    ("ln-S197", 256, 197, 768, 12, False, True),
]
# a block call's kernels by stage, the first match wins
BLOCK_STAGES = (("GEMMs", ("mma_gemm_kernel",)),
                ("core", ("attention_mma_kernel", "fused_fwd_kernel")),
                ("dQ", ("attn_bwd_dq_", "fused_dq_kernel")),
                ("dK/dV", ("attn_bwd_dkv_", "fused_dkv_kernel")),
                ("LN", ("ln_stats_kernel", "ln_rows", "ln_bwd_kernel")))


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


def kernel_ms(torch, fn) -> list:
    """[(kernel name, device ms per call)] of ``fn``'s CUDA kernels, from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(ROUNDS):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.device_time_total / ROUNDS / 1e3) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def host_ms(torch, fn, calls: int = 20) -> float:
    """Host time per call of ``fn`` with the device idle at the start: the wrapper, the tensor
    maps' encoding and the launches, while the device works behind them."""
    import time

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = 1e3 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return ms


def encode_us(torch, rows: int, cols: int, box_rows: int, calls: int = 2000) -> float:
    """Host microseconds of one ``cuTensorMapEncodeTiled`` (the driver's, through ctypes) of a
    bf16 [rows, cols] operand in boxes of 64 columns x ``box_rows`` rows in the 128-byte swizzle,
    as the ``wgmma`` launchers encode their maps, each call."""
    import ctypes
    import time

    fn = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    fn.restype = ctypes.c_int
    u64, u32 = ctypes.c_uint64, ctypes.c_uint32
    t = torch.empty(rows, cols, dtype=torch.bfloat16, device="cuda")
    buf = (ctypes.c_uint8 * 256)()
    tmap = ctypes.c_void_p((ctypes.addressof(buf) + 63) & ~63)  # CUtensorMap: 64-byte aligned
    dims, strides = (u64 * 2)(cols, rows), (u64 * 1)(2 * cols)
    box, elem = (u32 * 2)(64, box_rows), (u32 * 2)(1, 1)
    # bfloat16 (9), no interleave (0), 128-byte swizzle (3), L2 promotion 256B (3), no OOB fill
    args = (tmap, 9, 2, ctypes.c_void_p(t.data_ptr()), dims, strides, box, elem, 0, 3, 3, 0)
    if fn(*args) != 0:
        raise RuntimeError("cuTensorMapEncodeTiled failed")
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    return 1e6 * (time.perf_counter() - t0) / calls


def block_label(name: str) -> str:
    """A block call's kernel by name: a GEMM by its form, load, store (and operand sets, where
    the name has them), any other kernel by its function name."""
    import re

    from multimodal_tpu_torch.ops._build import gemm_signature

    sig = gemm_signature(name)
    if sig is not None:
        args = re.search(r"mma_gemm_kernel<([^>]*)>", name)
        fields = args.group(1).split(", ") if args else []
        sets = f" x{fields[6]}" if len(fields) == 7 else ""
        kind = "wgmma" if "wgmma_gemm_kernel" in name else "mma"
        out = "->f32" if sig[1] == "float" else ""
        return f"{kind} {sig[2]}/{sig[3]}/{sig[4]}{out}{sets}"
    name = name.replace("(anonymous namespace)::", "")
    found = re.search(r"(\w+_kernel)(<[^(]*>)?", name)
    return found.group(1) + (found.group(2) or "").replace(" >", ">") if found else name[:40]


def block_rows(torch, tag, card):
    """The bfloat16 block operators' launches at BLOCK_SHAPES, and the plain wgmma GEMM."""
    from multimodal_tpu_torch.ops import block_attention as ba
    from multimodal_tpu_torch.ops import block_mlp as bm

    dt = torch.bfloat16
    print(f"[{tag}] block attention bfloat16 from {os.path.dirname(ba.__file__)}, device ms per "
          f"call by stage and launch [{card}]", flush=True)
    for case, b, s, w, heads, causal, ln in BLOCK_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
        x, dy = rnd(b, s, w).to(dt), rnd(b, s, w).to(dt)
        ws = []
        for _ in range(4):
            ws += [(rnd(w, w) * w ** -0.5).to(dt), (rnd(w) * 0.02).to(dt)]
        gamma, beta = (1 + 0.1 * rnd(w)).to(dt), (0.1 * rnd(w)).to(dt)
        kw = dict(heads=heads, causal=causal)
        if ln:
            calls = (("fwd", lambda: ba.block_attention_ln(x, gamma, beta, *ws, residual=True,
                                                           **kw)),
                     ("bwd", lambda: ba.block_attention_ln_bwd(x, dy, gamma, beta, *ws,
                                                               residual=True, **kw)))
        else:
            calls = (("fwd", lambda: ba.block_attention(x, *ws, **kw)),
                     ("bwd", lambda: ba.block_attention_bwd(x, dy, *ws, **kw)))
        m, pairs = b * s, b * heads * (s * (s + 1) / 2 if causal else s * s) * (w // heads)
        for direction, fn in calls:
            rows = kernel_ms(torch, fn)
            total = sum(ms for _, ms in rows)
            host = host_ms(torch, fn)
            flops = (8 * m * w * w + 4 * pairs if direction == "fwd"
                     else 14 * m * w * w + 12 * pairs)
            stages = {name: 0.0 for name, _ in BLOCK_STAGES}
            stages["other"] = 0.0
            for name, ms in rows:
                stage = next((st for st, keys in BLOCK_STAGES if any(k in name for k in keys)),
                             "other")
                stages[stage] += ms
            launches = "; ".join(f"{block_label(name)} {ms:.4f}" for name, ms in
                                 sorted(rows, key=lambda r: -r[1]))
            print(f"[{tag}] block {direction} {'2-LN' if ln and direction == 'bwd' else ''}"
                  f"{'1-LN' if ln and direction == 'fwd' else ''} {case:<11} B={b} S={s} W={w} "
                  f"H={heads} causal={causal!s:<5} total {total:.4f} "
                  f"({flops / total / 1e9:.1f} TFLOP/s), host {host:.4f}; "
                  + "; ".join(f"{k} {v:.4f}" for k, v in stages.items())
                  + f" | {launches}", flush=True)
        # the plain wgmma GEMM at M = B*S, N = K = W: the fused MLP with H = W, its c_proj (NN,
        # round store without the residual) and its dln (NT, float32 out)
        if not ln and case in ("vision", "vision-S197"):
            h32 = lambda *shape: (rnd(*shape) * w ** -0.5).to(dt)  # noqa: E731
            x2, dy2 = x.view(m, w), dy.view(m, w)
            w1, w2 = h32(w, w), h32(w, w)
            b1, b2 = (0.02 * rnd(w)).to(dt), (0.02 * rnd(w)).to(dt)
            y2, hh = bm.block_mlp_fwd(x2, gamma, beta, w1, b1, w2, b2, residual=False)
            for direction, fn in (
                    ("fwd", lambda: bm.block_mlp_fwd(x2, gamma, beta, w1, b1, w2, b2,
                                                     residual=False)),
                    ("bwd", lambda: bm.block_mlp_bwd(x2, dy2, hh, gamma, beta, w1, w2,
                                                     residual=False))):
                rows = [(block_label(n), ms) for n, ms in kernel_ms(torch, fn)
                        if "mma_gemm_kernel" in n]
                want = "NN/plain/round" if direction == "fwd" else "NT/plain/round->f32"
                for label, ms in rows:
                    if label.split(" ")[1] == want:
                        print(f"[{tag}] plain wgmma GEMM {label} M={m} N=K={w}: {ms:.4f} ms "
                              f"({2 * m * w * w / ms / 1e9:.1f} TFLOP/s)", flush=True)
        del x, dy, ws
        torch.cuda.empty_cache()
    us = encode_us(torch, 256 * 197, 768, 128)
    print(f"[{tag}] one tensor map's encode: {us:.2f} us of host time (a bf16 block backward "
          f"encodes 23 at D = 32, 64, 128, a forward 10 at S >= 128, 6 below)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None, help="import multimodal_tpu_torch from this tree")
    ap.add_argument("--tag", default=None, help="the label of every line (default: the root)")
    ap.add_argument("--part", choices=("all", "fused", "block"), default="all",
                    help="the fused pair, the block operators, or both")
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
    if args.part in ("all", "block"):
        block_rows(torch, tag, card)
    if args.part == "block":
        return
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
