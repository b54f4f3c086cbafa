#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and its training step once on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the result lines):
  1. the card: torch.cuda.is_available() and nvidia-smi's name and power limit;
  2. build the CUDA kernels from ops/csrc with nvcc (one process per source, in parallel);
  3. every kernel against its plain PyTorch version on the card, every output, in float32
     (max abs error <= 1e-4 * max|plain|) and bfloat16 (<= 2e-2 * max|plain|), with
     CUDA-event times at B=256: the block-attention forward and backward at the ViT-B/32
     tower shapes (vision S=50 W=768 H=12, text S=77 W=512 H=8 causal), the shared trunk's
     text pass (S=77 W=768 H=12 causal), S=197 and S=257 (W=1024 H=16), with torch's
     multi_head_attention_forward timed beside them; their LN-fold forms (LayerNorm and residual inside the kernel; also
     ln_out, dgamma and dbeta) at S=197, S=257 and S=320, causal and not; the fused
     whole-sequence attention pair at S=128, 197 and 512 with D=32, 64 and 128, causal and
     not, with torch's scaled_dot_product_attention timed beside it; the fused MLP branch
     (LayerNorm, c_fc, activation, c_proj, residual) forward and backward, with and without
     the residual, at the ViT-B/32, ViT-B/16 and ViT-L/14 token counts and widths and a ragged
     T=3x197 (outputs y, h and dx, dW1, dW2, db1, db2, dgamma, dbeta; no library call holds
     it). The library calls are yardsticks, held to the plain versions too and used nowhere
     in the port;
  4. serving: ViT-B/32 in float32 with seeded random weights behind the HTTP server,
     answering text, image and similarity requests; the forward kernel's launch count over
     those requests must be at least 12 per tower encode, and the served embeddings must
     match an encode through the plain version (cosine >= 0.9999);
  5. serving throughput at bucket 256 and single-request p50 latency;
  6. training: ViT-B/32 with seeded weights, the fused AdamW (cosine schedule, weight decay
     0.1, clip 1.0) and a fixed synthetic uint8 batch of 256. float32: 6 steps through the
     kernels against 6 from the same start with every block's attention routed to the
     plain version (losses of the first 2 within 1e-5 relative, grad norms within 1e-4,
     every gradient leaf of step 1 within 1e-3 * max|leaf|, 24 launches of each block kernel
     per step); bfloat16: 6 steps, every loss and grad norm finite and the loss
     falling. Samples/s over steps 2-6 and peak memory for both;
  7. the shared-trunk ViT-B/16 at full width (12 layers, W=768, H=12; vision S=197 through
     the LN-fold kernels, text S=77 causal through the non-LN kernels): served as in phases
     4-5 (per image encode >= 12 LN-fold forward launches, per text encode >= 12 forward
     launches); trained as in phase 6, the float32 comparison at a batch both paths hold
     (64) and the rates at the largest of 64/128/256 the kernel path holds, reckoned from
     the measured peak; and the same model with ``vision.scale_heads``, whose vision pass
     goes through ``attention()`` to the fused pair (12 launches of each per step);
  8. the same shared-trunk ViT-B/16, all 12 layers, built with ``block_mlp=True``, so that
     every block's MLP half runs the fused operator's kernels: served as in phase 7 (and
     >= 12 MLP forward launches per encode); trained as in phase 7 (float32 kernel path
     against the plain path at B=64; exactly 24 MLP forward and 24 MLP backward launches per
     step beside the 12 of each block-attention kernel; float32 and bfloat16 at the largest
     batch, to be read beside phase 7's rates with the switch off); and one float32 run with
     ``remat`` at that batch: the same losses, twice the forward launches, its peak memory.
Before the last line come the card's name and power limit and the kernel summary (JSON); the
last line is the device record.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np

MODEL = "ViT-B-32"
SHARED_MODEL = "ViT-B-16"
SCALE_HEADS_MODEL = "ViT-B-16-scale-heads"
REMAT_MODEL = "ViT-B-16-remat"
_CSRC = "multimodal_tpu_torch/ops/csrc/"
_JAX_BLOCK = "multimodal_tpu/ops/block_attention.py"
_JAX_FUSED = "multimodal_tpu/ops/fused_attention.py"
_JAX_MLP = "multimodal_tpu/ops/block_mlp.py"
KERNELS = {  # name -> (source, the TPU kernel it replaces, the timed case that stands for it)
    "block_attention_fwd": (_CSRC + "block_attention_fwd.cu", _JAX_BLOCK + ":200", "vision"),
    "block_attention_bwd": (_CSRC + "block_attention_bwd.cu",
                            _JAX_BLOCK + ":272 (_bwd_kernel) and :386 (_bwd_kernel_large)",
                            "vision"),
    "block_attention_ln_fwd": (_CSRC + "block_attention_fwd.cu",
                               _JAX_BLOCK + ":200 (_fwd_kernel, LN-fold form via :650)",
                               "ln-S197"),
    "block_attention_ln_bwd": (_CSRC + "block_attention_bwd.cu",
                               _JAX_BLOCK + ":272 (_bwd_kernel, LN form via :687)", "ln-S197"),
    "fused_attention_fwd": (_CSRC + "fused_attention.cu", _JAX_FUSED + ":61", "fused-S197"),
    "fused_attention_bwd": (_CSRC + "fused_attention.cu", _JAX_FUSED + ":83", "fused-S197"),
    "block_mlp_fwd": (_CSRC + "block_mlp.cu", _JAX_MLP + ":105", "mlp-B16-vision"),
    "block_mlp_bwd": (_CSRC + "block_mlp.cu", _JAX_MLP + ":123", "mlp-B16-vision"),
}
BLOCK_CASES = [  # (case, batch, seq, width, heads, causal)
    ("vision", 1, 50, 768, 12, False),
    ("vision", 3, 50, 768, 12, False),
    ("vision", 256, 50, 768, 12, False),
    ("text", 1, 77, 512, 8, True),
    ("text", 256, 77, 512, 8, True),
    ("text-shared", 1, 77, 768, 12, True),  # the shared ViT-B/16 trunk's text pass
    ("text-shared", 256, 77, 768, 12, True),
    ("vision-S197", 4, 197, 768, 12, False),
    ("vision-S197", 256, 197, 768, 12, False),
    ("vision-S257", 2, 257, 1024, 16, False),
]
LN_CASES = [  # (case, batch, seq, width, heads, causal, residual)
    ("ln-S197", 4, 197, 768, 12, False, True),
    ("ln-S197", 4, 197, 768, 12, True, True),
    ("ln-S197", 4, 197, 768, 12, False, False),
    ("ln-S197", 256, 197, 768, 12, False, True),
    ("ln-S257", 2, 257, 1024, 16, False, True),
    ("ln-S320", 2, 320, 768, 12, False, True),
    ("ln-S320", 2, 320, 768, 12, True, True),
]
FUSED_CASES = [  # (case, batch, seq, heads, head_dim, causal)
    ("fused-S128", 2, 128, 8, 32, False),
    ("fused-S128", 2, 128, 8, 32, True),
    ("fused-S197", 4, 197, 12, 64, False),
    ("fused-S197", 4, 197, 12, 64, True),
    ("fused-S197", 256, 197, 12, 64, False),
    ("fused-S512", 2, 512, 4, 128, False),
    ("fused-S512", 2, 512, 4, 128, True),
]
MLP_CASES = [  # (case, batch, seq, width, hidden, act); T = batch * seq token rows
    ("mlp-B32-vision", 256, 50, 768, 3072, "quick_gelu"),
    ("mlp-B32-text", 256, 77, 512, 2048, "quick_gelu"),
    ("mlp-B16-vision", 256, 197, 768, 3072, "quick_gelu"),
    ("mlp-L14", 64, 257, 1024, 4096, "gelu"),
    ("mlp-ragged", 3, 197, 768, 3072, "quick_gelu"),
]
TRAIN_BATCH = 256
TRAIN_STEPS = 6  # every train run: the first step warms up, the five after it are timed
SHARED_COMPARE_BATCH = 64  # both paths hold it in float32; the plain path does not hold 256
CAPTIONS = ["a photo of a cat", "two dogs playing in the snow", "a red car on a bridge",
            "東京の夜景 ✨"]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): CUDA-core float32 for
# float32 (the port's float32 is true float32), tensor-core bf16 for bfloat16; HBM3 bytes/s
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(flops: float, nbytes: float, dtype_name: str) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: the operations over
    the peak rate for the dtype, or each input read once and each output written once over
    the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attention_pairs(s: int, causal: bool) -> float:
    """(query, key) pairs one head's attention needs: all of them, or the lower triangle."""
    return s * (s + 1) / 2 if causal else s * s


def block_bound(kernel: str, b, s, w, heads, causal, dtype_name: str):
    """Work of the TPU kernels' definition at this shape. Forward: four [B*S,W]x[W,W]
    projections and the core's two products. Backward: seven projection-sized products (q,
    k, v recomputed, do, and dx over K=3W) and six core products (logits, attnpre, dv, dp,
    dq, dk). Bytes: x [, dy], the outputs, the weights and biases [, gamma, beta, ln_out,
    dgamma and dbeta in float32]."""
    e = 4 if dtype_name == "float32" else 2
    m, pairs = b * s, b * heads * attention_pairs(s, causal) * (w // heads)
    ln = "_ln_" in kernel
    if kernel.endswith("fwd"):
        flops = 8 * m * w * w + 4 * pairs
        nbytes = e * (2 * m * w + 4 * w * w + 4 * w + (2 * w if ln else 0))
    else:
        flops = 14 * m * w * w + 12 * pairs
        nbytes = e * (7 * m * w + 4 * w * w + 4 * w + ((m * w + 2 * w) if ln else 0))
        nbytes += 8 * w if ln else 0
    return bound(flops, nbytes, dtype_name)


def fused_bound(kernel: str, b, s, heads, d, causal, dtype_name: str):
    """Forward: two products over q, k, v, out. Backward: five products (logits, dv, dp,
    dq, dk) over q, k, v, do, dq, dk, dv."""
    e = 4 if dtype_name == "float32" else 2
    pairs = b * heads * attention_pairs(s, causal) * d
    if kernel.endswith("fwd"):
        return bound(4 * pairs, e * 4 * b * s * heads * d, dtype_name)
    return bound(10 * pairs, e * 7 * b * s * heads * d, dtype_name)


def mlp_bound(kernel: str, t, w, hid, dtype_name: str):
    """Work of the TPU kernels' definition: two [T,W]x[W,H]-sized products forward, four
    backward. Bytes forward: x, y, h and the parameters; backward: x, dy, h, dx, both weights
    and both weight gradients, and the four vector sums in float32."""
    e = 4 if dtype_name == "float32" else 2
    if kernel.endswith("fwd"):
        return bound(4 * t * w * hid, e * (2 * t * w + t * hid + 2 * w * hid + hid + 3 * w),
                     dtype_name)
    nbytes = e * (3 * t * w + t * hid + 4 * w * hid + 2 * w) + 4 * (hid + 3 * w)
    return bound(8 * t * w * hid, nbytes, dtype_name)


def kernel_cases(torch, ba, fa, bm, dtype):
    """Every (kernel, case, shape text, timed, run kernel, run plain, library, other timed
    runs by name, output names, bound) of phase 3 for one dtype, built lazily: each case
    frees its tensors before the next is made. ``library`` is None or (run, view): one
    PyTorch call computing the same function on the same tensors, timed as ``library_ms``
    and used nowhere in the port, and the view of its result that has the layout of the
    plain version's first output."""
    import torch.nn.functional as F

    name = str(dtype).replace("torch.", "")

    def block_inputs(b, s, w):
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
        x = rnd(b, s, w).to(dtype)
        ws = []
        for _ in range(4):
            ws += [(rnd(w, w) * w ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)]
        dy = rnd(b, s, w).to(dtype)
        gamma, beta = (1 + 0.1 * rnd(w)).to(dtype), (0.1 * rnd(w)).to(dtype)
        return x, ws, dy, gamma, beta

    def mha(x, ws, heads, causal):
        """The library yardstick of the non-LN block kernels: torch's multi-head attention
        with separate q/k/v weights on views of the same tensors (sequence-first input,
        [out, in] weights); returns [B, S, W]."""
        wq, bq, wk, bk, wv, bv, wo, bo = ws
        s, w = x.shape[1], x.shape[2]
        xt = x.transpose(0, 1)
        mask = torch.ones(s, s, dtype=torch.bool, device="cuda").triu(1) if causal else None
        return F.multi_head_attention_forward(
            xt, xt, xt, w, heads, None, torch.cat([bq, bk, bv]), None, None, False, 0.0,
            wo.t(), bo, need_weights=False, attn_mask=mask, is_causal=causal,
            use_separate_proj_weight=True, q_proj_weight=wq.t(), k_proj_weight=wk.t(),
            v_proj_weight=wv.t())[0].transpose(0, 1)

    for case, b, s, w, heads, causal in BLOCK_CASES:
        x, ws, dy, _, _ = block_inputs(b, s, w)
        kw = dict(heads=heads, causal=causal)
        shape = f"B={b:<3} S={s} W={w} H={heads} causal={causal!s:<5}"
        # the library's backward is timed on a graph built once; like the kernel it gives
        # the gradient of x (the weight gradients are outside the kernel and outside this)
        x_leaf = x.detach().requires_grad_()
        mha_out = mha(x_leaf, ws, heads, causal)
        yield ("block_attention_fwd", case, shape, b == 256,
               lambda: ba.block_attention(x, *ws, **kw),
               lambda: ba.block_attention_reference(x, *ws, **kw),
               (lambda: mha(x, ws, heads, causal), lambda y: y), {}, ("y",),
               block_bound("block_attention_fwd", b, s, w, heads, causal, name))
        yield ("block_attention_bwd", case, shape, b == 256,
               lambda: ba.block_attention_bwd(x, dy, *ws, **kw),
               lambda: ba.block_attention_bwd_reference(x, dy, *ws, **kw),
               (lambda: torch.autograd.grad(mha_out, [x_leaf], dy, retain_graph=True),
                lambda grads: grads[0]), {},
               ("dx", "dq", "dk", "dv", "attnpre"),
               block_bound("block_attention_bwd", b, s, w, heads, causal, name))
    for case, b, s, w, heads, causal, residual in LN_CASES:
        x, ws, dy, gamma, beta = block_inputs(b, s, w)
        kw = dict(heads=heads, causal=causal, residual=residual)
        shape = f"B={b:<3} S={s} W={w} H={heads} causal={causal!s:<5} residual={residual!s:<5}"
        # beside the fold, what it replaces: ln_rows, the non-LN kernel and the add as three
        # steps (the S<=128 dispatch), to show what the fold buys on this card. No library
        # call: no single PyTorch call holds the LayerNorm, the attention block and the add
        yield ("block_attention_ln_fwd", case, shape, b == 256,
               lambda: ba.block_attention_ln(x, gamma, beta, *ws, **kw),
               lambda: ba.block_attention_ln_reference(x, gamma, beta, *ws, **kw), None,
               {"unfolded_ms": lambda: x + ba.block_attention(
                   ba.ln_rows(x, gamma, beta, ba.LN_EPS), *ws, heads=heads, causal=causal)},
               ("y",), block_bound("block_attention_ln_fwd", b, s, w, heads, causal, name))
        yield ("block_attention_ln_bwd", case, shape, b == 256,
               lambda: ba.block_attention_ln_bwd(x, dy, gamma, beta, *ws, **kw),
               lambda: ba.block_attention_ln_bwd_reference(x, dy, gamma, beta, *ws, **kw),
               None, {}, ("dx", "dq", "dk", "dv", "attnpre", "ln_out", "dgamma", "dbeta"),
               block_bound("block_attention_ln_bwd", b, s, w, heads, causal, name))
    for case, b, s, heads, d, causal in FUSED_CASES:
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
        q, k, v, do = (torch.randn(b, s, heads * d, generator=g, device="cuda").to(dtype)
                       for _ in range(4))
        kw = dict(heads=heads, causal=causal)
        shape = f"B={b:<3} S={s} H={heads} D={d} causal={causal!s:<5}"
        # the library yardstick: one scaled_dot_product_attention call on the same tensors
        # (head-major views of them); its backward is timed on a graph built once
        packed = lambda t: t.transpose(1, 2).reshape(b, s, heads * d)  # noqa: E731
        qh, kh, vh, doh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v, do))
        leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
        yield ("fused_attention_fwd", case, shape, b == 256,
               lambda: fa.fused_attention(q, k, v, **kw),
               lambda: fa.fused_attention_reference(q, k, v, **kw),
               (lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal), packed),
               {}, ("out",),
               fused_bound("fused_attention_fwd", b, s, heads, d, causal, name))
        yield ("fused_attention_bwd", case, shape, b == 256,
               lambda: fa.fused_attention_bwd(q, k, v, do, **kw),
               lambda: fa.fused_attention_bwd_reference(q, k, v, do, **kw),
               (lambda: torch.autograd.grad(sdpa_out, leaves, doh, retain_graph=True),
                lambda grads: packed(grads[0])), {},
               ("dq", "dk", "dv"),
               fused_bound("fused_attention_bwd", b, s, heads, d, causal, name))
    for case, b, s, w, hid, act in MLP_CASES:
        t = b * s
        g = torch.Generator(device="cuda").manual_seed(t + hid)
        rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
        x, dy = rnd(t, w).to(dtype), rnd(t, w).to(dtype)
        w1, b1 = (rnd(w, hid) * w ** -0.5).to(dtype), (rnd(hid) * 0.02).to(dtype)
        w2, b2 = (rnd(hid, w) * hid ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)
        gamma, beta = 1 + 0.1 * rnd(w), 0.1 * rnd(w)  # float32, as the blocks hand them in
        h = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act)[1]
        # no library call: no single PyTorch call holds the LayerNorm, both products, the
        # activation and the add. Timed with the residual; the branch alone is compared only
        for residual in (True, False):
            timed = residual and case != "mlp-ragged"
            kw = dict(act=act, residual=residual)
            shape = f"T={b}x{s} W={w} H={hid} act={act} residual={residual!s:<5}"
            yield ("block_mlp_fwd", case, shape, timed,
                   lambda: bm.block_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, **kw),
                   lambda: bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, **kw),
                   None, {}, ("y", "h"), mlp_bound("block_mlp_fwd", t, w, hid, name))
            yield ("block_mlp_bwd", case, shape, timed,
                   lambda: bm.block_mlp_bwd(x, dy, h, gamma, beta, w1, w2, **kw),
                   lambda: bm.block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2, **kw),
                   None, {}, ("dx", "dW1", "dW2", "db1", "db2", "dgamma", "dbeta"),
                   mlp_bound("block_mlp_bwd", t, w, hid, name))


def phase_kernels(torch, ba, fa, bm) -> dict:
    """Every kernel vs plain at every case and both dtypes; times at B=256 (ViT-L/14's MLP
    shape at B=64). The library
    call, where there is one, is held to the plain version's first output too, at a wider
    limit (1e-3 and 5e-2 x max|plain|: it rounds at other points and sums in another
    order), so that its time is the time of the same function."""
    worst_f32 = dict.fromkeys(KERNELS, 0.0)
    timing, failures = {}, []
    for dtype, rel_tol, lib_tol in ((torch.float32, 1e-4, 1e-3), (torch.bfloat16, 2e-2, 5e-2)):
        name = str(dtype).replace("torch.", "")
        for (kernel, case, shape, timed, kern, plain, library, others, outputs,
             (b_ms, b_by)) in kernel_cases(torch, ba, fa, bm, dtype):
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            errs, ok = [], len(got) == len(want) == len(outputs)
            for gt, wt in zip(got, want):
                gt, wt = gt.float(), wt.float()
                err, ref_max = (gt - wt).abs().max().item(), wt.abs().max().item()
                ok = ok and bool(torch.isfinite(gt).all()) and err <= rel_tol * ref_max
                errs.append((err, ref_max))
            err = max(e for e, _ in errs)
            detail = " ".join(f"{o}={e:.2e}/{m:.2e}" for o, (e, m) in zip(outputs, errs))
            line = (f"{kernel} {case:<11} {shape} {name:<8} max_abs_err/max|plain| {detail} "
                    f"(tol {rel_tol:g} x max|plain|) {'ok' if ok else 'MISMATCH'}")
            if library is not None:
                lib_run, lib_view = library
                lib_err = (lib_view(lib_run()).float() - want[0].float()).abs().max().item()
                lib_ok = lib_err <= lib_tol * errs[0][1]
                ok = ok and lib_ok
                line += f" library_err={lib_err:.2e}{'' if lib_ok else ' LIBRARY MISMATCH'}"
            del got, want
            if timed:
                iters = 20 if "S197" not in case and not case.startswith("mlp") else 8
                k_ms, p_ms = cuda_ms(kern, iters), cuda_ms(plain, iters)
                other_ms = {k: cuda_ms(fn, iters) for k, fn in others.items()}
                if library is not None:
                    other_ms["library_ms"] = cuda_ms(library[0], iters)
                timing[(kernel, case, name)] = {
                    "ms": k_ms, "plain_ms": p_ms, "library_ms": other_ms.get("library_ms"),
                    "bound_ms": b_ms, "bound_by": b_by}
                line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
                         f"({b_by})" + "".join(f" {k}={v:.4f}" for k, v in other_ms.items()))
            print(line, flush=True)
            if not ok:
                failures.append(line)
            if dtype == torch.float32:
                worst_f32[kernel] = max(worst_f32[kernel], err)
        torch.cuda.empty_cache()
    if failures:
        fail(f"{len(failures)} kernel/plain mismatches")
    return {"worst_f32": worst_f32, "timing": timing}


def post(url: str, payload: dict) -> tuple[int, dict]:
    req = urllib.request.Request(url, json.dumps(payload).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def check_embeddings(name: str, emb, n: int, dim: int):
    emb = np.asarray(emb, np.float32)
    if emb.shape != (n, dim) or not np.isfinite(emb).all():
        fail(f"{name}: shape {emb.shape} (want ({n}, {dim})) or non-finite values")
    norms = np.linalg.norm(emb, axis=-1)
    if np.abs(norms - 1).max() > 1e-4:
        fail(f"{name}: embeddings not unit norm ({norms})")
    return emb


@contextlib.contextmanager
def plain_attention(mods):
    """Every kernel call of the model routed to its plain version (the gradient then comes
    from torch's autograd of that version): the block operator in both its forms, and the
    fused operator behind ``attention()``, and the fused MLP operator."""
    ba, fa, bm = mods["ba"], mods["fa"], mods["bm"]
    layers, attention = mods["layers"], mods["attention"]

    def plain_block_attention(x, *ws, heads, causal=False, ln_scale=None, ln_bias=None,
                              residual=False):
        xn = ba.ln_rows(x, ln_scale, ln_bias, ba.LN_EPS) if ln_scale is not None else x
        out = ba.block_attention_reference(xn, *ws, heads=heads, causal=causal)
        return x + out if residual else out

    def plain_block_mlp(x, w1, b1, w2, b2, *, ln_scale, ln_bias, act="quick_gelu",
                        residual=True):
        y, _ = bm.block_mlp_reference(x.reshape(-1, x.shape[-1]), ln_scale, ln_bias, w1, b1, w2,
                                      b2, act=act, residual=residual)
        return y.reshape(x.shape)

    kernel_paths = layers.block_attention, attention.fused_attention, layers.block_mlp
    layers.block_attention = plain_block_attention
    attention.fused_attention = fa.fused_attention_reference
    layers.block_mlp = plain_block_mlp
    try:
        yield
    finally:
        layers.block_attention, attention.fused_attention, layers.block_mlp = kernel_paths


class Tally:
    """Kernel launches of the main-path runs: each run sets every count to 0 just before it
    and reads the counts just after; comparison launches never pass through here."""

    def __init__(self, launches):
        self.launches, self.total = launches, dict.fromkeys(KERNELS, 0)

    def start(self):
        self.launches.reset_launch_counts()

    def stop(self) -> dict:
        counts = self.launches.launch_counts()
        for k in self.total:
            self.total[k] += counts[k]
        return counts


def phase_serving(torch, mods, tally, card, kind, model_name, need_text, need_image,
                  block_mlp=False):
    """Serve ``model_name`` (float32, seeded weights) over HTTP; check the answers, the
    launch counts (``need_*``: kernel -> launches per tower encode) and the agreement with
    the plain-version encode; then throughput at bucket 256 and single-request latency."""
    from multimodal_tpu_torch.data.tokenizer import tokenize
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.serving import EmbeddingService, make_server

    t0 = time.perf_counter()
    model = create_model(model_name, seed=0, block_mlp=block_mlp)
    dim, size = model.cfg.embed_dim, model.cfg.vision.image_size
    svc = EmbeddingService(model, max_batch=256, max_wait_ms=5.0)
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    model_name += " block_mlp" if block_mlp else ""
    print(f"  model {model_name} float32 on {kind} built and served in "
          f"{time.perf_counter() - t0:.2f} s at {url}", flush=True)
    try:
        images = np.random.default_rng(0).integers(0, 256, (3, size, size, 3), dtype=np.uint8)
        images_u8 = [base64.b64encode(a.tobytes()).decode() for a in images]
        tally.start()
        code_t, text = post(url + "/v1/embed/text", {"texts": CAPTIONS})
        code_i, image = post(url + "/v1/embed/image", {"images_u8": images_u8})
        code_s, sim = post(url + "/v1/similarity", {"texts": CAPTIONS, "images_u8": images_u8})
        counts = tally.stop()
        health, stats = get(url + "/healthz"), get(url + "/v1/stats")
        if (code_t, code_i, code_s) != (200, 200, 200):
            fail(f"HTTP status text={code_t} image={code_i} similarity={code_s}: "
                 f"{text.get('error')} {image.get('error')} {sim.get('error')}")
        txt = check_embeddings("text", text["embeddings"], len(CAPTIONS), dim)
        img = check_embeddings("image", image["embeddings"], len(images), dim)
        sims = np.asarray(sim["similarity"], np.float32)
        if sims.shape != (3, len(CAPTIONS)) or np.abs(sims - img @ txt.T).max() > 1e-4:
            fail(f"similarity {sims.shape} disagrees with the embedded rows")
        n_text, n_image = stats["text"]["batches"], stats["image"]["batches"]
        print(f"  healthz {health}", flush=True)
        print(f"  stats text={stats['text']} image={stats['image']}", flush=True)
        need = dict.fromkeys(KERNELS, 0)
        for per_encode, n in ((need_text, n_text), (need_image, n_image)):
            for k, per in per_encode.items():
                need[k] += per * n
        need = {k: v for k, v in need.items() if v}
        print(f"  launches during serving: { {k: counts[k] for k in need} } over {n_text} text "
              f"and {n_image} image tower encodes (need >= {need})", flush=True)
        if n_text < 2 or n_image < 2 or any(counts[k] < v for k, v in need.items()):
            fail("the serving path did not run its kernel in every block")
        tokens = tokenize(CAPTIONS, model.cfg.text.context_length)
        with plain_attention(mods):
            p_txt = svc._embedder.encode_tokens(tokens)
            p_img = svc._embedder.encode_images(images)
        cos_t = float((np.sum(p_txt * txt, -1)).min())
        cos_i = float((np.sum(p_img * img, -1)).min())
        print(f"  served vs plain-version encode: min cosine text={cos_t:.7f} "
              f"image={cos_i:.7f} (need >= 0.9999)", flush=True)
        if min(cos_t, cos_i) < 0.9999:
            fail("served embeddings disagree with the plain-version encode")

        print(f"  throughput ({model_name})", flush=True)
        emb = svc._embedder
        rng = np.random.default_rng(1)
        batch_img = rng.integers(0, 256, (256, size, size, 3), dtype=np.uint8)
        batch_tok = np.repeat(tokens, 64, axis=0)
        for name, fn, arg in (("image", emb.encode_images, batch_img),
                              ("text", emb.encode_tokens, batch_tok)):
            fn(arg)
            t0 = time.perf_counter()
            for _ in range(5):
                fn(arg)
            rate = 5 * 256 / (time.perf_counter() - t0)
            print(f"  {model_name} {name} encodes/s at bucket 256 (float32, host clock incl. "
                  f"transfer): {rate:.1f} [{card}]", flush=True)
        for name, route, payload in (("text", "/v1/embed/text", {"texts": CAPTIONS[:1]}),
                                     ("image", "/v1/embed/image",
                                      {"images_u8": images_u8[:1]})):
            lat = []
            for _ in range(21):
                t0 = time.perf_counter()
                code, _ = post(url + route, payload)
                lat.append((time.perf_counter() - t0) * 1e3)
                if code != 200:
                    fail(f"latency probe {route} returned {code}")
            print(f"  {model_name} single-request {name} p50 latency: "
                  f"{float(np.median(lat[1:])):.2f} ms [{card}]", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        svc.close()
        thread.join(timeout=10)
    del model, svc
    torch.cuda.empty_cache()


def make_batch(torch, cfg, n: int) -> dict:
    """The synthetic uint8 batch of bench.py, normalized on the card by the step."""
    rng = np.random.default_rng(0)
    size = cfg.vision.image_size
    return {
        "image": torch.from_numpy(rng.integers(0, 256, (n, size, size, 3),
                                               dtype=np.uint8)).cuda(),
        "text": torch.from_numpy(rng.integers(1, cfg.text.vocab_size - 1,
                                              (n, cfg.text.context_length))).cuda(),
    }


def train_steps(torch, tally, model, batch, steps: int, grads_at: int = -1, count=True):
    """``steps`` training steps from a fresh optimizer as bench.py builds it; returns the
    per-step metrics and launch counts, the gradients after step ``grads_at`` (0-based),
    the host-clock seconds of every step after the first and the peak device memory."""
    from multimodal_tpu_torch.train import (
        TrainState, make_optimizer, make_schedule, make_train_step)

    opt = make_optimizer(model.named_parameters(),
                         make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000),
                         weight_decay=0.1, grad_clip_norm=1.0)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt)
    metrics, counts, grads, timed = [], [], None, 0.0
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        torch.cuda.synchronize()
        tally.start()
        t0 = time.perf_counter()
        m = step(state, batch)
        torch.cuda.synchronize()
        if i > 0:
            timed += time.perf_counter() - t0
        # the plain path's counts are read but kept out of the main-path tally
        counts.append(tally.stop() if count else tally.launches.launch_counts())
        metrics.append({k: float(v) for k, v in m.items()})
        if i == grads_at:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    return metrics, counts, grads, timed, torch.cuda.max_memory_allocated()


def check_launches(counts, need: dict, what: str):
    """Every step of ``counts`` ran each kernel of ``need`` just that often, and no kernel
    outside it."""
    for cnt in counts:
        if {k: v for k, v in cnt.items() if v} != need:
            fail(f"{what}: launches per step {cnt}, need {need} and nothing else")


def compare_paths(torch, mods, tally, card, model_name, n, steps, need,
                  block_mlp=False) -> tuple[int, int]:
    """float32: ``steps`` steps through the kernels against the same from the same start
    with every kernel call routed to its plain version. Returns the kernel path's peak
    memory and the model's parameter count."""
    from multimodal_tpu_torch.models import create_model

    model = create_model(model_name, seed=0, block_mlp=block_mlp)
    model_name += " block_mlp" if block_mlp else ""
    batch = make_batch(torch, model.cfg, n)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    k_metrics, k_counts, k_grads, k_time, k_peak = train_steps(torch, tally, model, batch,
                                                               steps, grads_at=0)
    model.load_state_dict(start)
    with plain_attention(mods):
        p_metrics, p_counts, p_grads, p_time, p_peak = train_steps(
            torch, tally, model, batch, steps, grads_at=0, count=False)
    for i in range(2):
        km, pm = k_metrics[i], p_metrics[i]
        print(f"  float32 step {i + 1}: loss kernel={km['loss']:.7f} plain={pm['loss']:.7f} "
              f"grad_norm kernel={km['grad_norm']:.6f} plain={pm['grad_norm']:.6f} "
              f"launches { {k: v for k, v in k_counts[i].items() if v} }", flush=True)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    loss_rel = max(rel(k_metrics[i]["loss"], p_metrics[i]["loss"]) for i in range(2))
    norm_rel = max(rel(k_metrics[i]["grad_norm"], p_metrics[i]["grad_norm"]) for i in range(2))
    # per leaf |kernel - plain| / max|plain|; a leaf whose exact gradient is zero (the
    # attention key biases: softmax ignores a per-row constant) holds rounding noise on both
    # sides, so the scale has a floor of 1e-3 x the largest gradient of the model
    g_max = max(g.abs().max() for g in p_grads.values())
    leaf_rel = {n_: ((k_grads[n_] - g).abs().max() / torch.clamp(g.abs().max(), min=1e-3 * g_max))
                for n_, g in p_grads.items()}
    leaf_rel = {n_: v.item() for n_, v in leaf_rel.items()}
    worst_leaf = max(leaf_rel, key=leaf_rel.get)
    print(f"  float32 kernel vs plain: loss rel diff {loss_rel:.3e} (need <= 1e-5), grad norm "
          f"rel diff {norm_rel:.3e} (need <= 1e-4), worst grad leaf {worst_leaf} "
          f"{leaf_rel[worst_leaf]:.3e} x max|leaf| (need <= 1e-3); launches per step need "
          f"{need}", flush=True)
    if not all(np.isfinite([m[k] for m in k_metrics + p_metrics for k in m])):
        fail("non-finite float32 loss or grad norm")
    if loss_rel > 1e-5 or norm_rel > 1e-4 or leaf_rel[worst_leaf] > 1e-3:
        fail("the float32 kernel path disagrees with the plain path")
    check_launches(k_counts, need, f"{model_name} float32 kernel path")
    check_launches(p_counts, {}, f"{model_name} float32 plain path")
    k_rate, p_rate = (steps - 1) * n / k_time, (steps - 1) * n / p_time
    print(f"  {model_name} float32 train samples/s at B={n} (steps 2-{steps}, host clock): "
          f"kernel path {k_rate:.1f}, plain path {p_rate:.1f}; peak memory kernel "
          f"{k_peak / 2**30:.2f} GiB, plain {p_peak / 2**30:.2f} GiB [{card}]", flush=True)
    return k_peak, sum(p.numel() for p in model.parameters())


def kernel_path_run(torch, tally, card, model_name, dtype, n, steps, need, falling=False,
                    block_mlp=False) -> list:
    """``steps`` steps on the kernel path alone: finite (and with ``falling`` a loss that
    falls on the fixed batch), the launch counts, samples/s and peak memory. Returns the
    losses."""
    from multimodal_tpu_torch.models import create_model

    name = str(dtype).replace("torch.", "")
    model = create_model(model_name, dtype=dtype, seed=0, block_mlp=block_mlp)
    model_name += " block_mlp" if block_mlp else ""
    batch = make_batch(torch, model.cfg, n)
    metrics, counts, _, timed, peak = train_steps(torch, tally, model, batch, steps)
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    print(f"  {name} losses {[round(v, 7) for v in losses]} grad norms "
          f"{[round(v, 4) for v in norms]}", flush=True)
    print(f"  {model_name} {name} train samples/s at B={n} (steps 2-{steps}, host clock): "
          f"{(steps - 1) * n / timed:.1f}; peak memory {peak / 2**30:.2f} GiB [{card}]",
          flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"non-finite {name} loss or grad norm")
    if falling and not losses[-1] < losses[0]:
        fail(f"the {name} loss did not fall over {steps} steps on a fixed batch")
    check_launches(counts, need, f"{model_name} {name} kernel path")
    del model, batch
    torch.cuda.empty_cache()
    return losses


def largest_batch(torch, peak_at_compare: int, n_params: int) -> int:
    """The largest of 64/128/256 the float32 kernel path holds, reckoned before running it:
    parameters, gradients and two moments stay (16 bytes a parameter); what the measured
    peak at the comparison batch holds beyond them grows with the batch; 15% to spare."""
    static = 16 * n_params
    per_sample = (peak_at_compare - static) / SHARED_COMPARE_BATCH
    total = torch.cuda.mem_get_info()[1]
    fits = [b for b in (64, 128, 256) if static + 1.15 * per_sample * b <= total]
    print(f"  reckoned: {static / 2**30:.2f} GiB static + {per_sample / 2**20:.1f} MiB per sample "
          f"(from the measured peak at B={SHARED_COMPARE_BATCH}) against {total / 2**30:.1f} GiB "
          f"-> {({b: round((static + per_sample * b) / 2**30, 1) for b in (64, 128, 256)})} GiB; "
          f"largest batch with 15% to spare: {max(fits)}", flush=True)
    return max(fits)


def register_variant(name: str, base: str, vision: dict | None = None, **top):
    """Register config ``name``: the shipped config ``base`` with ``top`` set at its top level
    and ``vision`` in its vision tower."""
    from multimodal_tpu_torch import paths
    from multimodal_tpu_torch.models import add_model_config

    with open(os.path.join(paths.CONFIG_DIR, base + ".json")) as f:
        cfg = json.load(f)
    cfg.update(top)
    cfg["vision_cfg"].update(vision or {})
    add_model_config(name, cfg)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    kind = torch.cuda.get_device_name(0)
    print(f"phase 1 card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"devices {torch.cuda.device_count()}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmuls are enabled; the float32 references must be true float32")

    from multimodal_tpu_torch.models import layers
    from multimodal_tpu_torch.ops import _build, attention, launches
    from multimodal_tpu_torch.ops import block_attention as ba
    from multimodal_tpu_torch.ops import block_mlp as bm
    from multimodal_tpu_torch.ops import fused_attention as fa

    mods = {"ba": ba, "fa": fa, "bm": bm, "layers": layers, "attention": attention}
    tally = Tally(launches)

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> {lib_path}", flush=True)
    for ln in ptxas:
        print(f"  ptxas {ln}")

    print("phase 3 kernel vs plain on the card", flush=True)
    kernels = phase_kernels(torch, ba, fa, bm)

    print("phase 4 serving, phase 5 throughput", flush=True)
    phase_serving(torch, mods, tally, card, kind, MODEL,
                  need_text={"block_attention_fwd": 12}, need_image={"block_attention_fwd": 12})

    print("phase 6 training", flush=True)
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, need)
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS, need,
                    falling=True)

    print(f"phase 7 shared trunk: {SHARED_MODEL} at full width", flush=True)
    phase_serving(torch, mods, tally, card, kind, SHARED_MODEL,
                  need_text={"block_attention_fwd": 12},
                  need_image={"block_attention_ln_fwd": 12})
    need = {"block_attention_ln_fwd": 12, "block_attention_ln_bwd": 12,
            "block_attention_fwd": 12, "block_attention_bwd": 12}
    peak, n_params = compare_paths(torch, mods, tally, card, SHARED_MODEL, SHARED_COMPARE_BATCH,
                                   TRAIN_STEPS, need)
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, peak, n_params)
    if rate_batch != SHARED_COMPARE_BATCH:
        kernel_path_run(torch, tally, card, SHARED_MODEL, torch.float32, rate_batch,
                        TRAIN_STEPS, need)
    kernel_path_run(torch, tally, card, SHARED_MODEL, torch.bfloat16, rate_batch, TRAIN_STEPS,
                    need, falling=True)

    # the same model with head scales: the vision pass (S=197) goes through attention() to
    # the fused pair; the text pass (S=77) is below the fused window and runs the plain path
    register_variant(SCALE_HEADS_MODEL, SHARED_MODEL, vision={"scale_heads": True})
    print(f"  {SCALE_HEADS_MODEL}: {SHARED_MODEL} with vision.scale_heads", flush=True)
    need = {"fused_attention_fwd": 12, "fused_attention_bwd": 12}
    compare_paths(torch, mods, tally, card, SCALE_HEADS_MODEL, SHARED_COMPARE_BATCH,
                  TRAIN_STEPS, need)
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, SCALE_HEADS_MODEL, torch.bfloat16, SHARED_COMPARE_BATCH,
                    TRAIN_STEPS, need, falling=True)

    print(f"phase 8 fused MLP branch: {SHARED_MODEL} at full width with block_mlp=True",
          flush=True)
    attn_need = {"block_attention_ln_fwd": 12, "block_attention_ln_bwd": 12,
                 "block_attention_fwd": 12, "block_attention_bwd": 12}
    phase_serving(torch, mods, tally, card, kind, SHARED_MODEL,
                  need_text={"block_attention_fwd": 12, "block_mlp_fwd": 12},
                  need_image={"block_attention_ln_fwd": 12, "block_mlp_fwd": 12},
                  block_mlp=True)
    need = {**attn_need, "block_mlp_fwd": 24, "block_mlp_bwd": 24}
    peak, n_params = compare_paths(torch, mods, tally, card, SHARED_MODEL, SHARED_COMPARE_BATCH,
                                   TRAIN_STEPS, need, block_mlp=True)
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, peak, n_params)
    losses = kernel_path_run(torch, tally, card, SHARED_MODEL, torch.float32, rate_batch,
                             TRAIN_STEPS, need, block_mlp=True)
    kernel_path_run(torch, tally, card, SHARED_MODEL, torch.bfloat16, rate_batch, TRAIN_STEPS,
                    need, falling=True, block_mlp=True)
    # per-block remat: every forward kernel runs again inside the backward, and nothing else
    # changes, so the losses repeat those of the run above
    register_variant(REMAT_MODEL, SHARED_MODEL, remat=True)
    print(f"  {REMAT_MODEL}: {SHARED_MODEL} with remat", flush=True)
    remat_need = {k: v * (2 if k.endswith("fwd") else 1) for k, v in need.items()}
    remat_losses = kernel_path_run(torch, tally, card, REMAT_MODEL, torch.float32, rate_batch,
                                   TRAIN_STEPS, remat_need, block_mlp=True)
    remat_rel = max(abs(a - b) / abs(b) for a, b in zip(remat_losses[:2], losses[:2]))
    print(f"  remat vs no remat at B={rate_batch}: loss rel diff over the first 2 steps "
          f"{remat_rel:.3e} (need <= 1e-6); launches per step {remat_need}", flush=True)
    if remat_rel > 1e-6:
        fail("the remat run's losses differ from the run without remat")

    entries = []
    for name, (source, replaces, case) in KERNELS.items():
        if tally.total[name] == 0:
            fail(f"the main path never launched {name}")
        entries.append({"name": name, "route": "cuda", "source": source, "replaces": replaces,
                        "launches": tally.total[name],
                        "max_abs_err": kernels["worst_f32"][name],
                        **kernels["timing"][(name, case, "float32")]})
    print(card, flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
