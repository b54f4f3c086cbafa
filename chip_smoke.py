#!/usr/bin/env python3
"""Drive the PyTorch port's serving path and its training step once on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero before the result lines):
  1. the card: torch.cuda.is_available() and nvidia-smi's name and power limit;
  2. build the CUDA kernels from ops/csrc with nvcc (one process per source, in parallel);
     print every kernel's registers and spills (ptxas), the attention passes' shared memory,
     and from the SASS the passes' HMMA / LDSM / LDGSTS counts and the tensor-core
     instructions by form of each flash kernel and of every instantiation of the projection
     GEMM (mma_gemm_kernel<T, TOut, form, load, store>: the block forward's and backward's,
     the MLP's c_fc, c_proj, dh, dln and weight gradients; HMMA.16816.F32.BF16 in bfloat16,
     HMMA.1688.F32.TF32 for float32's 3xTF32; a GEMM instantiation with no HMMA or another
     form fails);
  3. every kernel against its plain PyTorch version on the card, every output, in float32
     (max abs error <= 1e-4 * max|plain|) and bfloat16 (<= 2e-2 * max|plain|), with
     CUDA-event times at B=256: the block-attention forward and backward at the ViT-B/32
     tower shapes (vision S=50 W=768 H=12, text S=77 W=512 H=8 causal), the shared trunk's
     text pass (S=77 W=768 H=12 causal), S=197 and S=257 (W=1024 H=16), with torch's
     multi_head_attention_forward timed beside them; their LN-fold forms (LayerNorm and residual inside the kernel; also
     ln_out, dgamma and dbeta) at S=145 (ViT-B/32's vision tower at 384 px, timed at B=256),
     S=197, S=257 and S=320, causal and not; both forms at the
     head dims 80 and 88 (S=257, W=1280 and 1408), whose last k-step of 16 is zero-padded; the
     fused whole-sequence attention pair at S=128, 197, 257 and 512 with D=32, 64 and 128 and
     at S=129 and 191 (one past and one short of a 64-row tile edge), causal and not, with
     torch's scaled_dot_product_attention timed beside it and a second launch of the timed
     case compared bit for bit with the first; the fused MLP branch
     (LayerNorm, c_fc, activation, c_proj, residual) forward and backward, with and without
     the residual, at the ViT-B/32, ViT-B/16 and ViT-L/14 token counts and widths (c_proj's
     float32 sums run K = H = 2048-4096 long) and a ragged T=3x197 (outputs y, h and dx, dW1,
     dW2, db1, db2, dgamma, dbeta; no library call holds it, and the same two or four
     products as plain torch.matmul calls are timed beside it as information); the
     flash-attention trio (forward with lse, dQ, dK/dV) at S=2048 (B=1, the timed
     B=8 and the text tower's own call at B=32) and S=4096 causal, S=1024 and S=2048 not
     causal, a ragged S=2050, sq != sk causal, D=32, 80, 88 and 128, with
     scaled_dot_product_attention(is_causal=True) forward and backward timed beside it; each
     timed line with its TFLOP/s and share of its bound (the float32 kernels that run
     3xTF32, the flash trio, the block pair in both forms and the MLP pair, at the 3xTF32
     ceiling, 495 / 3 TFLOP/s, and at the CUDA cores' 67 beside it), the timed flash and
     fused kernels and every block and MLP case launched twice and compared bit for bit,
     every output; the block backward's recomputed q, k, v compared bit for bit with the
     forward's, both forms and dtypes; the float32 flash forward at S=8192; then the flash
     operator against the plain attention path, forward plus backward, time and peak memory at
     S=1024, 2048 and 4096, causal and not (the dispatch's crossover). The library calls are
     yardsticks, held to the plain versions too and used nowhere in the port. Then the int8
     kernels (ops/csrc/quant.cu) at ViT-B/32's int8 shapes at B=256, float32 and bfloat16
     activations: the row quantize (activations [12800|19712, 768|3072|512|2048]; the weights
     W^T and W, float32, in both scale forms) and the rescale of real int8 products (float32 or
     bfloat16 out; with a bias, bfloat16 out, as the W8A8 encoders' c_fc; the image projection
     at M=256, float32 out): codes, scales and outputs bit for bit against the plain versions,
     a zero row and a row of exact .5 ties in every quantize input, a second launch the same
     bits; times with GB/s and the share of the byte bound, and beside each rescale its
     product as torch._int_mm and as a bfloat16 torch.matmul (information);
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
     ``remat`` at that batch: the same losses, twice the forward launches, its peak memory;
  9. the long-context causal path: ViT-B/32 at full width and depth with the text tower's
     ``context_length`` at 2048 (``ViT-B-32-ctx2048``), whose every text block goes through
     ``attention()`` to the flash kernels: served as in phases 4-5 at bucket 32 (per text
     encode >= 12 flash forward launches, per image encode >= 12 block forward launches);
     trained as in phase 6, the float32 kernel path against the plain path at B=8 (per step
     exactly 12 launches of each block kernel and of each of the three flash kernels), then
     float32 and bfloat16 at the largest of 8/16/32 the kernel path holds; and one float32
     run of ViT-B/32 with ``vision.scaled_cosine`` and ``vision.attentional_pool`` at B=64
     (finite, falling, the text tower's 12 + 12 block launches and nothing else);
 10. the variational ViT-B/32 at full width and depth (``create_model(..., variational=True)``:
     a concentration token on each tower, so the vision blocks run the block kernels at S=51
     and the text blocks at S=78 causal, both also phase-3 rows): an eval-mode encode at
     B=256 in float32, kernel path against plain path (means at cosine >= 0.9999,
     concentrations within 1e-4 relative, >= 12 block-forward launches per tower encode);
     training with the reference recipe's loss (``power_spherical``, KL weight 100, 20
     samples, var_reg 0.1, label smoothing 0.1, the Riemannian mean gradient; the fused AdamW
     at lr 1e-3 and weight decay 1e-8), each run's Monte-Carlo draws from a CUDA generator
     seeded alike: float32 at B=128 through the kernels against the plain path as in phase 6
     (24 launches of each block kernel per step), bfloat16 at B=128 and B=256 (finite, the
     total loss falling), then 2 float32 steps each of ``vmf`` and of the Gaussian mode with
     ``normal`` (finite; vMF concentrations at or above the minimum); samples/s over steps
     2-6 and peak memory;
 11. the rest of the model family, each ViT-B/32 at full width and depth with seeded weights,
     each run as in phase 6 (the fused AdamW, a fixed synthetic uint8 batch, samples/s over
     steps 2-6, peak memory, float32 kernel path against plain path with phase 6's limits):
     a LoRA fine-tune (r=8, alpha 16) of a base loaded from an OpenAI-format state dict,
     trained in the "lora" freeze mode at B=256 (every frozen parameter bit for bit unchanged;
     the optimizer state's bytes beside phase 6's), bfloat16 at B=256, then the adapters merged
     into a model without them, its encodes at bucket 256 against the adapted model's (cosine
     >= 0.9999); a MoE vision tower (8 experts, top-2, capacity factor 1.25 on every second
     block: 6 MoE blocks, 15 slots an expert an image) at B=256, each MoE layer's expert
     choices compared between the paths: a step whose d routing decisions differ holds its
     loss to 1e-5 + d / (B * S) and prints its grad norm and leaves unheld; the aux term
     finite, its mean per layer and round in [1, 8]; bfloat16 at B=256; SigLIP
     (``siglip=True``, ``loss_type="siglip"``) at B=256, the logit bias moving from -10, and
     bfloat16 (finite, each step's loss within 2e-2 of the float32 kernel path's and falling
     below step 1's; on this batch the loss rises again at step 6 on both float32 paths);
     ``force_image_size=384`` (vision S=145 through the LN-fold kernels, 12 launches
     of each a step, the text tower through the others) for 2 float32 steps at B=128, then
     bfloat16 rates;
 12. int8: ViT-B/32 at full width and depth with ``int8_forward=True`` at B=256 (every dense
     MLP on the SwitchBack GEMMs: per step 192 row-quantize and 96 rescale launches beside the
     24 of each block kernel): float32 kernel path against plain path, the int8 codes that
     flip between them counted and printed, with phase 6's limits widened by 3x each held
     quantity's distance between the int8 step and the float step from the same start (the
     flips cascade: the two paths may hold independent roundings of a value, ``int8_limit``);
     bfloat16 in turns with the bfloat16 step without int8 (A, B, B, A, A, B: samples/s and
     peak memory, the A/B); then the
     W8A8 encoders behind the HTTP server (``quantized=True``): 73 launches of each int8
     kernel per tower encode, cosine > 0.99 to the float32 encode and >= 0.9999 to the same
     encode through the plain versions, encodes/s at bucket 256 and single-request p50.
Before the last line come the card's name and power limit and the kernel summary (JSON); the
last line is the device record.
"""

from __future__ import annotations

import base64
import contextlib
import json
import os
import re
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
LONG_MODEL = "ViT-B-32-ctx2048"
LONG_CONTEXT = 2048
LONG_BUCKET = 32  # the serving bucket of the long-context model: 32 x 2048 = 65,536 tokens
LONG_COMPARE_BATCH = 8
OPTIONS_MODEL = "ViT-B-32-cosine-attnpool"
VCLIP_BATCH = 128  # the reference recipe's (scripts/train_vclip.sh)
VCLIP_LOSS = dict(distribution_type="power_spherical", kl_weight=100.0, num_samples=20,
                  var_reg_weight=0.1, label_smoothing=0.1, riemannian=True)
VCLIP_OPT = dict(schedule=1e-3, weight_decay=1e-8)
LORA = dict(lora_rank=8, lora_alpha=16.0)
MOE_MODEL = "ViT-B-32-moe"
MOE_VISION = dict(moe_experts=8, moe_every=2, moe_top_k=2, moe_capacity_factor=1.25)
HIRES = dict(force_image_size=384)  # ViT-B/32's vision tower at S = 12 * 12 + 1 = 145
HIRES_BATCH = 128
_CSRC = "multimodal_tpu_torch/ops/csrc/"
_JAX_BLOCK = "multimodal_tpu/ops/block_attention.py"
_JAX_FUSED = "multimodal_tpu/ops/fused_attention.py"
_JAX_MLP = "multimodal_tpu/ops/block_mlp.py"
_JAX_FLASH = "multimodal_tpu/ops/flash_attention.py"
_JAX_QUANT = "multimodal_tpu/ops/quant.py"
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
    "flash_attention_fwd": (_CSRC + "flash_attention.cu", _JAX_FLASH + ":93", "flash-S2048"),
    "flash_attention_dq": (_CSRC + "flash_attention.cu", _JAX_FLASH + ":207", "flash-S2048"),
    "flash_attention_dkv": (_CSRC + "flash_attention.cu", _JAX_FLASH + ":241", "flash-S2048"),
    "quantize_rows": (_CSRC + "quant.cu", _JAX_QUANT + ":31 (quantize_rows) and :22 "
                      "(quantize_weight)", "q-B32-vision-act"),
    "int8_rescale": (_CSRC + "quant.cu", _JAX_QUANT + ":49 (_int8_product), :78 "
                     "(_int8_dense_bwd) and :100 (int8_matmul), the rescales", "r-B32-vision-fc"),
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
    ("vision-D80", 2, 257, 1280, 16, False),  # ViT-H/14's width: head dim 80, a padded k-step
    ("vision-D88", 2, 257, 1408, 16, True),   # ViT-g/14's width: head dim 88
    ("vclip-vision", 3, 51, 768, 12, False),  # VariationalCLIP: CLS, 49 patches, the
    ("vclip-vision", 256, 51, 768, 12, False),  # concentration token (an odd S)
    ("vclip-text", 3, 78, 512, 8, True),  # 77 tokens and the concentration token, which
    ("vclip-text", 256, 78, 512, 8, True),  # attends to every row
]
LN_CASES = [  # (case, batch, seq, width, heads, causal, residual)
    ("ln-S145", 3, 145, 768, 12, False, True),    # ViT-B/32's vision tower at 384 px
    ("ln-S145", 256, 145, 768, 12, False, True),
    ("ln-S197", 4, 197, 768, 12, False, True),
    ("ln-S197", 4, 197, 768, 12, True, True),
    ("ln-S197", 4, 197, 768, 12, False, False),
    ("ln-S197", 256, 197, 768, 12, False, True),
    ("ln-S257", 2, 257, 1024, 16, False, True),
    ("ln-S320", 2, 320, 768, 12, False, True),
    ("ln-S320", 2, 320, 768, 12, True, True),
    ("ln-D80", 2, 257, 1280, 16, False, True),
    ("ln-D88", 2, 257, 1408, 16, False, True),
]
FUSED_CASES = [  # (case, batch, seq, heads, head_dim, causal)
    ("fused-S128", 2, 128, 8, 32, False),
    ("fused-S128", 2, 128, 8, 32, True),
    ("fused-S197", 4, 197, 12, 64, False),
    ("fused-S197", 4, 197, 12, 64, True),
    ("fused-S197", 256, 197, 12, 64, False),
    ("fused-S512", 2, 512, 4, 128, False),
    ("fused-S512", 2, 512, 4, 128, True),
    ("fused-S129", 3, 129, 12, 64, True),    # one past a 64-row tile edge
    ("fused-S191", 3, 191, 12, 64, False),   # one short of it
    ("fused-S257", 2, 257, 16, 64, False),
    ("fused-S257", 2, 257, 16, 64, True),
    ("fused-S512-D32", 2, 512, 4, 32, False),
]
MLP_CASES = [  # (case, batch, seq, width, hidden, act); T = batch * seq token rows
    ("mlp-B32-vision", 256, 50, 768, 3072, "quick_gelu"),
    ("mlp-B32-text", 256, 77, 512, 2048, "quick_gelu"),
    ("mlp-B16-vision", 256, 197, 768, 3072, "quick_gelu"),
    ("mlp-L14", 64, 257, 1024, 4096, "gelu"),
    ("mlp-ragged", 3, 197, 768, 3072, "quick_gelu"),
]
FLASH_CASES = [  # (case, batch, sq, sk, heads, head_dim, causal, timed)
    ("flash-S2048", 1, 2048, 2048, 8, 64, True, False),
    ("flash-S2048", 8, 2048, 2048, 8, 64, True, True),  # the text tower's call at B=8
    ("flash-S4096", 2, 4096, 4096, 8, 64, True, True),
    ("flash-S1024-full", 2, 1024, 1024, 8, 64, False, False),
    ("flash-S2048-full", 2, 2048, 2048, 8, 64, False, False),
    ("flash-S2050", 1, 2050, 2050, 8, 64, True, False),
    ("flash-cross", 2, 300, 520, 8, 64, True, False),  # sq != sk: the top-left mask
    ("flash-D80", 2, 514, 514, 4, 80, True, False),
    ("flash-D88", 2, 514, 514, 4, 88, True, False),  # no multiple of 16: a zero-padded k-step
    ("flash-D128", 2, 514, 514, 4, 128, True, False),
    ("flash-D32", 2, 514, 514, 8, 32, False, False),
    ("flash-B32", 32, 2048, 2048, 8, 64, True, True),  # the text tower's call at B=32
]
QUANT_CASES = [  # (case, rows, cols, weight): the row quantize of ViT-B/32's int8 step at B=256
    ("q-B32-vision-x", 256 * 50, 768, False),      # c_fc's input; dx's g of c_proj
    ("q-B32-vision-act", 256 * 50, 3072, False),   # c_proj's input act(h); g of c_fc
    ("q-B32-text-x", 256 * 77, 512, False),
    ("q-B32-text-act", 256 * 77, 2048, False),
    ("q-vision-wT", 3072, 768, True),   # W1^T: the forward's per-column quantize of W1
    ("q-vision-w", 768, 3072, True),    # W1 by rows: the backward's (W1^T per column)
    ("q-text-wT", 2048, 512, True),
    ("q-text-w", 512, 2048, True),
]
RESCALE_CASES = [  # (case, M, K, N, bias, out dtype or None for the loop's): acc [M, N] of K
    ("r-B32-vision-fc", 256 * 50, 768, 3072, False, None),    # c_fc forward; c_proj's dx
    ("r-B32-vision-proj", 256 * 50, 3072, 768, False, None),  # c_proj forward; c_fc's dx
    ("r-B32-text-fc", 256 * 77, 512, 2048, False, None),
    ("r-B32-text-proj", 256 * 77, 2048, 512, False, None),
    ("r-serve-fc", 256 * 50, 768, 3072, True, "bfloat16"),    # the W8A8 encode's c_fc
    ("r-serve-projection", 256, 768, 512, False, "float32"),  # the image projection, B=256
]
INT8 = {"int8_forward": True}
INT8_NEED = {"block_attention_fwd": 24, "block_attention_bwd": 24, "quantize_rows": 192,
             "int8_rescale": 96}  # 48 dense layers: 4 quantizes and 2 rescales each a step
AB_RUNS = 3  # the int8/bf16 A/B: each arm this many times, in turns (A, B, B, A, A, B)
INT8_SPREAD = 3.0  # int8_limit: sqrt(2) for two independent roundings, and room for a max
CROSSOVER_TOKENS = 16384  # batch x S of every crossover case (B=8 at S=2048)
TRAIN_BATCH = 256
TRAIN_STEPS = 6  # every train run: the first step warms up, the five after it are timed
SHARED_COMPARE_BATCH = 64  # both paths hold it in float32; the plain path does not hold 256
CAPTIONS = ["a photo of a cat", "two dogs playing in the snow", "a red car on a bridge",
            "東京の夜景 ✨"]
# the card's published peaks (NVIDIA H100 SXM data sheet, dense): CUDA-core float32 for
# float32, tensor-core bf16 for bfloat16; HBM3 bytes/s. The float32 flash trio, the block
# kernels' GEMMs and the MLP pair's run 3xTF32 on the tensor cores, whose ceiling is a third
# of the TF32 peak: those kernels' float32 bound is taken at that rate, and their lines give
# the CUDA-core bound beside it
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_3XTF32 = 495e12 / 3
PEAK_BYTES = 3.35e12
TF32_KERNELS = ("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
                "block_attention_fwd", "block_attention_bwd", "block_attention_ln_fwd",
                "block_attention_ln_bwd", "block_mlp_fwd", "block_mlp_bwd")


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


def bound(kernel: str, flops: float, nbytes: float,
          dtype_name: str) -> tuple[float, str, float]:
    """The least time the card could take, in ms, what sets it and the FLOPs: the
    operations over the kernel's peak rate (``peak_of``), or each input read once and each
    output written once over the memory rate."""
    t_ops, t_bytes = flops / peak_of(kernel, dtype_name), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes", flops


def attention_pairs(s: int, causal: bool) -> float:
    """(query, key) pairs one head's attention needs: all of them, or the lower triangle."""
    return s * (s + 1) / 2 if causal else s * s


def peak_of(kernel: str, dtype_name: str) -> float:
    """The rate a kernel's bound is taken at: 3xTF32's ceiling for the float32 kernels that
    run it on the tensor cores, else the dtype's peak."""
    tf32 = dtype_name == "float32" and kernel in TF32_KERNELS
    return PEAK_3XTF32 if tf32 else PEAK_FLOPS[dtype_name]


def block_bound(kernel: str, b, s, w, heads, causal, dtype_name: str):
    """(ms, what bounds it, FLOPs): work of the TPU kernels' definition at this shape. Forward: four [B*S,W]x[W,W] projections and the core's two products.
    Backward: seven projection-sized products (q, k, v recomputed, do, and dx over K=3W) and
    six core products (logits, attnpre, dv, dp, dq, dk), bound in float32 at the 3xTF32
    ceiling. Bytes: x [, dy], the outputs, the weights and biases [, gamma, beta, ln_out,
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
    return bound(kernel, flops, nbytes, dtype_name)


def fused_bound(kernel: str, b, s, heads, d, causal, dtype_name: str):
    """Forward: two products over q, k, v, out. Backward: five products (logits, dv, dp,
    dq, dk) over q, k, v, do, dq, dk, dv."""
    e = 4 if dtype_name == "float32" else 2
    pairs = b * heads * attention_pairs(s, causal) * d
    if kernel.endswith("fwd"):
        return bound(kernel, 4 * pairs, e * 4 * b * s * heads * d, dtype_name)
    return bound(kernel, 10 * pairs, e * 7 * b * s * heads * d, dtype_name)


def flash_flops(kernel: str, b, sq, sk, heads, d, causal) -> float:
    """Forward: two products a pair (logits, out). dQ: three (logits, dp, dq). dK/dV: four
    (logits, dp, dv, dk); the two backward kernels each rebuild logits and dp, a one-pass
    backward would need five products, 10 x pairs x D. Pairs under the top-left causal mask:
    query r sees keys 0..min(r, sk-1)."""
    n = min(sq, sk)
    pairs = n * (n + 1) / 2 + max(sq - sk, 0) * sk if causal else sq * sk
    products = {"fwd": 2, "dq": 3, "dkv": 4}[kernel.rsplit("_", 1)[1]]
    return 2 * products * b * heads * pairs * d


def flash_bound(kernel: str, b, sq, sk, heads, d, causal, dtype_name: str):
    """(ms, what bounds it, FLOPs). Bytes: q, k, v and do or out-sized tensors once each,
    lse and delta in float32. The float32 trio's operations run at the 3xTF32 ceiling, the
    arithmetic it does."""
    e = 4 if dtype_name == "float32" else 2
    flops = flash_flops(kernel, b, sq, sk, heads, d, causal)
    q_size, k_size, rows = b * sq * heads * d, b * sk * heads * d, 4 * b * heads * sq
    nbytes = {"fwd": e * (2 * q_size + 2 * k_size) + rows,
              "dq": e * (3 * q_size + 2 * k_size) + 2 * rows,
              "dkv": e * (2 * q_size + 4 * k_size) + 2 * rows}[kernel.rsplit("_", 1)[1]]
    return bound(kernel, flops, nbytes, dtype_name)


def rate_note(kernel: str, dtype_name: str, ms: float, b_ms: float, flops: float) -> str:
    """A timed line's rate: TFLOP/s, the share of its bound reached, and for a float32 kernel
    bound at the 3xTF32 ceiling the CUDA cores' bound too."""
    note = f" tflops={flops / ms / 1e9:.1f} of_bound={100 * b_ms / ms:.1f}%"
    if peak_of(kernel, dtype_name) == PEAK_3XTF32:
        b_cc = 1e3 * flops / PEAK_FLOPS["float32"]
        note += f" bound_cuda_cores_ms={b_cc:.4f} of_cuda_core_bound={100 * b_cc / ms:.1f}%"
    return note


def mlp_bound(kernel: str, t, w, hid, dtype_name: str):
    """Work of the TPU kernels' definition: two [T,W]x[W,H]-sized products forward, four
    backward. Bytes forward: x, y, h and the parameters; backward: x, dy, h, dx, both weights
    and both weight gradients, and the four vector sums in float32."""
    e = 4 if dtype_name == "float32" else 2
    if kernel.endswith("fwd"):
        return bound(kernel, 4 * t * w * hid,
                     e * (2 * t * w + t * hid + 2 * w * hid + hid + 3 * w), dtype_name)
    nbytes = e * (3 * t * w + t * hid + 4 * w * hid + 2 * w) + 4 * (hid + 3 * w)
    return bound(kernel, 8 * t * w * hid, nbytes, dtype_name)


def kernel_cases(torch, ba, fa, bm, fl, dtype):
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
        # activation and the add. Beside the kernels, as information and no yardstick, the
        # same products as plain torch.matmul calls in the same dtype: c_fc and c_proj (#9);
        # dy W2^T, dh W1^T, g^T dy and ln^T dh (#10). Timed with the residual; the branch alone
        # is compared only
        ln, g_act = ba.ln_rows(x, gamma.to(dtype), beta.to(dtype), ba.LN_EPS), bm.act_fwd(h, act)
        dh = ((dy @ w2.T).float() * bm.act_bwd(h.float(), act)).to(dtype)
        matmul = {"block_mlp_fwd": lambda: (ln @ w1, g_act @ w2),
                  "block_mlp_bwd": lambda: (dy @ w2.T, dh @ w1.T, g_act.T @ dy, ln.T @ dh)}
        for residual in (True, False):
            timed = residual and case != "mlp-ragged"
            kw = dict(act=act, residual=residual)
            shape = f"T={b}x{s} W={w} H={hid} act={act} residual={residual!s:<5}"
            yield ("block_mlp_fwd", case, shape, timed,
                   lambda: bm.block_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, **kw),
                   lambda: bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, **kw),
                   None, {"matmul_ms": matmul["block_mlp_fwd"]}, ("y", "h"),
                   mlp_bound("block_mlp_fwd", t, w, hid, name))
            yield ("block_mlp_bwd", case, shape, timed,
                   lambda: bm.block_mlp_bwd(x, dy, h, gamma, beta, w1, w2, **kw),
                   lambda: bm.block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2, **kw),
                   None, {"matmul_ms": matmul["block_mlp_bwd"]},
                   ("dx", "dW1", "dW2", "db1", "db2", "dgamma", "dbeta"),
                   mlp_bound("block_mlp_bwd", t, w, hid, name))
    for case, b, sq, sk, heads, d, causal, timed in FLASH_CASES:
        g = torch.Generator(device="cuda").manual_seed(b * 1000 + sq)
        q, k, v, do = (torch.randn(b, s_, heads, d, generator=g, device="cuda").to(dtype)
                       for s_ in (sq, sk, sk, sq))
        kw = dict(causal=causal)
        shape = f"B={b:<3} Sq={sq} Sk={sk} H={heads} D={d} causal={causal!s:<5}"
        # the backward kernels take the forward kernel's out and lse, as the operator's
        # backward hands them over; delta = rowsum(do * out) is formed outside, once
        out, lse = fl.flash_attention_fwd(q, k, v, **kw)
        delta = fl.flash_delta(out, do)
        # the library yardstick: one scaled_dot_product_attention call on head-major views of
        # the same tensors; its one backward call yields dq, dk and dv together, so both
        # backward kernels are timed beside the whole of it. Not at sq != sk
        library = {}
        if sq == sk:
            heads_first = lambda t: t.transpose(1, 2)  # noqa: E731
            qh, kh, vh, doh = (heads_first(t) for t in (q, k, v, do))
            leaves = [t.detach().requires_grad_() for t in (qh, kh, vh)]
            sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            sdpa_grad = lambda which: (  # noqa: E731
                lambda: torch.autograd.grad(sdpa_out, leaves[which], doh, retain_graph=True))
            library = {
                "fwd": (lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal),
                        heads_first),
                "dq": (sdpa_grad(slice(0, 1)), lambda grads: heads_first(grads[0])),
                "dkv": (sdpa_grad(slice(1, 3)), lambda grads: heads_first(grads[0])),
            }
        yield ("flash_attention_fwd", case, shape, timed,
               lambda: fl.flash_attention_fwd(q, k, v, **kw),
               lambda: fl.flash_attention_reference(q, k, v, **kw),
               library.get("fwd"), {}, ("out", "lse"),
               flash_bound("flash_attention_fwd", b, sq, sk, heads, d, causal, name))
        yield ("flash_attention_dq", case, shape, timed,
               lambda: fl.flash_attention_dq(q, k, v, do, lse, delta, **kw),
               lambda: fl.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[:1],
               library.get("dq"), {}, ("dq",),
               flash_bound("flash_attention_dq", b, sq, sk, heads, d, causal, name))
        yield ("flash_attention_dkv", case, shape, timed,
               lambda: fl.flash_attention_dkv(q, k, v, do, lse, delta, **kw),
               lambda: fl.flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)[1:],
               library.get("dkv"), {}, ("dk", "dv"),
               flash_bound("flash_attention_dkv", b, sq, sk, heads, d, causal, name))


def phase_kernels(torch, ba, fa, bm, fl) -> dict:
    """Every kernel vs plain at every case and both dtypes; times at B=256 (ViT-L/14's MLP
    shape at B=64; the flash trio at B=8 S=2048 and B=2 S=4096). The library
    call, where there is one, is held to the plain version's first output too, at a wider
    limit (1e-3 and 5e-2 x max|plain|: it rounds at other points and sums in another
    order), so that its time is the time of the same function."""
    worst_f32 = dict.fromkeys(KERNELS, 0.0)
    timing, failures = {}, []
    for dtype, rel_tol, lib_tol in ((torch.float32, 1e-4, 1e-3), (torch.bfloat16, 2e-2, 5e-2)):
        name = str(dtype).replace("torch.", "")
        for (kernel, case, shape, timed, kern, plain, library, others, outputs,
             (b_ms, b_by, flops)) in kernel_cases(torch, ba, fa, bm, fl, dtype):
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
            if kernel.startswith(("block_attention", "block_mlp")) or (
                    timed and kernel.startswith(("fused_attention", "flash_attention"))):
                # no float atomics, one owner and a fixed order for every sum: a second launch
                # gives the same bits, every output
                again = kern()
                again = again if isinstance(again, tuple) else (again,)
                same = all(torch.equal(a, b) for a, b in zip(again, got))
                ok = ok and same
                line += f" same_bits_twice={same}"
                del again
            del got, want
            if timed:
                slow = "S197" in case or case.startswith(("mlp", "flash"))
                iters = 8 if slow else 20
                k_ms, p_ms = cuda_ms(kern, iters), cuda_ms(plain, iters)
                other_ms = {k: cuda_ms(fn, iters) for k, fn in others.items()}
                if library is not None:
                    other_ms["library_ms"] = cuda_ms(library[0], iters)
                timing[(kernel, case, name)] = {
                    "ms": k_ms, "plain_ms": p_ms, "library_ms": other_ms.get("library_ms"),
                    "bound_ms": b_ms, "bound_by": b_by}
                line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
                         f"({b_by})" + "".join(f" {k}={v:.4f}" for k, v in other_ms.items()))
                line += rate_note(kernel, name, k_ms, b_ms, flops)
            print(line, flush=True)
            if not ok:
                failures.append(line)
            if dtype == torch.float32:
                worst_f32[kernel] = max(worst_f32[kernel], err)
        torch.cuda.empty_cache()
    if failures:
        fail(f"{len(failures)} kernel/plain mismatches")
    return {"worst_f32": worst_f32, "timing": timing}


def quant_bound(kernel: str, elems: int, in_bytes: int, out_bytes: int, rows: int,
                cols: int, bias: bool = False):
    """(ms, what bounds it, operations) of a quantize or a rescale: each input read once and
    each output written once (quantize: x, the int8 codes and a float32 scale a row; rescale:
    the int32 accumulator, sx, sw [, bias] and the output), over the CUDA cores' float32 rate
    for its 4 (quantize: abs, max, divide, round) or 3 (rescale: convert, two multiplies; the
    bias's FMA) operations an element."""
    if kernel == "quantize_rows":
        nbytes = elems * (in_bytes + 1) + 4 * rows
        ops = 4 * elems
    else:
        nbytes = elems * (4 + out_bytes) + 4 * rows + 4 * cols * (2 if bias else 1)
        ops = 3 * elems
    return bound(kernel, ops, nbytes, "float32")


def quant_cases(torch, q, dtype):
    """Every (kernel, case, shape text, timed, run kernel, run plain, others, bound) of the
    int8 kernels for one activation dtype, built lazily. Quantize inputs hold a zero row and a
    row of exact .5 ties (amax 127: both forms give scale 1.0); weights are float32 and run
    both scale forms (the train step's "reciprocal", the serving load's "divide"), once, with
    the float32 loop. Rescale inputs are real int8 products; beside each, as information, its
    product as ``torch._int_mm`` (TN, the port's layout; and with the weight operand [K, N]
    row-major) and the same product as a bfloat16 ``torch.matmul``."""
    name = str(dtype).replace("torch.", "")
    for case, rows, cols, weight in QUANT_CASES:
        if weight and dtype != torch.float32:
            continue
        g = torch.Generator(device="cuda").manual_seed(rows + cols)
        x = torch.randn(rows, cols, generator=g, device="cuda") * (0.05 if weight else 3.0)
        x[0] = 0.0
        ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, 3.5, -0.5, 126.5], device="cuda")
        x[1] = ties.repeat(cols // 8)
        x = x.to(torch.float32 if weight else dtype)
        b_ms, b_by, ops = quant_bound("quantize_rows", rows * cols, x.element_size(), 1, rows,
                                      cols)
        for form in (("reciprocal", "divide") if weight else ("reciprocal",)):
            shape = f"R={rows} C={cols} {form:<10}"
            yield ("quantize_rows", case, shape, not weight,
                   (lambda x=x, form=form: q.quantize_rows(x, form)),
                   (lambda x=x, form=form: q.quantize_rows_reference(x, form)), {},
                   (b_ms, b_by, ops, rows * cols * (x.element_size() + 1) + 4 * rows))
    for case, m, k, n, bias, out in RESCALE_CASES:
        out_dtype = getattr(torch, out) if out else dtype
        if out and out_dtype != dtype:
            continue
        g = torch.Generator(device="cuda").manual_seed(m + k + n)
        aq = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        bq = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        acc = q.int8_product(aq, bq)
        sx = torch.rand(m, generator=g, device="cuda") * 0.05
        sw = torch.rand(n, generator=g, device="cuda") * 1e-3
        b = torch.randn(n, generator=g, device="cuda") * 0.02 if bias else None
        a16, b16 = aq.to(torch.bfloat16), bq.to(torch.bfloat16).t().contiguous()
        b_kn = bq.t().contiguous()  # the [K, N] row-major operand, against the port's [N, K]
        b_ms, b_by, ops = quant_bound("int8_rescale", m * n, 0, torch.empty(
            0, dtype=out_dtype).element_size(), m, n, bias)
        shape = f"M={m} K={k} N={n} bias={bias!s:<5} out={str(out_dtype)[6:]}"
        yield ("int8_rescale", case, shape, True,
               (lambda acc=acc, sx=sx, sw=sw, b=b, o=out_dtype: q.rescale(acc, sx, sw, b,
                                                                        out_dtype=o)),
               (lambda acc=acc, sx=sx, sw=sw, b=b, o=out_dtype: q.rescale_reference(
                   acc, sx, sw, b, out_dtype=o)),
               {"int_mm_ms": (lambda aq=aq, bq=bq: torch._int_mm(aq, bq.t()), 2 * m * k * n),
                "int_mm_kn_ms": (lambda aq=aq, b=b_kn: torch._int_mm(aq, b), 2 * m * k * n),
                "bf16_matmul_ms": (lambda a=a16, b=b16: a @ b, 2 * m * k * n)},
               (b_ms, b_by, ops, m * n * (4 + torch.empty(0, dtype=out_dtype).element_size())))


def phase_quant_kernels(torch, q) -> dict:
    """The row-quantize and rescale kernels against their plain versions at ViT-B/32's int8
    shapes (B=256), float32 and bfloat16 activations: every output the same bits (codes,
    scales, rescaled values), a second launch the same bits again; CUDA-event times with GB/s
    and the share of the byte bound; beside each rescale its product's ``torch._int_mm`` and
    bfloat16 ``torch.matmul`` times and rates, as information."""
    worst_f32 = {"quantize_rows": 0.0, "int8_rescale": 0.0}
    timing, failures = {}, []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for kernel, case, shape, timed, kern, plain, others, (b_ms, b_by, ops, nbytes) in (
                quant_cases(torch, q, dtype)):
            got, want = kern(), plain()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            twice = all(torch.equal(a, b) for a, b in zip(again, got))
            diff = max(int((a != b).sum()) for a, b in zip(got, want))
            ok = same and twice and all(bool(torch.isfinite(a.float()).all()) for a in got)
            line = (f"{kernel} {case:<18} {shape} {name:<8} bit for bit vs plain={same} "
                    f"(differing elements {diff}) same_bits_twice={twice} "
                    f"{'ok' if ok else 'MISMATCH'}")
            del got, want, again
            if timed:
                k_ms, p_ms = cuda_ms(kern, 20), cuda_ms(plain, 5)
                line += (f" kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
                         f"({b_by}) GB/s={nbytes / k_ms / 1e6:.1f} of_bound="
                         f"{100 * b_ms / k_ms:.1f}%")
                for other, (fn, flops) in others.items():
                    o_ms, unit = cuda_ms(fn, 20), "TOP/s" if other.startswith("int") else "TFLOP/s"
                    line += f" {other}={o_ms:.4f} ({flops / o_ms / 1e9:.1f} {unit})"
                timing[(kernel, case, name)] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": None,
                                                "bound_ms": b_ms, "bound_by": b_by}
            print(line, flush=True)
            if not ok:
                failures.append(line)
        torch.cuda.empty_cache()
    if failures:
        fail(f"{len(failures)} int8 kernel/plain mismatches")
    return {"worst_f32": worst_f32, "timing": timing}


def qkv_repeats(torch, ba):
    """The block backward's recomputed q, k and v against the forward's, bit for bit, in both
    forms (vision S=50 and the LN form at S=197, B=4) and both dtypes: the two run the
    projection GEMM's NN loop over the same A values (x; ln_out, whose elements are the
    forward's LN load transform's) and add the bias and round alike."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for ln, b, s, w, heads in ((False, 4, 50, 768, 12), (True, 4, 197, 768, 12)):
            g = torch.Generator(device="cuda").manual_seed(b * 1000 + s)
            rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
            x, dy = rnd(b, s, w).to(dtype), rnd(b, s, w).to(dtype)
            ws = []
            for _ in range(4):
                ws += [(rnd(w, w) * w ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)]
            gamma, beta = (1 + 0.1 * rnd(w)).to(dtype), (0.1 * rnd(w)).to(dtype)
            fwd, bwd = (torch.empty((3, b * s, w), dtype=dtype, device="cuda") for _ in range(2))
            kw = dict(heads=heads, causal=False)
            if ln:
                ba._block_attention_ln_cuda(x, gamma, beta, *ws, residual=True, qkv=fwd, **kw)
                ba._block_attention_ln_bwd_cuda(x, dy, gamma, beta, *ws, residual=True, qkv=bwd,
                                                **kw)
            else:
                ba._block_attention_cuda(x, *ws, qkv=fwd, **kw)
                ba._block_attention_bwd_cuda(x, dy, *ws, qkv=bwd, **kw)
            torch.cuda.synchronize()
            same = torch.equal(fwd, bwd)
            print(f"block_attention_{'ln_' if ln else ''}bwd recomputed q, k, v vs the forward's "
                  f"B={b} S={s} W={w} {name}: same_bits={same}", flush=True)
            if not same:
                fail("the backward's recomputed q, k, v differ from the forward's")


def flash_long_error(torch, fl) -> float:
    """The float32 flash forward at S=8192 (B=1, H=8, D=64, causal), four times the longest
    shipped text context, where its sums run longest: out and lse against the plain version,
    each within 1e-4 x max|plain|. Returns the larger absolute error."""
    g = torch.Generator(device="cuda").manual_seed(8192)
    q, k, v = (torch.randn(1, 8192, 8, 64, generator=g, device="cuda") for _ in range(3))
    got = fl.flash_attention_fwd(q, k, v, causal=True)
    want = fl.flash_attention_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    errs = [((a - r).abs().max().item(), r.abs().max().item()) for a, r in zip(got, want)]
    ok = all(e <= 1e-4 * m for e, m in errs) and all(bool(torch.isfinite(a).all()) for a in got)
    print(f"flash_attention_fwd flash-S8192 B=1 Sq=8192 Sk=8192 H=8 D=64 causal=True float32 "
          "max_abs_err/max|plain| " + " ".join(f"{o}={e:.2e}/{m:.2e}" for o, (e, m) in
                                               zip(("out", "lse"), errs))
          + f" (tol 1e-4 x max|plain|) {'ok' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        fail("the float32 flash forward breaks its limit at S=8192")
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return max(e for e, _ in errs)


def flash_crossover(torch, attention, card):
    """Where the dispatch's rule (causal, S >= MIN_FLASH_SEQ) stands on this card: the flash
    operator against the plain attention path through ``attention()``, forward plus backward
    at H=8 D=64 and 16,384 tokens a batch, time and peak memory beyond the operands."""
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for s in (1024, 2048, 4096):
            for causal in (True, False):
                b = CROSSOVER_TOKENS // s
                g = torch.Generator(device="cuda").manual_seed(s)
                q, k, v, do = (torch.randn(b, s, 8, 64, generator=g, device="cuda").to(dtype)
                               for _ in range(4))
                leaves = [t.requires_grad_() for t in (q, k, v)]
                cells = {}
                for impl in ("flash", "xla"):
                    def run():
                        out = attention(*leaves, causal=causal, impl=impl)
                        torch.autograd.grad(out, leaves, do)
                    run()
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    ms = cuda_ms(run, iters=4, warmup=1)
                    cells[impl] = (ms, (torch.cuda.max_memory_allocated() - base) / 2**20)
                print(f"  crossover S={s} B={b} causal={causal!s:<5} {name:<8} fwd+bwd ms: flash "
                      f"{cells['flash'][0]:.3f} plain path {cells['xla'][0]:.3f}; peak MiB "
                      f"beyond the operands: flash {cells['flash'][1]:.0f} plain path "
                      f"{cells['xla'][1]:.0f} [{card}]", flush=True)
                del q, k, v, do, leaves
                torch.cuda.empty_cache()


def kernel_label(mangled: str) -> str:
    """A kernel's name with its template arguments, from its mangled name: mangled as they
    stand (Li64E is 64, Lb1E true, f float, 13__nv_bfloat16 bfloat16) except the flash
    kernels' operand structs and the projection GEMM's types, form, load and store, written
    out (flash_dq_kernel<Tf32Ops<64>>, mma_gemm_kernel<bfloat16, float, TN, LN-b, round>)."""
    from multimodal_tpu_torch.ops._build import gemm_signature

    found = re.search(r"_cu_[0-9a-f]{8}\d+([a-z][a-z_0-9]*_kernel)(I\w+?E)?Ev", mangled)
    if not found:
        return mangled.split()[-1]
    ops = re.fullmatch(r"INS_\d+(\w+Ops)ILi(\d+)EE+", found.group(2) or "")
    if ops:
        return f"{found.group(1)}<{ops.group(1)}<{ops.group(2)}>>"
    gemm = gemm_signature(mangled)
    if gemm:
        return f"{found.group(1)}<{', '.join(gemm)}>"
    return found.group(1) + (found.group(2) or "")


def ptxas_report(log: str) -> list[str]:
    """One line per kernel of ``nvcc -Xptxas -v``'s output: its name with its template
    arguments (``kernel_label``), stack and spill bytes, registers and static shared
    memory."""
    lines, name = [], "?"
    for ln in log.splitlines():
        text = ln.strip().replace("ptxas info    : ", "")
        if "Function properties for" in text:
            name = kernel_label(text)
        elif "spill" in text:
            lines.append(f"{name}: {text}")
        elif "registers" in text and lines:
            lines[-1] += f"; {text}"
    return lines


def read_sass(lib_path: str) -> str | None:
    """The built library's SASS (``cuobjdump -sass``), or None where the toolkit has no
    ``cuobjdump``."""
    from multimodal_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    if not os.path.isfile(tool):
        return None
    return subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          timeout=300, check=True).stdout


def sass_report(sass: str) -> str:
    """Tensor-core (HMMA), ldmatrix (LDSM) and asynchronous-copy (LDGSTS) instructions in the
    SASS, summed over the bfloat16 attention passes (``*_mma_kernel``)."""
    counts, kernels, inside = dict.fromkeys(("HMMA", "LDSM", "LDGSTS"), 0), 0, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = "_mma_kernel" in ln
            kernels += inside
        elif inside:
            for op in counts:
                counts[op] += f" {op}." in ln
    return f"{kernels} *_mma_kernel functions in the SASS: {counts}"


def hmma_forms(sass: str) -> dict[str, dict[str, int]]:
    """Per flash-attention kernel and projection GEMM in the SASS (each instantiation: dtype
    and head dim, or types and form, as ``kernel_label`` names it), its tensor-core
    instructions counted by form (HMMA.16816.F32.BF16 is mma.sync m16n8k16 on bf16,
    HMMA.1688.F32.TF32 m16n8k8 on TF32)."""
    kernels, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = kernel_label(ln) if ("flash_" in ln or "mma_gemm_kernel" in ln) else None
            if name:
                kernels.setdefault(name, {})
        elif name:
            found = re.search(r"\bHMMA(\.\S+?)?(?=\s)", ln)
            if found:
                form = found.group(0)
                kernels[name][form] = kernels[name].get(form, 0) + 1
    return kernels


def hmma_report(sass: str) -> list[str]:
    """One line per kernel of ``hmma_forms``: its tensor-core instructions by form, or that it
    has none."""
    return [f"{k}: " + (", ".join(f"{form} x {n}" for form, n in sorted(c.items()))
                        or "no HMMA (CUDA cores)") for k, c in sorted(hmma_forms(sass).items())]


def gemm_hmma_faults(sass: str) -> list[str]:
    """The projection GEMM's instantiations whose products are not all on the tensor cores in
    their dtype's form: HMMA.16816.F32.BF16 for bfloat16 operands, HMMA.1688.F32.TF32 (3xTF32)
    for float32. An instantiation with no HMMA at all is a fault too."""
    want = {"bfloat16": "HMMA.16816.F32.BF16", "float": "HMMA.1688.F32.TF32"}
    faults = []
    for name, forms in sorted(hmma_forms(sass).items()):
        if name.startswith("mma_gemm_kernel<"):
            dtype = name[len("mma_gemm_kernel<"):].split(",")[0]
            if set(forms) != {want[dtype]}:
                faults.append(f"{name}: {forms or 'no HMMA'}")
    return faults


def pass_smem_report() -> list[str]:
    """Dynamic shared memory a block of each attention pass asks for at launch, in bytes, as
    ``attention_passes.cuh`` sizes it: bfloat16 by the head dim rounded up to 64 or 128,
    float32 by the head dim."""
    lines = []
    for dp in (64, 128):  # 64-row resident tiles, two stages of two 32-row streamed tiles
        tile = lambda rows: 2 * rows * (dp + 8)  # noqa: E731
        lines.append(f"bfloat16 D<={dp}: forward {tile(64 + 128)}, dQ {tile(128 + 128)}, "
                     f"dK/dV {tile(128 + 128) + 24 * 32}")
    for d in (64, 128):
        tile, probs = 4 * 64 * (d + 4), 4 * 64 * 68
        lines.append(f"float32 D={d}: forward {3 * tile + probs}, dQ {4 * tile + probs}, "
                     f"dK/dV {4 * tile + 2 * probs + 768}")
    return lines


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
    from torch's autograd of that version): the block operator in both its forms, the fused
    and the flash operator behind ``attention()``, the fused MLP operator, and the int8 row
    quantize and rescale (every int8 product of training and serving calls them through the
    ``ops.quant`` module)."""
    ba, fa, bm, fl, q = mods["ba"], mods["fa"], mods["bm"], mods["fl"], mods["q"]
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

    def plain_flash_attention(q, k, v, *, causal=False, sm_scale=None):
        return fl.flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)[0]

    kernel_paths = (layers.block_attention, attention.fused_attention, layers.block_mlp,
                    attention.flash_attention, q.quantize_rows, q.rescale)
    layers.block_attention = plain_block_attention
    attention.fused_attention = fa.fused_attention_reference
    layers.block_mlp = plain_block_mlp
    attention.flash_attention = plain_flash_attention
    q.quantize_rows, q.rescale = q.quantize_rows_reference, q.rescale_reference
    try:
        yield
    finally:
        (layers.block_attention, attention.fused_attention, layers.block_mlp,
         attention.flash_attention, q.quantize_rows, q.rescale) = kernel_paths


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
                  block_mlp=False, bucket=256, quantized=False):
    """Serve ``model_name`` (float32, seeded weights) over HTTP; check the answers, the
    launch counts (``need_*``: kernel -> launches per tower encode) and the agreement with
    the plain-version encode; then throughput at ``bucket`` and single-request latency.
    ``quantized`` serves the int8 W8A8 encoders (``EmbeddingService(quantized=True)``), whose
    embeddings must also hold cosine > 0.99 to the float32 encode of the same model."""
    from multimodal_tpu_torch.data.tokenizer import tokenize
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.serving import EmbeddingService, make_server

    t0 = time.perf_counter()
    model = create_model(model_name, seed=0, block_mlp=block_mlp)
    dim, size = model.cfg.embed_dim, model.cfg.vision.image_size
    svc = EmbeddingService(model, max_batch=bucket, max_wait_ms=5.0, quantized=quantized)
    srv = make_server(svc, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    model_name += (" block_mlp" if block_mlp else "") + (" int8 W8A8" if quantized else "")
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
        if quantized:
            from multimodal_tpu_torch.inference import Embedder

            exact = Embedder(model, batch_size=bucket)
            f_t, f_i = exact.encode_tokens(tokens), exact.encode_images(images)
            gate_t = float(np.sum(f_t * txt, -1).min())
            gate_i = float(np.sum(f_i * img, -1).min())
            print(f"  served int8 vs the float32 encode: min cosine text={gate_t:.6f} "
                  f"image={gate_i:.6f} (need > 0.99)", flush=True)
            if min(gate_t, gate_i) <= 0.99:
                fail("the int8 embeddings left the float32 encode (cosine <= 0.99)")

        print(f"  throughput ({model_name})", flush=True)
        emb = svc._embedder
        rng = np.random.default_rng(1)
        batch_img = rng.integers(0, 256, (bucket, size, size, 3), dtype=np.uint8)
        batch_tok = np.repeat(tokens, bucket // len(tokens), axis=0)
        for name, fn, arg in (("image", emb.encode_images, batch_img),
                              ("text", emb.encode_tokens, batch_tok)):
            fn(arg)
            t0 = time.perf_counter()
            for _ in range(5):
                fn(arg)
            rate = 5 * bucket / (time.perf_counter() - t0)
            print(f"  {model_name} {name} encodes/s at bucket {bucket} "
                  f"({'int8, bfloat16 activations' if quantized else 'float32'}, host clock "
                  f"incl. transfer): {rate:.1f} [{card}]", flush=True)
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


def train_steps(torch, tally, model, batch, steps: int, grads_at: int = -1, count=True,
                loss_type: str = "clip", loss_kwargs: dict | None = None,
                opt_kw: dict | None = None, freeze: str | None = None) -> dict:
    """``steps`` training steps from a fresh optimizer (by default as bench.py builds it; with
    ``freeze`` a fine-tune mode of ``train.freeze``, the optimizer over the trainable
    parameters alone). Returns the per-step ``metrics`` and launch ``counts``, the gradients
    after step ``grads_at`` (0-based), the host-clock seconds of every step after the first
    (``time``), the ``peak`` device memory and the optimizer state's bytes (``opt_bytes``).
    The step's generator is a CUDA generator seeded 0, so two runs draw alike."""
    from multimodal_tpu_torch.train import (
        TrainState, finetune_mask, freeze_optimizer, make_optimizer, make_schedule,
        make_train_step)

    opt_kw = dict(opt_kw or dict(
        schedule=make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000),
        weight_decay=0.1, grad_clip_norm=1.0))
    schedule = opt_kw.pop("schedule")
    if freeze:
        opt = freeze_optimizer(model, finetune_mask(model.named_parameters(), freeze), schedule,
                               **opt_kw)
    else:
        opt = make_optimizer(model.named_parameters(), schedule, **opt_kw)
    state = TrainState.create(model, opt)
    step = make_train_step(model, opt, loss_type=loss_type, loss_kwargs=loss_kwargs)
    generator = torch.Generator(device="cuda").manual_seed(0)
    out = {"metrics": [], "counts": [], "grads": None, "time": 0.0}
    torch.cuda.reset_peak_memory_stats()
    for i in range(steps):
        torch.cuda.synchronize()
        tally.start()
        t0 = time.perf_counter()
        m = step(state, batch, generator)
        torch.cuda.synchronize()
        if i > 0:
            out["time"] += time.perf_counter() - t0
        # the plain path's counts are read but kept out of the main-path tally
        out["counts"].append(tally.stop() if count else tally.launches.launch_counts())
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == grads_at:
            out["grads"] = {n: p.grad.detach().clone() for n, p in model.named_parameters()
                            if p.grad is not None}
    out["peak"] = torch.cuda.max_memory_allocated()
    out["opt_bytes"] = sum(t.numel() * t.element_size()
                           for moments in (opt.mu, opt.nu) for t in moments.values())
    return out


def check_launches(counts, need: dict, what: str):
    """Every step of ``counts`` ran each kernel of ``need`` just that often, and no kernel
    outside it."""
    for cnt in counts:
        if {k: v for k, v in cnt.items() if v} != need:
            fail(f"{what}: launches per step {cnt}, need {need} and nothing else")


def model_label(model_name: str, block_mlp=False, variational=None, model_kw=None) -> str:
    return model_name + (" block_mlp" if block_mlp else "") + (
        f" variational {variational.model_type}" if variational else "") + "".join(
        f" {k}={v}" for k, v in (model_kw or {}).items())


def build_model(torch, model_name, dtype, block_mlp=False, variational=None, model_kw=None,
                prepare=None):
    """``create_model`` on the card with seed 0 and the options given; ``prepare(model)`` runs
    after it (a weight load)."""
    from multimodal_tpu_torch.models import create_model

    model = create_model(model_name, dtype=dtype, seed=0, block_mlp=block_mlp,
                         variational=variational is not None, vcfg=variational,
                         **(model_kw or {}))
    if prepare is not None:
        prepare(model)
    return model


def compare_paths(torch, mods, tally, card, model_name, n, steps, need, block_mlp=False,
                  variational=None, model_kw=None, prepare=None, routing=None, code_flips=None,
                  int8_reference=None, **step_kw) -> dict:
    """float32: ``steps`` steps through the kernels against the same from the same start
    with every kernel call routed to its plain version. ``variational`` (a
    ``VariationalConfig``) builds the variational model, ``model_kw`` goes to
    ``create_model`` and ``prepare`` to ``build_model``; ``step_kw`` goes to ``train_steps``
    (with ``freeze``, every frozen parameter must end bit for bit where it started, on both
    paths). ``routing`` (a ``RoutingRecorder``) records a MoE model's expert choices on both
    paths: a step whose choices differ in d > 0 of its decisions holds its loss to
    ``moe_loss_limit(d, tokens)`` and prints its grad norm and leaves without holding them.
    ``code_flips`` (a ``CodeFlips``) counts an int8 model's flipped codes in the first two
    steps; ``int8_reference`` (the float step's ``train_steps`` result from the same start)
    widens an int8 model's limits by ``int8_limit``, the loss and grad norm of each step and
    every leaf of step 1 by its own int8-vs-float distance. Returns the kernel path's
    ``peak`` memory, the model's parameter count (``params``), the optimizer state's bytes
    (``opt_bytes``), the kernel path's per-step ``metrics``, samples/s (``rate``) and the
    ``model`` after the plain path's run."""
    model = build_model(torch, model_name, torch.float32, block_mlp, variational, model_kw,
                        prepare)
    model_name = model_label(model_name, block_mlp, variational, model_kw)
    batch = make_batch(torch, model.cfg, n)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    frozen = []
    if step_kw.get("freeze"):
        from multimodal_tpu_torch.train import finetune_mask

        frozen = [k for k, t in finetune_mask(model.named_parameters(), step_kw["freeze"]).items()
                  if not t]

    def run(**kw):
        if routing is not None:
            routing.attach(model)
        if code_flips is not None:
            code_flips.attach()
        out = train_steps(torch, tally, model, batch, steps, grads_at=0, **kw, **step_kw)
        out["routes"] = routing.detach() if routing is not None else None
        if code_flips is not None:
            code_flips.detach()
        params = dict(model.named_parameters())
        moved = [k for k in frozen if not torch.equal(params[k], start[k])]
        if moved:
            fail(f"{model_name}: frozen parameters moved: {moved[:5]}")
        return out

    k_run = run()
    model.load_state_dict(start)
    with plain_attention(mods):
        p_run = run(count=False)
    k_metrics, p_metrics = k_run["metrics"], p_run["metrics"]
    flips = ([routing.flips(k_run["routes"], p_run["routes"], i) for i in range(2)]
             if routing is not None else [0, 0])
    for i in range(2):
        km, pm = k_metrics[i], p_metrics[i]
        print(f"  float32 step {i + 1}: loss kernel={km['loss']:.7f} plain={pm['loss']:.7f} "
              f"grad_norm kernel={km['grad_norm']:.6f} plain={pm['grad_norm']:.6f} "
              f"launches { {k: v for k, v in k_run['counts'][i].items() if v} }"
              + (f" routing flips d={flips[i]} of {routing.decisions(k_run['routes'], i)}"
                 if routing is not None else "")
              + (f" int8 code flips {code_flips.flips[i]} of {code_flips.codes[i]} "
                 f"(share {code_flips.share(i):.3e})" if code_flips is not None else ""),
              flush=True)
    print(f"  float32 losses kernel {[round(m['loss'], 7) for m in k_metrics]} plain "
          f"{[round(m['loss'], 7) for m in p_metrics]}", flush=True)
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)  # noqa: E731
    tokens = n * routing.seq if routing is not None else 1
    loss_rel = [rel(k_metrics[i]["loss"], p_metrics[i]["loss"]) for i in range(2)]
    norm_rel = [rel(k_metrics[i]["grad_norm"], p_metrics[i]["grad_norm"]) for i in range(2)]
    # per leaf |kernel - plain| / max|plain|; a leaf whose exact gradient is zero (the
    # attention key biases: softmax ignores a per-row constant) holds rounding noise on both
    # sides, so the scale has a floor of 1e-3 x the largest gradient of the model
    k_grads, p_grads = k_run["grads"], p_run["grads"]
    g_max = max(g.abs().max() for g in p_grads.values())
    leaf_dist = lambda grads: {  # noqa: E731
        n_: ((grads[n_] - g).abs().max() / torch.clamp(g.abs().max(), min=1e-3 * g_max)).item()
        for n_, g in p_grads.items()}
    leaf_rel = leaf_dist(k_grads)
    loss_lim = [moe_loss_limit(d, tokens) for d in flips]
    norm_lim, leaf_lim = [1e-4, 1e-4], dict.fromkeys(leaf_rel, 1e-3)
    if int8_reference is not None:
        ref = int8_reference["metrics"]
        loss_lim = [int8_limit(lim, rel(k_metrics[i]["loss"], ref[i]["loss"]))
                    for i, lim in enumerate(loss_lim)]
        norm_lim = [int8_limit(1e-4, rel(k_metrics[i]["grad_norm"], ref[i]["grad_norm"]))
                    for i in range(2)]
        leaf_lim = {n_: int8_limit(1e-3, v) for n_, v in leaf_dist(int8_reference["grads"]).items()}
    worst_leaf = max(leaf_rel, key=lambda n_: leaf_rel[n_] / leaf_lim[n_])
    print(f"  float32 kernel vs plain: loss rel diff {max(loss_rel):.3e} (need <= "
          f"{'/'.join(f'{v:.3e}' for v in loss_lim)}), grad norm rel diff {max(norm_rel):.3e} "
          f"(need <= {'/'.join(f'{v:.3e}' for v in norm_lim)}), worst grad leaf {worst_leaf} "
          f"{leaf_rel[worst_leaf]:.3e} x max|leaf| (need <= {leaf_lim[worst_leaf]:.3e})"
          f"{' (printed, not held: routing flips at step 1)' if flips[0] else ''}"
          f"{' (step 2 grad norm printed, not held)' if flips[1] else ''}; launches per step "
          f"need {need}", flush=True)
    if not all(np.isfinite([m[k] for m in k_metrics + p_metrics for k in m])):
        fail("non-finite float32 loss or grad norm")
    held_norm = [(r, lim) for r, lim, d in zip(norm_rel, norm_lim, flips) if d == 0]
    if (any(r > lim for r, lim in zip(loss_rel, loss_lim)) or any(r > lim for r, lim in held_norm)
            or (flips[0] == 0 and leaf_rel[worst_leaf] > leaf_lim[worst_leaf])):
        fail("the float32 kernel path disagrees with the plain path")
    check_launches(k_run["counts"], need, f"{model_name} float32 kernel path")
    check_launches(p_run["counts"], {}, f"{model_name} float32 plain path")
    k_rate, p_rate = (steps - 1) * n / k_run["time"], (steps - 1) * n / p_run["time"]
    print(f"  {model_name} float32 train samples/s at B={n} (steps 2-{steps}, host clock): "
          f"kernel path {k_rate:.1f}, plain path {p_rate:.1f}; peak memory kernel "
          f"{k_run['peak'] / 2**30:.2f} GiB, plain {p_run['peak'] / 2**30:.2f} GiB [{card}]",
          flush=True)
    return {"peak": k_run["peak"], "params": sum(p.numel() for p in model.parameters()),
            "opt_bytes": k_run["opt_bytes"], "metrics": k_metrics, "model": model,
            "rate": k_rate}


class CodeFlips:
    """The int8 codes of every quantize call of a run's first ``steps`` steps (``per_step``
    calls a step, in the port's fixed order), kept on the card from the kernel path's run and
    compared call by call in the plain path's: an ulp upstream (the block kernels against
    their plain versions) that moves a value across a code's midpoint flips the code, and the
    flip moves its element by 1/127 of its row's largest magnitude, so flips cascade through
    the blocks (printed as a count and a share of the step's codes)."""

    def __init__(self, q, per_step: int, steps: int = 2):
        self.q, self.per_step, self.steps = q, per_step, steps
        self.kept, self.flips, self.codes, self.calls, self.inner = [], [], [], 0, None

    def attach(self):
        """Wrap the current ``quantize_rows`` (the kernel's, or inside ``plain_attention`` the
        plain version's): the first run keeps its codes, the second compares with them."""
        self.inner, self.calls = self.q.quantize_rows, 0
        compare = bool(self.kept)
        if compare:
            self.flips, self.codes = [0] * self.steps, [0] * self.steps

        def recorded(x, form="reciprocal"):
            codes, scale = self.inner(x, form)
            step = self.calls // self.per_step
            if step < self.steps:
                if compare:
                    self.flips[step] += int((codes != self.kept[self.calls]).sum())
                    self.codes[step] += codes.numel()
                else:
                    self.kept.append(codes.clone())
            self.calls += 1
            return codes, scale

        self.q.quantize_rows = recorded

    def detach(self):
        self.q.quantize_rows = self.inner
        if self.codes:
            self.kept = []

    def share(self, step: int) -> float:
        return self.flips[step] / self.codes[step] if self.codes else 0.0


def int8_limit(base: float, int8_vs_float: float) -> float:
    """A float32 int8 step's limit, kernel path against plain path: phase 6's ``base`` plus
    ``INT8_SPREAD`` times the same quantity's distance between the int8 step and the float
    step from the same start (the size of the int8 rounding itself). The codes' flips cascade
    (a fifth of them flip by the last block of a 12-block tower), so at worst the two paths
    hold two independent roundings of every value, whose difference is ~sqrt(2) times one
    rounding's."""
    return base + INT8_SPREAD * int8_vs_float


def moe_loss_limit(flips: int, tokens: int) -> float:
    """A step's loss limit, kernel path against plain path, relative: phase 6's 1e-5, plus
    d / tokens when d of the step's routing decisions differ between the paths (a token
    routed elsewhere, or moved past capacity, changes its MLP branch outright)."""
    return 1e-5 + flips / tokens


class RoutingRecorder:
    """The experts each MoE layer of a model chooses, recorded by forward hooks: per forward
    call of each layer, its k rounds of choices [G, S, k] (``top_k_rounds`` of the router's
    probabilities on the layer's input, as the layer takes them)."""

    def __init__(self, torch):
        self.torch, self.handles, self.records, self.layers, self.seq = torch, [], [], 0, 0

    def attach(self, model):
        from multimodal_tpu_torch.models.moe import MoEMLP, top_k_rounds

        layers = [m for m in model.modules() if isinstance(m, MoEMLP)]
        self.layers, self.records = len(layers), []

        def hook(module, inputs, _):
            with self.torch.no_grad():
                probs = module.router_probs(inputs[0])
                self.records.append(self.torch.stack(top_k_rounds(probs, module.top_k), -1))
            self.seq = inputs[0].shape[1]

        self.handles = [m.register_forward_hook(hook) for m in layers]

    def detach(self) -> list:
        for h in self.handles:
            h.remove()
        self.handles, records = [], self.records
        return records

    def step_records(self, records: list, step: int) -> list:
        """One train step's records: one forward call of each layer (no remat)."""
        return records[step * self.layers:(step + 1) * self.layers]

    def flips(self, a: list, b: list, step: int) -> int:
        return routing_flips(self.step_records(a, step), self.step_records(b, step))

    def decisions(self, records: list, step: int) -> int:
        return sum(r.numel() for r in self.step_records(records, step))


def routing_flips(a: list, b: list) -> int:
    """Routing decisions (token, round, layer) whose chosen expert differs between two
    runs' records."""
    return int(sum(int((x != y).sum()) for x, y in zip(a, b)))


def kernel_path_run(torch, tally, card, model_name, dtype, n, steps, need, falling=False,
                    block_mlp=False, variational=None, model_kw=None, prepare=None,
                    stats=None, **step_kw) -> list:
    """``steps`` steps on the kernel path alone: finite (and with ``falling`` a loss that
    falls on the fixed batch), the launch counts, samples/s and peak memory (also put into
    ``stats``, a dict, as ``rate`` and ``peak``). ``variational``, ``model_kw``, ``prepare``
    and ``step_kw`` as in ``compare_paths``. Returns the per-step metrics."""
    name = str(dtype).replace("torch.", "")
    model = build_model(torch, model_name, dtype, block_mlp, variational, model_kw, prepare)
    model_name = model_label(model_name, block_mlp, variational, model_kw)
    batch = make_batch(torch, model.cfg, n)
    run = train_steps(torch, tally, model, batch, steps, **step_kw)
    metrics = run["metrics"]
    losses = [m["loss"] for m in metrics]
    norms = [m["grad_norm"] for m in metrics]
    print(f"  {name} losses {[round(v, 7) for v in losses]} grad norms "
          f"{[round(v, 4) for v in norms]}", flush=True)
    rate = (steps - 1) * n / run["time"]
    if stats is not None:
        stats.update(rate=rate, peak=run["peak"])
    print(f"  {model_name} {name} train samples/s at B={n} (steps 2-{steps}, host clock): "
          f"{rate:.1f}; peak memory {run['peak'] / 2**30:.2f} GiB [{card}]", flush=True)
    if not (np.isfinite(losses).all() and np.isfinite(norms).all()):
        fail(f"non-finite {name} loss or grad norm")
    if falling and not losses[-1] < losses[0]:
        fail(f"the {name} loss did not fall over {steps} steps on a fixed batch")
    check_launches(run["counts"], need, f"{model_name} {name} kernel path")
    del model, batch
    torch.cuda.empty_cache()
    return metrics


def largest_batch(torch, peak_at_compare: int, n_params: int, compare_batch: int,
                  candidates=(64, 128, 256)) -> int:
    """The largest of ``candidates`` the float32 kernel path holds, reckoned before running
    it: parameters, gradients and two moments stay (16 bytes a parameter); what the measured
    peak at ``compare_batch`` holds beyond them grows with the batch; 15% to spare."""
    static = 16 * n_params
    per_sample = (peak_at_compare - static) / compare_batch
    total = torch.cuda.mem_get_info()[1]
    fits = [b for b in candidates if static + 1.15 * per_sample * b <= total]
    print(f"  reckoned: {static / 2**30:.2f} GiB static + {per_sample / 2**20:.1f} MiB per sample "
          f"(from the measured peak at B={compare_batch}) against {total / 2**30:.1f} GiB "
          f"-> {({b: round((static + per_sample * b) / 2**30, 1) for b in candidates})} GiB; "
          f"largest batch with 15% to spare: {max(fits)}", flush=True)
    return max(fits)


def register_variant(name: str, base: str, vision: dict | None = None,
                     text: dict | None = None, **top):
    """Register config ``name``: the shipped config ``base`` with ``top`` set at its top level,
    ``vision`` in its vision tower and ``text`` in its text tower."""
    from multimodal_tpu_torch import paths
    from multimodal_tpu_torch.models import add_model_config

    with open(os.path.join(paths.CONFIG_DIR, base + ".json")) as f:
        cfg = json.load(f)
    cfg.update(top)
    cfg["vision_cfg"].update(vision or {})
    cfg["text_cfg"].update(text or {})
    add_model_config(name, cfg)


def phase_vclip_encode(torch, mods, tally, card, n: int):
    """The variational model's eval-mode encode at batch ``n`` in float32, kernel path
    against plain path: the means at cosine >= 0.9999, the concentrations within 1e-4
    relative, >= 12 block-forward launches per tower encode; the model is handed over in
    training mode, and the encode must give it back in that mode."""
    from multimodal_tpu_torch.data.preprocess import normalize_images
    from multimodal_tpu_torch.inference import model_mode
    from multimodal_tpu_torch.models import create_model

    model = create_model(MODEL, variational=True, seed=0).train()
    batch = make_batch(torch, model.cfg, n)
    images = normalize_images(batch["image"])

    def encode(tower):
        with model_mode(model, False), torch.inference_mode():
            out = (model.encode_image(images) if tower == "image"
                   else model.encode_text(batch["text"]))
        torch.cuda.synchronize()
        return out

    got, counts = {}, {}
    for tower in ("image", "text"):
        tally.start()
        got[tower] = encode(tower)
        counts[tower] = tally.stop()["block_attention_fwd"]
    with plain_attention(mods):
        want = {tower: encode(tower) for tower in ("image", "text")}
    if not model.training:
        fail("the eval-mode encode did not give the model back in training mode")
    for tower in ("image", "text"):
        (mean, conc), (p_mean, p_conc) = got[tower], want[tower]
        ok_shape = mean.shape == (n, model.cfg.embed_dim) and conc.shape == (n,)
        finite = bool(torch.isfinite(mean).all() and torch.isfinite(conc).all())
        cos = torch.nn.functional.cosine_similarity(mean, p_mean, dim=-1).min().item()
        rel = ((conc - p_conc).abs() / p_conc.abs()).max().item()
        print(f"  encode {tower} B={n} float32 kernel vs plain: min cosine of the means "
              f"{cos:.7f} (need >= 0.9999), concentration rel diff {rel:.3e} (need <= 1e-4), "
              f"concentrations {conc.min().item():.2f}-{conc.max().item():.2f}, block forward "
              f"launches {counts[tower]} (need >= 12)", flush=True)
        if not (ok_shape and finite) or cos < 0.9999 or rel > 1e-4 or counts[tower] < 12:
            fail(f"the variational {tower} encode: shapes {tuple(mean.shape)} "
                 f"{tuple(conc.shape)}, finite {finite}, or kernel vs plain disagree")
    del model, batch, images, got, want
    torch.cuda.empty_cache()


def phase_vclip_train(torch, mods, tally, card):
    """The recipe's loss through the kernels: float32 against the plain path, bfloat16 at
    two batches, then two float32 steps of vMF and of the Gaussian mode."""
    from multimodal_tpu_torch.models import VariationalConfig

    spherical, gaussian = VariationalConfig(), VariationalConfig(model_type="Gaussian")
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    step_kw = dict(loss_type="vclip", loss_kwargs=VCLIP_LOSS, opt_kw=VCLIP_OPT)
    compare_paths(torch, mods, tally, card, MODEL, VCLIP_BATCH, TRAIN_STEPS, need,
                  variational=spherical, **step_kw)
    torch.cuda.empty_cache()
    for n in (VCLIP_BATCH, TRAIN_BATCH):
        metrics = kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, n, TRAIN_STEPS,
                                  need, falling=True, variational=spherical, **step_kw)
        print(f"  bfloat16 B={n} terms of step 1: " + ", ".join(
            f"{k}={metrics[0][k]:.5g}" for k in ("clip_loss", "image_kl_loss", "text_kl_loss",
                                                "var_reg", "mean_image_concentration",
                                                "mean_text_concentration")), flush=True)
    for vcfg, family in ((spherical, "vmf"), (gaussian, "normal")):
        print(f"  {family} ({vcfg.model_type}), float32, 2 steps", flush=True)
        metrics = kernel_path_run(torch, tally, card, MODEL, torch.float32, VCLIP_BATCH, 2, need,
                                  variational=vcfg, loss_type="vclip", opt_kw=VCLIP_OPT,
                                  loss_kwargs=dict(VCLIP_LOSS, distribution_type=family))
        if not all(np.isfinite(list(m.values())).all() for m in metrics):
            fail(f"non-finite metrics in the {family} run: {metrics}")
        lowest = min(min(m["mean_image_concentration"], m["mean_text_concentration"])
                     for m in metrics)
        if family == "vmf" and lowest < vcfg.min_concentration:
            fail(f"vMF concentration {lowest} below the minimum {vcfg.min_concentration}")


def phase_lora(torch, mods, tally, card, full_opt_bytes: int):
    """A LoRA fine-tune of a loaded base: ViT-B/32 built with r=8 adapters, every base weight
    from an OpenAI-format state dict exported from a seeded model without adapters, trained in
    the "lora" freeze mode; float32 kernel path against plain path at B=256 (24 launches of
    each block kernel a step, every frozen parameter bit for bit unchanged), bfloat16 at
    B=256; then the adapters merged into a model without them, whose encodes at bucket 256
    must match the adapted model's (cosine >= 0.9999)."""
    from multimodal_tpu_torch.inference import Embedder
    from multimodal_tpu_torch.models import (
        create_model, export_openai_state_dict, load_openai_state_dict, merge_lora)

    base = export_openai_state_dict(create_model(MODEL, seed=1))
    torch.cuda.empty_cache()
    prepare = lambda model: load_openai_state_dict(model, base)  # noqa: E731
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, need,
                        model_kw=LORA, prepare=prepare, freeze="lora")
    model = res["model"]
    n_train = sum(p.numel() for p in model.parameters() if p.requires_grad)
    print(f"  optimizer state (fused AdamW moments, float32): {res['opt_bytes'] / 2**20:.2f} MiB "
          f"for {n_train} trainable of {res['params']} parameters; phase 6's full model "
          f"{full_opt_bytes / 2**20:.2f} MiB ({full_opt_bytes / res['opt_bytes']:.1f}x)",
          flush=True)
    merged = merge_lora(model, cfg=model.cfg, into=create_model(MODEL, seed=2))
    rng = np.random.default_rng(3)
    size, ctx = model.cfg.vision.image_size, model.cfg.text.context_length
    images = rng.integers(0, 256, (TRAIN_BATCH, size, size, 3), dtype=np.uint8)
    tokens = rng.integers(1, model.cfg.text.vocab_size - 1, (TRAIN_BATCH, ctx))
    tokens[:, -1] = model.cfg.text.vocab_size - 1
    cos = {}
    for tower in ("image", "text"):
        enc = [Embedder(m).encode_images(images) if tower == "image"
               else Embedder(m).encode_tokens(tokens) for m in (model, merged)]
        cos[tower] = float(np.sum(enc[0] * enc[1], -1).min())
    lora_b = max(p.abs().max().item() for n, p in model.named_parameters()
                 if n.endswith("lora_b"))
    print(f"  merged (lora_rank=0) vs adapted encode at bucket {TRAIN_BATCH}: min cosine image "
          f"{cos['image']:.7f} text {cos['text']:.7f} (need >= 0.9999); max |lora_b| after "
          f"training {lora_b:.3e}", flush=True)
    if min(cos.values()) < 0.9999 or lora_b == 0.0:
        fail("the merged model's encodes disagree with the adapted model's, or the adapters "
             "did not train")
    del res, model, merged
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS, need,
                    falling=True, model_kw=LORA, prepare=prepare, freeze="lora")


def phase_moe(torch, mods, tally, card):
    """The MoE vision tower: ViT-B/32 with 8 experts, top-2, capacity factor 1.25 on every
    second vision block (6 MoE blocks, 15 slots an expert an image); float32 kernel path
    against plain path at B=256 with the routing-flip rule, the aux term finite and its mean
    per layer and round in [1, 8]; then bfloat16 at B=256."""
    register_variant(MOE_MODEL, MODEL, vision=MOE_VISION)
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    routing = RoutingRecorder(torch)
    res = compare_paths(torch, mods, tally, card, MOE_MODEL, TRAIN_BATCH, TRAIN_STEPS, need,
                        routing=routing)
    rounds = routing.layers * MOE_VISION["moe_top_k"]
    aux = [m["moe_aux_loss"] for m in res["metrics"]]
    print(f"  moe_aux_loss per step {[round(v, 5) for v in aux]}: {routing.layers} layers x "
          f"top-{MOE_VISION['moe_top_k']}, per layer and round "
          f"{[round(v / rounds, 4) for v in aux]} (need finite, in [1, "
          f"{MOE_VISION['moe_experts']}])", flush=True)
    if routing.layers != 6 or not all(
            np.isfinite(v) and 1.0 <= v / rounds <= MOE_VISION["moe_experts"] for v in aux):
        fail("the MoE aux loss is off its range")
    del res
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MOE_MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS,
                    need, falling=True)


def phase_siglip(torch, mods, tally, card):
    """``create_model(MODEL, siglip=True)`` under the SigLIP loss: float32 kernel path against
    plain path at B=256, the logit bias moving from -10; bfloat16 at B=256, finite, its loss
    falling below step 1's and every step's loss within 2e-2 of the float32 kernel path's
    (``siglip_tracks``). On this batch both float32 paths' losses rise again at step 6, alike
    (a SigLIP property of the fixed batch under phase 6's optimizer), so the bfloat16 run is
    held to that trajectory rather than to a last loss below the first."""
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    kw = dict(model_kw={"siglip": True}, loss_type="siglip")
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, need, **kw)
    bias = [m["logit_bias"] for m in res["metrics"]]
    print(f"  logit_bias per step {[round(v, 6) for v in bias]} (from -10), logit_scale "
          f"{[round(m['logit_scale'], 6) for m in res['metrics']]}", flush=True)
    if bias[-1] == -10.0:
        fail("the SigLIP logit bias did not move")
    f32 = [m["loss"] for m in res["metrics"]]
    del res
    torch.cuda.empty_cache()
    bf16 = [m["loss"] for m in kernel_path_run(torch, tally, card, MODEL, torch.bfloat16,
                                               TRAIN_BATCH, TRAIN_STEPS, need, **kw)]
    ok, worst = siglip_tracks(bf16, f32)
    print(f"  bfloat16 vs float32 kernel path, step by step: worst loss rel diff {worst:.3e} "
          f"(need <= 2e-2); lowest bfloat16 loss of steps 2-{TRAIN_STEPS} {min(bf16[1:]):.7f} "
          f"(need < step 1's {bf16[0]:.7f})", flush=True)
    if not ok:
        fail("the bfloat16 SigLIP run left the float32 trajectory or its loss did not fall")


def siglip_tracks(bf16: list, f32: list) -> tuple[bool, float]:
    """The bfloat16 run's losses against the float32 kernel path's of the same steps: each
    within 2e-2 relative (phase 3's bfloat16 limit), and some step after the first below the
    first. Returns (held, the worst relative difference)."""
    worst = max(abs(a - b) / abs(b) for a, b in zip(bf16, f32))
    return worst <= 2e-2 and min(bf16[1:]) < bf16[0], worst


def phase_hires(torch, mods, tally, card):
    """ViT-B/32 built at 384 px (``force_image_size``): the vision tower at S=145 through the
    LN-fold kernels, 12 launches each a step, the text tower at S=77 through the others;
    float32 kernel path against plain path for 2 steps at B=128, then bfloat16 rates."""
    need = {"block_attention_ln_fwd": 12, "block_attention_ln_bwd": 12,
            "block_attention_fwd": 12, "block_attention_bwd": 12}
    del compare_paths(torch, mods, tally, card, MODEL, HIRES_BATCH, 2, need,
                      model_kw=HIRES)["model"]
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, HIRES_BATCH, TRAIN_STEPS, need,
                    falling=True, model_kw=HIRES)


def phase_int8(torch, mods, tally, card, kind, float_rate: float):
    """ViT-B/32 at full width and depth built with ``int8_forward=True``, B=256: every dense
    MLP of both towers on the SwitchBack GEMMs (the row-quantize and rescale kernels around
    ``torch._int_mm``), the block-attention kernels as in phase 6. float32 kernel path against
    plain path, the flipped codes counted (``CodeFlips``) and the limits widened by
    ``int8_limit``; then bfloat16 in turns with the bfloat16 step without int8 (A, B, B, A, A,
    B), each 6 steps, finite and falling: samples/s over
    steps 2-6 and peak memory, the A/B; then the W8A8 encoders (``--quantized``) behind the
    HTTP server, held to the float32 encode (cosine > 0.99) and to the plain-version encode
    (cosine >= 0.9999), their encodes/s at bucket 256 and single-request p50."""
    float_need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    # the float step from the same start (phase 6's kernel path, 2 steps): how far the int8
    # rounding itself moves each held quantity, the measure of ``int8_limit``
    model = build_model(torch, MODEL, torch.float32)
    reference = train_steps(torch, tally, model, make_batch(torch, model.cfg, TRAIN_BATCH), 2,
                            grads_at=0, count=False)
    del model
    code_flips = CodeFlips(mods["q"], per_step=INT8_NEED["quantize_rows"])
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, INT8_NEED,
                        model_kw=INT8, code_flips=code_flips, int8_reference=reference)
    del reference
    print(f"  float32 int8 vs phase 6's float32 kernel path in this call: {res['rate']:.1f} vs "
          f"{float_rate:.1f} samples/s ({res['rate'] / float_rate:.3f}x) [{card}]", flush=True)
    del res
    torch.cuda.empty_cache()
    arms = {"bfloat16": [], "bfloat16 int8": []}
    for i in range(2 * AB_RUNS):  # A, B, B, A, A, B
        arm = list(arms)[(i + i // 2) % 2]
        stats = {}
        int8 = arm.endswith("int8")
        kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS,
                        INT8_NEED if int8 else float_need, falling=True,
                        model_kw=INT8 if int8 else None, stats=stats)
        arms[arm].append(stats)
    mean = {arm: float(np.mean([r["rate"] for r in runs])) for arm, runs in arms.items()}
    peak = {arm: max(r["peak"] for r in runs) / 2**30 for arm, runs in arms.items()}
    print(f"  A/B bfloat16 B={TRAIN_BATCH}, in turns: int8 {mean['bfloat16 int8']:.1f} "
          f"({', '.join(f'{r['rate']:.1f}' for r in arms['bfloat16 int8'])}) vs without int8 "
          f"{mean['bfloat16']:.1f} ({', '.join(f'{r['rate']:.1f}' for r in arms['bfloat16'])}) "
          f"samples/s: {mean['bfloat16 int8'] / mean['bfloat16']:.3f}x; peak memory "
          f"{peak['bfloat16 int8']:.2f} vs {peak['bfloat16']:.2f} GiB [{card}]", flush=True)
    per_encode = {"quantize_rows": 73, "int8_rescale": 73}  # 12 blocks x 6 products + 1
    phase_serving(torch, mods, tally, card, kind, MODEL, need_text=per_encode,
                  need_image=per_encode, quantized=True)


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
    from multimodal_tpu_torch.ops import flash_attention as fl
    from multimodal_tpu_torch.ops import fused_attention as fa
    from multimodal_tpu_torch.ops import quant as q

    mods = {"ba": ba, "fa": fa, "bm": bm, "fl": fl, "q": q, "layers": layers,
            "attention": attention}
    tally = Tally(launches)

    t0 = time.perf_counter()
    lib_path, log = _build.build()
    _build.load()
    print(f"phase 2 build: {time.perf_counter() - t0:.2f} s -> {lib_path}", flush=True)
    for ln in ptxas_report(log):
        print(f"  ptxas {ln}")
    for ln in pass_smem_report():
        print(f"  smem {ln}")
    sass = read_sass(lib_path)
    if sass is None:
        print("  sass: cuobjdump not found beside nvcc, SASS not read", flush=True)
    else:
        print(f"  sass {sass_report(sass)}")
        for ln in hmma_report(sass):
            print(f"  sass {ln}", flush=True)
        faults = gemm_hmma_faults(sass)
        if faults:
            fail(f"GEMM instantiations off their tensor-core form: {faults}")

    print("phase 3 kernel vs plain on the card", flush=True)
    kernels = phase_kernels(torch, ba, fa, bm, fl)
    qkv_repeats(torch, ba)
    err = flash_long_error(torch, fl)
    kernels["worst_f32"]["flash_attention_fwd"] = max(kernels["worst_f32"]["flash_attention_fwd"],
                                                      err)
    flash_crossover(torch, attention.attention, card)
    int8_kernels = phase_quant_kernels(torch, q)
    for part in ("worst_f32", "timing"):
        kernels[part].update(int8_kernels[part])

    print("phase 4 serving, phase 5 throughput", flush=True)
    phase_serving(torch, mods, tally, card, kind, MODEL,
                  need_text={"block_attention_fwd": 12}, need_image={"block_attention_fwd": 12})

    print("phase 6 training", flush=True)
    need = {"block_attention_fwd": 24, "block_attention_bwd": 24}
    res = compare_paths(torch, mods, tally, card, MODEL, TRAIN_BATCH, TRAIN_STEPS, need)
    full_opt_bytes, float_rate = res["opt_bytes"], res["rate"]
    del res
    torch.cuda.empty_cache()
    kernel_path_run(torch, tally, card, MODEL, torch.bfloat16, TRAIN_BATCH, TRAIN_STEPS, need,
                    falling=True)

    print(f"phase 7 shared trunk: {SHARED_MODEL} at full width", flush=True)
    phase_serving(torch, mods, tally, card, kind, SHARED_MODEL,
                  need_text={"block_attention_fwd": 12},
                  need_image={"block_attention_ln_fwd": 12})
    need = {"block_attention_ln_fwd": 12, "block_attention_ln_bwd": 12,
            "block_attention_fwd": 12, "block_attention_bwd": 12}
    res = compare_paths(torch, mods, tally, card, SHARED_MODEL, SHARED_COMPARE_BATCH,
                        TRAIN_STEPS, need)
    del res["model"]
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, res["peak"], res["params"], SHARED_COMPARE_BATCH)
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
    res = compare_paths(torch, mods, tally, card, SHARED_MODEL, SHARED_COMPARE_BATCH,
                        TRAIN_STEPS, need, block_mlp=True)
    del res["model"]
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, res["peak"], res["params"], SHARED_COMPARE_BATCH)
    metrics = kernel_path_run(torch, tally, card, SHARED_MODEL, torch.float32, rate_batch,
                              TRAIN_STEPS, need, block_mlp=True)
    kernel_path_run(torch, tally, card, SHARED_MODEL, torch.bfloat16, rate_batch, TRAIN_STEPS,
                    need, falling=True, block_mlp=True)
    # per-block remat: every forward kernel runs again inside the backward, and nothing else
    # changes, so the losses repeat those of the run above
    register_variant(REMAT_MODEL, SHARED_MODEL, remat=True)
    print(f"  {REMAT_MODEL}: {SHARED_MODEL} with remat", flush=True)
    remat_need = {k: v * (2 if k.endswith("fwd") else 1) for k, v in need.items()}
    remat_metrics = kernel_path_run(torch, tally, card, REMAT_MODEL, torch.float32,
                                    rate_batch, TRAIN_STEPS, remat_need, block_mlp=True)
    remat_rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(remat_metrics[:2], metrics[:2]))
    print(f"  remat vs no remat at B={rate_batch}: loss rel diff over the first 2 steps "
          f"{remat_rel:.3e} (need <= 1e-6); launches per step {remat_need}", flush=True)
    if remat_rel > 1e-6:
        fail("the remat run's losses differ from the run without remat")

    register_variant(LONG_MODEL, MODEL, text={"context_length": LONG_CONTEXT})
    print(f"phase 9 long context: {LONG_MODEL} ({MODEL}, text context_length {LONG_CONTEXT}) "
          f"at full width", flush=True)
    flash_need = {"flash_attention_fwd": 12, "flash_attention_dq": 12, "flash_attention_dkv": 12}
    phase_serving(torch, mods, tally, card, kind, LONG_MODEL,
                  need_text={"flash_attention_fwd": 12}, need_image={"block_attention_fwd": 12},
                  bucket=LONG_BUCKET)
    need = {"block_attention_fwd": 12, "block_attention_bwd": 12, **flash_need}
    res = compare_paths(torch, mods, tally, card, LONG_MODEL, LONG_COMPARE_BATCH, TRAIN_STEPS,
                        need)
    del res["model"]
    torch.cuda.empty_cache()
    rate_batch = largest_batch(torch, res["peak"], res["params"], LONG_COMPARE_BATCH,
                               candidates=(8, 16, 32))
    if rate_batch != LONG_COMPARE_BATCH:
        kernel_path_run(torch, tally, card, LONG_MODEL, torch.float32, rate_batch, TRAIN_STEPS,
                        need)
    kernel_path_run(torch, tally, card, LONG_MODEL, torch.bfloat16, rate_batch, TRAIN_STEPS,
                    need, falling=True)
    # cosine attention keeps the vision blocks on the plain attention path and the pooler's
    # cross-attention (256 queries over 50 tokens) is plain too: only the text tower's block
    # kernels launch
    register_variant(OPTIONS_MODEL, MODEL, vision={"scaled_cosine": True,
                                                   "attentional_pool": True})
    print(f"  {OPTIONS_MODEL}: {MODEL} with vision.scaled_cosine and vision.attentional_pool",
          flush=True)
    kernel_path_run(torch, tally, card, OPTIONS_MODEL, torch.float32, 64, TRAIN_STEPS,
                    {"block_attention_fwd": 12, "block_attention_bwd": 12}, falling=True)

    print(f"phase 10 variational CLIP: {MODEL} at full width and depth, a concentration token "
          "on each tower (vision S=51, text S=78 causal)", flush=True)
    phase_vclip_encode(torch, mods, tally, card, TRAIN_BATCH)
    phase_vclip_train(torch, mods, tally, card)

    print(f"phase 11 the rest of the model family: {MODEL} at full width and depth", flush=True)
    print(f"  LoRA fine-tune (r={LORA['lora_rank']}, alpha {LORA['lora_alpha']:g}) of a loaded "
          "base", flush=True)
    phase_lora(torch, mods, tally, card, full_opt_bytes)
    print(f"  {MOE_MODEL}: {MODEL} with vision {MOE_VISION}", flush=True)
    phase_moe(torch, mods, tally, card)
    print(f"  SigLIP: {MODEL} with siglip=True, loss_type siglip", flush=True)
    phase_siglip(torch, mods, tally, card)
    print(f"  {MODEL} with force_image_size={HIRES['force_image_size']}: vision S=145 through "
          "the LN-fold kernels", flush=True)
    phase_hires(torch, mods, tally, card)

    print(f"phase 12 int8: {MODEL} at full width and depth with int8_forward=True, and the W8A8 "
          "encoders", flush=True)
    phase_int8(torch, mods, tally, card, kind, float_rate)

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
