"""Where one training step's device time goes, by kernel family.

    python -m multimodal_tpu_torch.profile_step --model ViT-B-16 --batch 64 --dtype float32

Builds the model with seeded weights on the GPU, runs a few warm steps of
``make_train_step`` on a fixed synthetic uint8 batch, then traces ``--steps`` more with
``torch.profiler`` and sums the CUDA kernels' device time per step into families: the
hand-written kernels by name, cuBLAS GEMMs, elementwise passes, reductions, copies. Prints
the card's name and power limit, the table, the device total and the host wall time per
step (their ratio is the device's busy share), the three largest kernels that no family
claims and the eight largest library GEMM kernels by name. ``--scale-heads`` turns on
``vision.scale_heads``, which sends the vision pass through the fused attention pair.
``--ln-fold-min-seq N`` moves the sequence length above which the block operator folds the
LayerNorm and the residual into its kernels (0: every call folds; 320: none does), to
measure one step either way. ``--block-mlp`` builds the model with ``block_mlp=True``, so
that every block's MLP half runs the fused operator's kernels; ``--remat`` checkpoints every
block; ``--int8`` builds it with ``int8_forward=True`` (every dense MLP on the SwitchBack
int8 GEMMs: the row-quantize kernel and the wgmma int8 GEMM with its rescale);
``--state-dtype bfloat16`` keeps the AdamW moments in bfloat16 (bench.py's choice for the
ViT-H/14 and ViT-g/14 steps).
``--context-length N`` sets the text tower's context length (from 2048 up every text block
runs the flash-attention kernels):

    python -m multimodal_tpu_torch.profile_step --model ViT-B-32 --context-length 2048 --batch 8
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import time

import numpy as np
import torch

from multimodal_tpu_torch.ops._build import gemm_sets, gemm_signature

# the tensor-core GEMMs' instantiations by (form, load, store), read from the kernel name's
# template arguments; the first match wins, None matches anything. mma_gemm_kernel
# (ops/csrc/mma_gemm.cuh) runs the block kernels' and the fused MLP's products in float32;
# wgmma_gemm_kernel (ops/csrc/wgmma_gemm.cuh) both in bfloat16, the block kernels' as the
# instantiations with three operand sets, the block backward's weight gradients with four
# (``gemm_sets``)
BLOCK_WGMMA_FAMILIES = [
    (("TN", None, "serial"),
     "block backward weight gradients, bfloat16 (wgmma_gemm_kernel TN x4, serial store: a^T dq, "
     "a^T dk, a^T dv, attnpre^T dy in one launch)"),
    (("NN", None, None),
     "block q/k/v and out-projection GEMMs (wgmma_gemm_kernel NN x3: the forward's, with the "
     "LN load or the residual store in the LN form, and the backward's q/k/v recompute)"),
    (("NT", None, None),
     "block backward do and dx GEMMs (wgmma_gemm_kernel NT x3: dy Wo^T, [dq|dk|dv] over K=3W)"),
]
WGMMA_FAMILIES = [
    (("NN", "LN", None),
     "fused MLP forward c_fc (wgmma_gemm_kernel NN, LN load, round+act store: h and g)"),
    (("NN", None, None),
     "fused MLP forward c_proj (wgmma_gemm_kernel NN on g, bias-residual or round store)"),
    (("NT", None, "act'"),
     "fused MLP backward dh (wgmma_gemm_kernel NT, act' store, db1 partials)"),
    (("NT", None, None), "fused MLP backward dln (wgmma_gemm_kernel NT, float32 out)"),
    (("TN", None, None),
     "fused MLP weight gradients (wgmma_gemm_kernel TN, act and LN-b loads)"),
]
GEMM_FAMILIES = [
    (("NN", None, "bias-residual"),
     "fused MLP forward c_proj (mma_gemm_kernel NN on g, bias-residual store; without the "
     "residual it is the plain NN form, counted with the block backward's)"),
    (("NN", None, "residual"),
     "block forward GEMMs, float32 (mma_gemm_kernel NN, residual store: q/k/v with or without "
     "the LN load, out projection)"),
    (("NN", "LN", "round+act"),
     "fused MLP forward c_fc (mma_gemm_kernel NN, LN load, round+act store: h and g)"),
    (("NT", None, "act'"), "fused MLP backward dh (mma_gemm_kernel NT, act' store, db1 partials)"),
    (("TN", None, None), "fused MLP weight gradients (mma_gemm_kernel TN, act and LN-b loads)"),
    ((None, None, None),
     "block backward GEMMs, float32 (mma_gemm_kernel: q/k/v recompute, do, dx or g over K=3W; "
     "with block_mlp also the MLP's dln)"),
]
# the backward's dQ and dK/dV kernels in their block form (the block backward's attention half
# at D = 32, 64, 128)
BLOCK_FAMILIES = [
    ("block backward dQ, bfloat16 (fused_dq_kernel in its block form)", ("fused_dq_kernel",)),
    ("block backward dK/dV, bfloat16 (fused_dkv_kernel in its block form)",
     ("fused_dkv_kernel",)),
]
FAMILIES = [  # (family, substrings of the kernel name), first match wins
    ("flash attention forward (flash_fwd_kernel)", ("flash_fwd_kernel",)),
    ("flash attention dQ (flash_dq_kernel; in float32 also the fused backward's)",
     ("flash_dq_kernel",)),
    ("flash attention dK/dV (flash_dkv_kernel; in float32 also the fused backward's)",
     ("flash_dkv_kernel",)),
    ("fused attention backward dQ, bfloat16 (fused_dq_kernel)", ("fused_dq_kernel",)),
    ("fused attention backward dK/dV, bfloat16 (fused_dkv_kernel)", ("fused_dkv_kernel",)),
    ("fused attention backward delta, float32 (fused_delta_kernel)", ("fused_delta_kernel",)),
    ("backward dQ pass (attn_bwd_dq_mma_kernel in bfloat16 at D = 80, 88, 96; _f32_kernel in "
     "float32)", ("attn_bwd_dq_",)),
    ("backward dK/dV pass (attn_bwd_dkv_mma_kernel at D = 80, 88, 96; _f32_kernel)",
     ("attn_bwd_dkv_",)),
    ("fused attention forward, bfloat16 (fused_fwd_kernel; also the block forward's core at "
     "S >= 128)", ("fused_fwd_kernel",)),
    ("forward attention core (attention_mma_kernel, attention_f32_kernel)",
     ("attention_mma_kernel", "attention_f32_kernel")),
    ("LN-fold launches (ln_stats, ln_rows, ln_bwd)", ("ln_stats_kernel", "ln_rows_",
                                                      "ln_bwd_kernel")),
    ("fused MLP bfloat16 GEMM, template arguments not read (wgmma_gemm_kernel)",
     ("wgmma_gemm_kernel",)),
    ("tensor-core GEMM, template arguments not read (mma_gemm_kernel)", ("mma_gemm_kernel",)),
    ("int8 row quantize (quantize_rows_kernel, quantize_columns_kernel)",
     ("quantize_rows_kernel", "quantize_columns_kernel")),
    ("int8 GEMM (int8_gemm_kernel)", ("int8_gemm_kernel",)),
    ("cuBLASLt int8 GEMMs (torch._int_mm)", ("imma", "i8i8", "i8i32", "s8s8", "igemm", "int8")),
    ("cuBLAS GEMMs (MLP, patch embed, projections, weight gradients)",
     ("gemm", "cutlass", "cublas", "xmma", "gemv", "nvjet")),
    ("reductions", ("reduce",)),
    ("copies (memcpy, memset, cat)", ("memcpy", "memset", "cat", "copy")),
    ("elementwise (LN, quick_gelu, casts, adds, the AdamW passes)",
     ("elementwise", "vectorized", "foreach", "multi_tensor", "softmax")),
]


def family_of(kernel_name: str) -> str:
    signature = gemm_signature(kernel_name)
    if signature is not None:
        table = (GEMM_FAMILIES if "wgmma_gemm_kernel" not in kernel_name else
                 BLOCK_WGMMA_FAMILIES if gemm_sets(kernel_name) > 1 else WGMMA_FAMILIES)
        for pattern, family in table:
            if all(p is None or p == v for p, v in zip(pattern, signature[2:])):
                return family
    low = kernel_name.lower()
    # the backward kernels' block form: FusedDqOps<D, keys, 1, pack>, FusedDkvOps<D, 1, pack>
    block_form = (r"Fused(?:Dq|Dkv)Ops<(?:\d+, )+1, [01]>"
                  r"|Fused(?:Dq|Dkv)OpsI(?:Li\d+E)+Li1ELi[01]EE")
    if re.search(block_form, kernel_name):
        for family, keys in BLOCK_FAMILIES:
            if any(k in low for k in keys):
                return family
    for family, keys in FAMILIES:
        if any(k in low for k in keys):
            return family
    return "other"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="ViT-B-16")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--scale-heads", action="store_true")
    ap.add_argument("--ln-fold-min-seq", type=int, default=None)
    ap.add_argument("--block-mlp", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--context-length", type=int, default=None)
    ap.add_argument("--int8", action="store_true")
    ap.add_argument("--state-dtype", default="float32", choices=("float32", "bfloat16"),
                    help="the AdamW moments' dtype (bfloat16: bench.py's for ViT-H/14, g/14)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step needs an NVIDIA GPU (there is no CPU fallback)")

    from multimodal_tpu_torch import paths
    from multimodal_tpu_torch.models import add_model_config, create_model
    from multimodal_tpu_torch.ops import block_attention, launches
    from multimodal_tpu_torch.train import (
        TrainState, make_optimizer, make_schedule, make_train_step)

    if args.ln_fold_min_seq is not None:
        block_attention.LN_FOLD_MIN_SEQ = args.ln_fold_min_seq
    name = args.model
    if args.scale_heads or args.remat or args.context_length:
        with open(os.path.join(paths.CONFIG_DIR, args.model + ".json")) as f:
            cfg = json.load(f)
        if args.scale_heads:
            cfg["vision_cfg"]["scale_heads"] = True
            name += "-scale-heads"
        if args.remat:
            cfg["remat"] = True
            name += "-remat"
        if args.context_length:
            cfg["text_cfg"]["context_length"] = args.context_length
            name += f"-ctx{args.context_length}"
        add_model_config(name, cfg)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    model = create_model(name, dtype=getattr(torch, args.dtype), seed=0,
                         block_mlp=args.block_mlp, int8_forward=args.int8)
    c = model.cfg
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.integers(
            0, 256, (args.batch, c.vision.image_size, c.vision.image_size, 3),
            dtype=np.uint8)).cuda(),
        "text": torch.from_numpy(rng.integers(
            1, c.text.vocab_size - 1, (args.batch, c.text.context_length))).cuda(),
    }
    opt = make_optimizer(model.named_parameters(),
                         make_schedule("cosine", 1e-3, warmup_steps=100, total_steps=10000),
                         weight_decay=0.1, grad_clip_norm=1.0,
                         state_dtype=getattr(torch, args.state_dtype))
    state, step = TrainState.create(model, opt), make_train_step(model, opt)
    for _ in range(args.warmup):
        step(state, batch)
    torch.cuda.synchronize()
    launches.reset_launch_counts()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step(state, batch)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    counts = {k: v // args.steps for k, v in launches.launch_counts().items() if v}

    by_family: dict = {}
    unnamed: dict = {}  # kernels no family claims, by name
    for ev in prof.key_averages():
        # kernels only: an operator's row repeats the time of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        device_us = getattr(ev, "self_device_time_total", None)
        if device_us is None:  # older torch
            device_us = ev.self_cuda_time_total
        if device_us <= 0 or ev.key.startswith("Optimizer.step#"):
            continue  # the optimizer's range on the device repeats its kernels' time
        fam = family_of(ev.key)
        by_family[fam] = by_family.get(fam, 0.0) + device_us / 1e3 / args.steps
        if fam == "other" or fam.startswith("cuBLAS"):
            unnamed[ev.key] = unnamed.get(ev.key, 0.0) + device_us / 1e3 / args.steps
    total = sum(by_family.values())
    print(f"{name} {args.dtype} B={args.batch} block_mlp={args.block_mlp} int8={args.int8} "
          f"moments={args.state_dtype} "
          f"LN fold above S={block_attention.LN_FOLD_MIN_SEQ}: "
          f"device time per train step by kernel family "
          f"(torch.profiler over {args.steps} steps after {args.warmup} warm ones) [{card}]")
    for fam, ms in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {100 * ms / total:5.1f}%  {fam}")
    for label, pick in (("other", lambda k: family_of(k) == "other"),
                        ("cuBLAS", lambda k: family_of(k).startswith("cuBLAS"))):
        picked = [(k, ms) for k, ms in unnamed.items() if pick(k)]
        for key, ms in sorted(picked, key=lambda kv: -kv[1])[:3 if label == "other" else 8]:
            print(f"    {label}: {ms:10.3f} ms  {key[:100]}")
    print(f"  device total {total:.3f} ms, host wall {wall_ms:.3f} ms per step "
          f"({args.batch * 1e3 / wall_ms:.1f} samples/s under the profiler); "
          f"kernel launches per step {counts}")


if __name__ == "__main__":
    main()
