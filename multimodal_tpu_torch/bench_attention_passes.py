"""Device time of each of the three attention passes, by shape and dtype.

    python -m multimodal_tpu_torch.bench_attention_passes

The fused attention pair is nothing but the passes of ``ops/csrc/attention_passes.cuh`` (the
forward core; the dQ pass and the dK/dV pass of the backward), which are also the attention
half of the block-attention kernels. This script launches the pair at the shapes the main
paths give the passes (ViT-B/16's S=197, ViT-B/32's S=50 and causal S=77 at B=256, the same
at B=1 as a served request has them, head dims 80 and 128 at longer S), reads each kernel's
device time from ``torch.profiler``, and prints it with the rate it stands for: the forward
forms two products of 2 B H S^2 D FLOPs a head (logits, p v), the dQ pass five (logits
twice, dp twice or p v, ds k), the dK/dV pass four (half of each under the causal mask).
``F.scaled_dot_product_attention``, forward and backward, is timed beside them with CUDA
events; the port never calls it. It needs an NVIDIA GPU.
"""

from __future__ import annotations

import subprocess

import torch

SHAPES = [  # (batch, seq, heads, head_dim, causal)
    (256, 197, 12, 64, False), (256, 50, 12, 64, False), (256, 77, 8, 64, True),
    (1, 197, 12, 64, False), (1, 50, 12, 64, False), (1, 77, 8, 64, True),
    (64, 257, 16, 80, False), (32, 512, 8, 128, True),
]
PASSES = (("forward", "attention_", 2), ("dQ", "attn_bwd_dq_", 5), ("dK/dV", "attn_bwd_dkv_", 4))
ROUNDS = 10


def events_ms(fn) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(ROUNDS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ROUNDS


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_attention_passes needs an NVIDIA GPU (there is no CPU fallback)")
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from multimodal_tpu_torch.ops import fused_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"attention passes, device ms per launch (TFLOP/s) and SDPA forward / backward ms "
          f"[{card}]")
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, h, d, causal in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(s)
            q, k, v, do = (torch.randn(b, s, h * d, generator=g, device="cuda").to(dtype)
                           for _ in range(4))
            kw = dict(heads=h, causal=causal)

            def pair():
                fa.fused_attention(q, k, v, **kw)
                fa.fused_attention_bwd(q, k, v, do, **kw)

            for _ in range(3):
                pair()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(ROUNDS):
                    pair()
                torch.cuda.synchronize()
            unit = 2 * b * h * s * s * d * (0.5 if causal else 1.0)  # FLOPs of one product
            cells = []
            for name, key, products in PASSES:
                us = sum(e.device_time_total for e in prof.key_averages() if key in e.key)
                ms = us / ROUNDS / 1e3
                cells.append(f"{name} {ms:.4f} ({products * unit / ms / 1e9:.1f})")
            heads_first = lambda t: t.view(b, s, h, d).transpose(1, 2)  # noqa: E731
            leaves = [heads_first(t).detach().requires_grad_() for t in (q, k, v)]
            out = F.scaled_dot_product_attention(*leaves, is_causal=causal)
            lib_fwd = events_ms(lambda: F.scaled_dot_product_attention(
                *(t.detach() for t in leaves), is_causal=causal))
            lib_bwd = events_ms(lambda: torch.autograd.grad(out, leaves, heads_first(do),
                                                            retain_graph=True))
            name = str(dtype).replace("torch.", "")
            print(f"  {name:<8} B={b:<3} S={s:<3} H={h:<2} D={d:<3} causal={causal!s:<5} "
                  f"{'; '.join(cells)}; SDPA {lib_fwd:.4f} / {lib_bwd:.4f}", flush=True)


if __name__ == "__main__":
    main()
