"""How many blocks the fused MLP backward's weight-gradient launches should aim for.

    python -m multimodal_tpu_torch.bench_block_mlp

The backward kernel forms dW1 and dW2 as products over the token rows, split into runs of
rows with one f32 partial sum each (``ops/block_mlp.py:_wgrad_splits``). This script times
the whole backward call (CUDA events) at the B=256 token counts of ViT-B/32, ViT-B/16 and
ViT-L/14 (B=64) for a sweep of the block target ``WGRAD_BLOCKS``, 1 meaning no split, holds
every output to the plain version at each setting, and prints the card's name and power
limit beside the times. It needs an NVIDIA GPU.
"""

from __future__ import annotations

import subprocess

import torch

SHAPES = [  # (name, token rows, width, hidden, act)
    ("B/32 vision", 256 * 50, 768, 3072, "quick_gelu"),
    ("B/32 text", 256 * 77, 512, 2048, "quick_gelu"),
    ("B/16 vision", 256 * 197, 768, 3072, "quick_gelu"),
    ("L/14 vision", 64 * 257, 1024, 4096, "gelu"),
]
TARGETS = (1, 264, 528, 1056, 2112, 4224, 8448)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("bench_block_mlp needs an NVIDIA GPU (there is no CPU fallback)")
    from multimodal_tpu_torch.ops import block_mlp as bm

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    default = bm.WGRAD_BLOCKS
    print(f"block_mlp backward, ms per call by weight-gradient block target "
          f"(default {default}) [{card}]")
    for dtype in (torch.float32, torch.bfloat16):
        for name, t, w, hid, act in SHAPES:
            g = torch.Generator(device="cuda").manual_seed(t + hid)
            rnd = lambda *shape: torch.randn(*shape, generator=g, device="cuda")  # noqa: E731
            x, dy = rnd(t, w).to(dtype), rnd(t, w).to(dtype)
            w1, b1 = (rnd(w, hid) * w ** -0.5).to(dtype), (rnd(hid) * 0.02).to(dtype)
            w2, b2 = (rnd(hid, w) * hid ** -0.5).to(dtype), (rnd(w) * 0.02).to(dtype)
            gamma, beta = 1 + 0.1 * rnd(w), 0.1 * rnd(w)
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
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                for _ in range(3):
                    run()
                start.record()
                for _ in range(8):
                    run()
                end.record()
                torch.cuda.synchronize()
                cells.append(f"{target} (x{bm._wgrad_splits(t, w, hid)}): "
                             f"{start.elapsed_time(end) / 8:.4f}")
            bm.WGRAD_BLOCKS = default
            print(f"  {name} T={t} W={w} H={hid} {str(dtype).replace('torch.', '')}: "
                  + "; ".join(cells), flush=True)


if __name__ == "__main__":
    main()
