"""Multi-head attention compute paths (port of ``multimodal_tpu/ops/attention.py``).

Implementations behind one API:
  * ``fused`` — the whole-sequence kernel pair (``ops/fused_attention.py``) for CLIP-scale
    self-attention (128 <= S <= 512): consumes the packed [B, S, H*D] layout directly and
    never writes the S x S matrix to device memory;
  * ``flash`` — the blocked online-softmax kernels (``ops/flash_attention.py``) for long
    causal sequences (S >= 2048), where the S x S matrix would not fit beside the model;
  * ``xla`` — the plain path (the reference's ``_xla_attention``, so named there): einsum +
    f32 softmax; runs on any device and handles arbitrary masks.
``auto`` takes, for a CUDA tensor without a mask, the fused kernels at a shape they support,
else the flash kernels where ``flash_supported`` holds, and the plain path otherwise, as the
reference takes its kernels only on the accelerator.

Layout is ``[batch, seq, heads, head_dim]``. Logits and softmax run in f32; masked logits
take the finite -1e30 (a fully masked row becomes uniform rather than NaN). The plain
path's causal mask is bottom-right aligned (``tril(diagonal=sk - sq)``), the flash kernels'
top-left (key <= query); they agree for sq == sk, the only case ``auto`` sends to flash."""

from __future__ import annotations

import torch

from multimodal_tpu_torch.ops.flash_attention import flash_attention, flash_supported
from multimodal_tpu_torch.ops.fused_attention import fused_attention, fused_supported

NEG_INF = -1e30


def _plain_attention(q, k, v, causal: bool, mask) -> torch.Tensor:
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32))
    logits = logits * (1.0 / d ** 0.5)
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    if mask is not None:
        logits = logits + torch.clamp(mask.to(logits.dtype), min=NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
              mask: torch.Tensor | None = None, impl: str = "auto") -> torch.Tensor:
    """q, k, v: [B, S, H, D]; mask: optional additive, broadcastable to [B, H, Sq, Sk].
    Returns [B, Sq, H, D] in v.dtype. ``impl``: ``auto``, ``fused``, ``flash`` or ``xla``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if impl not in ("auto", "fused", "flash", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}")
    if impl == "auto":
        impl = "xla"
        if mask is None and q.is_cuda:
            if sq == sk and fused_supported(sk, d):
                impl = "fused"
            elif flash_supported(q.shape, k.shape, causal):
                impl = "flash"
    if impl in ("fused", "flash") and mask is not None:
        raise ValueError(
            f"impl={impl!r} does not support an additive mask — it would be silently "
            "dropped; use impl='xla' (or 'auto', which routes masked calls to the plain path)")
    if impl == "fused" and sq != sk:
        raise ValueError("impl='fused' requires sq == sk (self-attention)")
    if impl == "fused":
        out = fused_attention(q.reshape(b, sq, h * d), k.reshape(b, sk, h * d),
                              v.reshape(b, sk, h * d), heads=h, causal=causal)
        return out.reshape(b, sq, h, d)
    if impl == "flash":
        return flash_attention(q, k, v, causal=causal)
    return _plain_attention(q, k, v, causal, mask)
