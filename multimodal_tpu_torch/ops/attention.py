"""Plain multi-head attention (port of ``multimodal_tpu/ops/attention.py:_xla_attention``):
the path for shapes the block-attention kernel does not take, such as width 64.

Layout is ``[batch, seq, heads, head_dim]``. Logits and softmax run in f32; masked logits
take the finite -1e30 (a fully masked row becomes uniform rather than NaN) and the causal
mask is bottom-right aligned (``tril(diagonal=sk - sq)``)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
              mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v: [B, S, H, D]; mask: optional additive, broadcastable to [B, H, Sq, Sk].
    Returns [B, Sq, H, D] in v.dtype."""
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
