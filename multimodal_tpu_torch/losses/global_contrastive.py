"""Chunked InfoNCE for a large contrastive batch on one device (port of
``multimodal_tpu/losses/global_contrastive.py``: ``chunked_clip_loss`` and
``_streaming_ce``).

The dense loss builds a ``[B, B]`` logits matrix per direction; at a large batch that matrix
is the memory bottleneck. Here each direction's logsumexp is accumulated over chunks of the
keys in a Python loop whose every chunk body runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the body's ``[B, chunk]``
logits are freed after the forward and recomputed in the backward, so peak logits memory is
one block in both passes. Values and gradients are the dense loss's up to summation order;
label smoothing streams the mean logit beside the logsumexp.

Not ported yet: ``ring_clip_loss`` and the mesh-sharded form (``axis_name``), ROADMAP Queue
1 item 9, which raise ``NotImplementedError``."""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from multimodal_tpu_torch.losses.clip_loss import LOGIT_CLAMP, _clamped_scale, _l2norm, _no_mesh


def _chunk_body(queries, key_chunk, scale, m, s, lsum):
    """Fold one ``[B, chunk]`` block of logits into the running max ``m``, the rescaled sum
    of exponentials ``s`` and the sum of logits ``lsum``."""
    logits = scale * queries @ key_chunk.T
    m_new = torch.maximum(m, logits.max(dim=-1).values)
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    return m_new, s, lsum + logits.sum(dim=-1)


def _streaming_ce(queries: torch.Tensor, keys: torch.Tensor, scale, pos_logits: torch.Tensor,
                  chunk: int, label_smoothing: float) -> torch.Tensor:
    """Mean CE of ``queries`` [B, E] against all ``keys`` [N, E] (N a multiple of ``chunk``);
    ``pos_logits`` [B] is each row's positive logit. The carries start at (-inf, 0, 0) in
    float32."""
    n = keys.shape[0]
    zero = torch.zeros(queries.shape[0], dtype=torch.float32, device=queries.device)
    m, s, lsum = zero - torch.inf, zero, zero
    for key_chunk in keys.reshape(n // chunk, chunk, -1).unbind(0):
        m, s, lsum = checkpoint(_chunk_body, queries, key_chunk, scale, m, s, lsum,
                                use_reentrant=False)
    lse = m + torch.log(s)
    nll = lse - pos_logits
    if label_smoothing > 0.0:
        smooth = lse - lsum / n  # -mean_j log p_j
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll.mean()


def chunked_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, *, chunk_size: int = 1024,
                      label_smoothing: float = 0.0, normalize: bool = True,
                      scale_is_log: bool = True,
                      axis_name: Optional[str] = None) -> torch.Tensor:
    """Exact symmetric InfoNCE with O(B x chunk) peak logits memory in forward and backward.
    A ``chunk_size`` that does not divide the batch shrinks to the largest divisor below
    it."""
    _no_mesh(axis_name)
    if normalize:
        image_features = _l2norm(image_features.to(torch.float32))
        text_features = _l2norm(text_features.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP) if scale_is_log else logit_scale
    n = text_features.shape[0]
    chunk = min(chunk_size, n)
    while n % chunk:
        chunk -= 1
    pos = scale * torch.sum(image_features * text_features, dim=-1)
    loss_i = _streaming_ce(image_features, text_features, scale, pos, chunk, label_smoothing)
    loss_t = _streaming_ce(text_features, image_features, scale, pos, chunk, label_smoothing)
    return 0.5 * (loss_i + loss_t)


def ring_clip_loss(*args, **kwargs):
    """The ring-streamed loss runs inside a mesh of devices; not ported yet."""
    raise NotImplementedError("ring_clip_loss (the ring-streamed contrastive loss over a mesh) "
                              "is not ported yet (ROADMAP Queue 1 item 9)")
