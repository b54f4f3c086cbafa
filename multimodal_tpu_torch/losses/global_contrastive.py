"""Global-batch InfoNCE at scale: the chunked and the ring-streamed forms (port of
``multimodal_tpu/losses/global_contrastive.py``).

The dense loss builds a ``[B, B]`` logits matrix per direction; at a large batch that matrix
is the memory bottleneck. Here each direction's logsumexp is accumulated over chunks of the
keys in a Python loop whose every chunk body runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the body's ``[B, chunk]``
logits are freed after the forward and recomputed in the backward, so peak logits memory is
one block in both passes. Values and gradients are the dense loss's up to summation order;
label smoothing streams the mean logit beside the logsumexp. On a group (``axis_name``) the
keys are every rank's features, gathered with their gradient, and the loss is the mean over
the ranks.

``ring_clip_loss`` never gathers: each rank's image and text blocks go round the group's ring
(``parallel.collectives.ring_shift``, W - 1 hops), and each visiting block is folded into a
streaming logsumexp and sum of logits of the local rows. P2P sends have no gradient, so the
rotation is one ``torch.autograd.Function``, ``_RingLogSumExp``, whose backward rotates the
blocks again with their gradient accumulators riding along, and sends each accumulator home
with one last hop."""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from multimodal_tpu_torch.losses.clip_loss import (
    LOGIT_CLAMP,
    _clamped_scale,
    _l2norm,
    gather_features,
)
from multimodal_tpu_torch.parallel.collectives import group_size, mean_over, ring_shift


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
                      scale_is_log: bool = True, axis_name=None) -> torch.Tensor:
    """Exact symmetric InfoNCE with O(B x chunk) peak logits memory in forward and backward.
    A ``chunk_size`` that does not divide the (global) batch shrinks to the largest divisor
    below it."""
    if normalize:
        image_features = _l2norm(image_features.to(torch.float32))
        text_features = _l2norm(text_features.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP) if scale_is_log else logit_scale
    all_images = gather_features(image_features, axis_name)
    all_texts = gather_features(text_features, axis_name)
    n = all_texts.shape[0]
    chunk = min(chunk_size, n)
    while n % chunk:
        chunk -= 1
    pos = scale * torch.sum(image_features * text_features, dim=-1)
    loss_i = _streaming_ce(image_features, all_texts, scale, pos, chunk, label_smoothing)
    loss_t = _streaming_ce(text_features, all_images, scale, pos, chunk, label_smoothing)
    loss = 0.5 * (loss_i + loss_t)
    return loss if axis_name is None else mean_over(loss, axis_name)


def _fold(m, s, lsum, logits):
    """One ``[B, B]`` block of logits into the running max, sum of exponentials and sum of
    logits of every row."""
    m_new = torch.maximum(m, logits.max(dim=-1).values)
    s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
    return m_new, s, lsum + logits.sum(dim=-1)


class _RingLogSumExp(torch.autograd.Function):
    """(lse, lsum) of the image rows against every rank's text block and of the text rows
    against every rank's image block, the blocks rotating round ``group``'s ring."""

    @staticmethod
    def forward(ctx, img, txt, scale, group):
        w = group_size(group)
        zero = torch.zeros(img.shape[0], dtype=torch.float32, device=img.device)
        acc_i, acc_t = (zero - torch.inf, zero, zero), (zero - torch.inf, zero, zero)
        blocks = [txt, img]  # the text block the image rows meet, and the other way round
        for t in range(w):
            if t:  # the resident blocks first, then W - 1 hops
                blocks = ring_shift(blocks, group)
            acc_i = _fold(*acc_i, scale * img @ blocks[0].T)
            acc_t = _fold(*acc_t, scale * txt @ blocks[1].T)
        lse_i, lse_t = acc_i[0] + torch.log(acc_i[1]), acc_t[0] + torch.log(acc_t[1])
        ctx.save_for_backward(img, txt, scale, lse_i, lse_t)
        ctx.group = group
        return lse_i, acc_i[2], lse_t, acc_t[2]

    @staticmethod
    def backward(ctx, g_lse_i, g_lsum_i, g_lse_t, g_lsum_t):
        img, txt, scale, lse_i, lse_t = ctx.saved_tensors
        group, w = ctx.group, group_size(ctx.group)
        cts = [torch.zeros_like(lse_i) if g is None else g
               for g in (g_lse_i, g_lsum_i, g_lse_t, g_lsum_t)]
        d_img, d_txt = torch.zeros_like(img), torch.zeros_like(txt)
        d_scale = torch.zeros((), dtype=torch.float32, device=img.device)
        held = [txt, img, torch.zeros_like(txt), torch.zeros_like(img)]
        for t in range(w):
            if t:  # the blocks and their gradient accumulators travel together
                held = ring_shift(held, group)
            for rows, d_rows, block, acc, lse, g_lse, g_lsum in (
                    (img, d_img, held[0], held[2], lse_i, cts[0], cts[1]),
                    (txt, d_txt, held[1], held[3], lse_t, cts[2], cts[3])):
                raw = rows @ block.T
                d_logits = (g_lse[:, None] * torch.exp(scale * raw - lse[:, None])
                            + g_lsum[:, None])
                d_rows += scale * d_logits @ block
                acc += scale * d_logits.T @ rows
                d_scale += (d_logits * raw).sum()
        home = ring_shift(held[2:], group)  # each accumulator to its block's rank
        d_txt += home[0]
        d_img += home[1]
        return d_img, d_txt, d_scale.reshape(scale.shape).to(scale.dtype), None


def ring_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                   logit_scale: torch.Tensor, axis_name, *, normalize: bool = True,
                   scale_is_log: bool = True, label_smoothing: float = 0.0) -> torch.Tensor:
    """Exact global-batch InfoNCE with no feature gather: both modalities' blocks rotate over
    ``axis_name``'s ring (W - 1 hops), each visiting ``[B, B]`` block folded into the local
    rows' streaming logsumexp; label smoothing streams the sum of logits beside it
    (smooth-NLL = lse - mean_j logits_j). The mean over the ranks, the same on every rank."""
    if normalize:
        image_features = _l2norm(image_features.to(torch.float32))
        text_features = _l2norm(text_features.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP) if scale_is_log else logit_scale
    scale = torch.as_tensor(scale, dtype=torch.float32, device=image_features.device)
    pos = scale * torch.sum(image_features * text_features, dim=-1)
    lse_i, lsum_i, lse_t, lsum_t = _RingLogSumExp.apply(image_features, text_features, scale,
                                                        axis_name)
    nll_i, nll_t = lse_i - pos, lse_t - pos
    if label_smoothing > 0.0:
        n = group_size(axis_name) * image_features.shape[0]
        nll_i = (1.0 - label_smoothing) * nll_i + label_smoothing * (lse_i - lsum_i / n)
        nll_t = (1.0 - label_smoothing) * nll_t + label_smoothing * (lse_t - lsum_t / n)
    loss = 0.5 * (nll_i.mean() + nll_t.mean())
    return mean_over(loss, axis_name)
