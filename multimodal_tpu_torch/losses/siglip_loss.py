"""SigLIP pairwise-sigmoid contrastive loss (port of ``multimodal_tpu/losses/siglip_loss.py``).

    L = -1/B * sum_i sum_j log sigmoid(z_ij * (t * x_i . y_j + b)),   z_ij = +1 iff i == j,

with t = exp(t') (learnable t', init ln 10) and the learnable bias b (init -10), every pair
term taken in float32 as softplus(-z * logit).

On a group (``axis_name``) no feature is gathered: the local block (which holds the
positives) is summed first, then the text blocks go round the group's ring, W - 1 hops, each
contributing its pairs, all negatives. The rotation is one ``torch.autograd.Function``,
``_RingNegatives``, whose backward rotates the text blocks again with their gradient
accumulators and sends each accumulator home with one last hop. The loss is the mean over the
ranks of the local mean over images: the global value on every rank.
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.losses.clip_loss import _l2norm
from multimodal_tpu_torch.parallel.collectives import group_size, mean_over, ring_shift


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


class _RingNegatives(torch.autograd.Function):
    """sum over the W - 1 visiting text blocks of softplus(t fi ft_j^T + b)."""

    @staticmethod
    def forward(ctx, fi, ft, t, b, group):
        total = torch.zeros((), dtype=torch.float32, device=fi.device)
        block = ft
        for _ in range(group_size(group) - 1):
            block = ring_shift([block], group)[0]
            total = total + _softplus(t * (fi @ block.T) + b).sum()
        ctx.save_for_backward(fi, ft, t, b)
        ctx.group = group
        return total

    @staticmethod
    def backward(ctx, ct):
        fi, ft, t, b = ctx.saved_tensors
        group = ctx.group
        d_fi, d_t, d_b = torch.zeros_like(fi), torch.zeros_like(t), torch.zeros_like(b)
        held = [ft, torch.zeros_like(ft)]
        for _ in range(group_size(group) - 1):
            held = ring_shift(held, group)
            raw = fi @ held[0].T
            d_logits = ct * torch.sigmoid(t * raw + b)
            d_fi += t * d_logits @ held[0]
            held[1] += t * d_logits.T @ fi
            d_t += (d_logits * raw).sum()
            d_b += d_logits.sum()
        # the accumulators sit W - 1 hops from their blocks' ranks: one hop brings them home
        d_ft = ring_shift(held[1:], group)[0]
        return d_fi, d_ft, d_t, d_b, None


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor, *, normalize: bool = True,
                scale_is_log: bool = True, axis_name=None) -> torch.Tensor:
    """The SigLIP loss, a float32 scalar: the mean over images of the summed pair terms; on
    a group the global mean, through the ring. ``softplus`` is ``logaddexp(x, 0)``, as
    ``jax.nn.softplus``."""
    fi = image_features.to(torch.float32)
    ft = text_features.to(torch.float32)
    if normalize:
        fi, ft = _l2norm(fi), _l2norm(ft)
    t = torch.exp(logit_scale) if scale_is_log else logit_scale
    logits = t * (fi @ ft.T) + logit_bias.to(torch.float32)
    sign = 2.0 * torch.eye(fi.shape[0], ft.shape[0], dtype=torch.float32, device=fi.device) - 1.0
    total = _softplus(-sign * logits).sum()
    if axis_name is None:
        return total / fi.shape[0]
    total = total + _RingNegatives.apply(fi, ft, t, logit_bias.to(torch.float32), axis_name)
    return mean_over(total / fi.shape[0], axis_name)
