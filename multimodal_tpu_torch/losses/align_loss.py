"""AlignCLIP's in-modality separation loss (port of
``multimodal_tpu/losses/align_loss.py:align_clip_loss``).

total = alpha * (CE(image -> text) + CE(text -> image))
      + beta * in-modality CE over the image-image / text-text similarities.

With ``semantic_features`` (caption sentence embeddings) the in-modality logits are weighted
by ``1 - S S^T`` and the paired image-text diagonal is added back; ``separate_text`` and
``separate_image`` pick the modalities of that term. Without them the in-modality term is
``beta * (CE(scale I I^T) + CE(scale T T^T))`` whatever the two flags say, as in the
reference.

On a group (``axis_name``) the form follows ``clip_loss``'s: with ``local_loss`` a rank's rows
against every rank's (gathered with their gradient), labels offset by ``rank * B``, the
semantic features gathered too; without it every rank computes the global matrices. Both
terms are the mean over the ranks."""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_tpu_torch.losses.clip_loss import (
    LOGIT_CLAMP,
    _clamped_scale,
    _l2norm,
    cross_entropy,
    gather_features,
)
from multimodal_tpu_torch.parallel.collectives import group_rank, mean_over


def align_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                    logit_scale: torch.Tensor, *,
                    semantic_features: Optional[torch.Tensor] = None, alpha: float = 1.0,
                    beta: float = 0.5, separate_text: bool = True,
                    separate_image: bool = False, normalize: bool = True,
                    scale_is_log: bool = True, axis_name=None,
                    local_loss: bool = True) -> dict:
    """Returns ``{"total_loss", "clip_loss", "inModality_loss"}``."""
    if normalize:
        image_features = _l2norm(image_features.to(torch.float32))
        text_features = _l2norm(text_features.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP) if scale_is_log else logit_scale
    local = axis_name is not None and local_loss
    if local:
        all_images = gather_features(image_features, axis_name)
        all_texts = gather_features(text_features, axis_name)
        b = image_features.shape[0]
        labels = torch.arange(b, device=image_features.device) + b * group_rank(axis_name)
    else:
        if axis_name is not None:  # the global-matrix form: every rank computes all of it
            image_features = gather_features(image_features, axis_name)
            text_features = gather_features(text_features, axis_name)
            if semantic_features is not None:
                semantic_features = gather_features(semantic_features, axis_name)
        all_images, all_texts = image_features, text_features
        labels = torch.arange(image_features.shape[0], device=image_features.device)

    logits_ii = image_features @ all_images.T  # unscaled in-modality similarities
    logits_tt = text_features @ all_texts.T
    logits_it = scale * image_features @ all_texts.T
    logits_ti = scale * text_features @ all_images.T

    if semantic_features is not None:
        sem = _l2norm(semantic_features.to(torch.float32))
        all_sem = gather_features(sem, axis_name) if local else sem
        semantic_sim = 1.0 - sem @ all_sem.T  # dissimilarity weights
        paired = torch.sum(image_features * text_features, dim=-1)  # diag(I T^T)
        # the paired image-text value at each row's positive column
        eye_paired = torch.zeros_like(logits_ii).index_put(
            (torch.arange(labels.shape[0], device=labels.device), labels), paired)
        terms = []
        if separate_text:
            terms.append(cross_entropy(scale * (logits_tt * semantic_sim + eye_paired),
                                       labels).mean())
        if separate_image:
            terms.append(cross_entropy(scale * (logits_ii * semantic_sim + eye_paired),
                                       labels).mean())
        in_modality = beta * sum(terms) if terms else torch.zeros(
            (), dtype=torch.float32, device=labels.device)
    else:
        in_modality = beta * (cross_entropy(scale * logits_ii, labels).mean()
                              + cross_entropy(scale * logits_tt, labels).mean())
    inter = alpha * (cross_entropy(logits_it, labels).mean()
                     + cross_entropy(logits_ti, labels).mean())
    if axis_name is not None:
        inter, in_modality = mean_over(inter, axis_name), mean_over(in_modality, axis_name)
    return {"total_loss": inter + in_modality, "clip_loss": inter,
            "inModality_loss": in_modality}
