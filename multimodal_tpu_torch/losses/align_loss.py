"""AlignCLIP's in-modality separation loss on one device (port of
``multimodal_tpu/losses/align_loss.py:align_clip_loss``).

total = alpha * (CE(image -> text) + CE(text -> image))
      + beta * in-modality CE over the image-image / text-text similarities.

With ``semantic_features`` (caption sentence embeddings) the in-modality logits are weighted
by ``1 - S S^T`` and the paired image-text diagonal is added back; ``separate_text`` and
``separate_image`` pick the modalities of that term. Without them the in-modality term is
``beta * (CE(scale I I^T) + CE(scale T T^T))`` whatever the two flags say, as in the
reference. Not ported yet: the mesh-sharded form (``axis_name``, ROADMAP Queue 1 item 9),
which raises ``NotImplementedError``."""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_tpu_torch.losses.clip_loss import (
    LOGIT_CLAMP,
    _clamped_scale,
    _l2norm,
    _no_mesh,
    cross_entropy,
)


def align_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                    logit_scale: torch.Tensor, *,
                    semantic_features: Optional[torch.Tensor] = None, alpha: float = 1.0,
                    beta: float = 0.5, separate_text: bool = True,
                    separate_image: bool = False, normalize: bool = True,
                    scale_is_log: bool = True, axis_name: Optional[str] = None,
                    local_loss: bool = True) -> dict:
    """Returns ``{"total_loss", "clip_loss", "inModality_loss"}``."""
    _no_mesh(axis_name)
    if normalize:
        image_features = _l2norm(image_features.to(torch.float32))
        text_features = _l2norm(text_features.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP) if scale_is_log else logit_scale
    labels = torch.arange(image_features.shape[0], device=image_features.device)

    logits_ii = image_features @ image_features.T  # unscaled in-modality similarities
    logits_tt = text_features @ text_features.T
    logits_it = scale * image_features @ text_features.T
    logits_ti = scale * text_features @ image_features.T

    if semantic_features is not None:
        sem = _l2norm(semantic_features.to(torch.float32))
        semantic_sim = 1.0 - sem @ sem.T  # dissimilarity weights
        paired = torch.sum(image_features * text_features, dim=-1)  # diag(I T^T)
        eye_paired = torch.diag_embed(paired)
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
    return {"total_loss": inter + in_modality, "clip_loss": inter,
            "inModality_loss": in_modality}
