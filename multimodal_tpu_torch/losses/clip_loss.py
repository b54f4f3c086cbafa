"""InfoNCE contrastive loss on one device (port of ``multimodal_tpu/losses/clip_loss.py``).

``clip_loss_sampled`` is the Monte-Carlo form of the variational CLIP loss. Not ported yet: the
mesh-sharded forms (``axis_name``: the feature gather with gradient and the local-loss
offsets, ROADMAP Queue 1 item 9), which raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

LOGIT_CLAMP = 4.6052  # ln(100)
LOGIT_CLAMP_SAMPLED = 3.912  # ln(50): the sampled loss's clamp


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-example CE with label smoothing, f32 accumulation. logits [N, C], labels [N]."""
    log_probs = F.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -log_probs.gather(-1, labels[:, None].long())[:, 0]
    if label_smoothing > 0.0:
        smooth = -log_probs.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    return nll


def _no_mesh(axis_name):
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name: the mesh-sharded contrastive loss is not ported yet "
            "(ROADMAP Queue 1 item 9)")


def contrastive_logits(image_features: torch.Tensor, text_features: torch.Tensor, scale,
                       axis_name: Optional[str] = None, local_loss: bool = True):
    """(logits_per_image, logits_per_text, labels): [B, B] both ways, labels arange(B)."""
    _no_mesh(axis_name)
    logits_per_image = scale * image_features @ text_features.T
    labels = torch.arange(image_features.shape[0], device=image_features.device)
    return logits_per_image, logits_per_image.T, labels


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, label_smoothing: float = 0.0,
              normalize: bool = True, scale_is_log: bool = True,
              axis_name: Optional[str] = None, local_loss: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE, a scalar. The log scale is clamped at ln(100) where it is used
    (``torch.minimum`` splits the gradient at a tie, as ``jnp.minimum`` does)."""
    _no_mesh(axis_name)
    if normalize:
        image_features = _l2norm(image_features.to(torch.float32))
        text_features = _l2norm(text_features.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP) if scale_is_log else logit_scale
    li, lt, labels = contrastive_logits(image_features, text_features, scale, axis_name,
                                        local_loss)
    return 0.5 * (cross_entropy(li, labels, label_smoothing).mean()
                  + cross_entropy(lt, labels, label_smoothing).mean())


def _clamped_scale(logit_scale: torch.Tensor, clamp: float) -> torch.Tensor:
    """exp(min(logit_scale, clamp)); ``torch.minimum`` splits the gradient at a tie, as
    ``jnp.minimum`` does."""
    return torch.exp(torch.minimum(
        logit_scale, torch.tensor(clamp, dtype=logit_scale.dtype, device=logit_scale.device)))


def clip_loss_sampled(image_samples: torch.Tensor, text_samples: torch.Tensor,
                      logit_scale: torch.Tensor, *, label_smoothing: float = 0.1,
                      scale_is_log: bool = True) -> torch.Tensor:
    """Monte-Carlo InfoNCE over [S, B, E] samples -> per-sample losses [S]: the samples
    normalized, [S, B, B] logits under the ln(50) clamp of the log scale, and the symmetric
    cross entropy of each sample's batch."""
    image_samples = _l2norm(image_samples.to(torch.float32))
    text_samples = _l2norm(text_samples.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP_SAMPLED) if scale_is_log else logit_scale
    s, b, _ = image_samples.shape
    logits_per_image = scale * torch.einsum("sbe,sce->sbc", image_samples, text_samples)
    logits_per_text = logits_per_image.transpose(1, 2)
    labels = torch.arange(b, device=image_samples.device).repeat(s)
    loss_img = cross_entropy(logits_per_image.reshape(s * b, b), labels, label_smoothing)
    loss_txt = cross_entropy(logits_per_text.reshape(s * b, b), labels, label_smoothing)
    return 0.5 * (loss_img.reshape(s, b).mean(dim=1) + loss_txt.reshape(s, b).mean(dim=1))
