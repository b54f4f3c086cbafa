"""InfoNCE contrastive loss (port of ``multimodal_tpu/losses/clip_loss.py``).

``clip_loss_sampled`` is the Monte-Carlo form of the variational CLIP loss.

The mesh forms take ``axis_name``, the process group the batch is split over (JAX's mesh axis
name; None: one device). Each rank holds its own rows; ``gather_features`` all-gathers every
rank's features, and its gradient is the reduce-scatter of the cotangent (the transpose of
``lax.all_gather``), so the gradient reaching a rank's features carries every rank's loss
term. With ``local_loss`` a rank computes only its rows against the global batch, the labels
offset by ``rank * B``; without it every rank computes the global matrix. The loss is the mean
over the ranks (``parallel.collectives.mean_over``): the same global value on every rank,
whose backward gives each rank's features exactly their gradient of the global loss, so the
train step sums the ranks' parameter gradients.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multimodal_tpu_torch.parallel.collectives import all_gather, group_rank, mean_over

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


def gather_features(features: torch.Tensor, axis_name) -> torch.Tensor:
    """Every rank's features of ``axis_name``'s group in rank order, the gradient preserved
    (None: the features as they are)."""
    return features if axis_name is None else all_gather(features, axis_name)


def contrastive_logits(image_features: torch.Tensor, text_features: torch.Tensor, scale,
                       axis_name=None, local_loss: bool = True):
    """(logits_per_image, logits_per_text, labels). One device: [B, B] both ways, labels
    arange(B). On a group with ``local_loss``: local @ global, [B, B W], labels offset by
    ``rank * B``; without it the global matrix [B W, B W] on every rank."""
    if axis_name is None:
        logits_per_image = scale * image_features @ text_features.T
        labels = torch.arange(image_features.shape[0], device=image_features.device)
        return logits_per_image, logits_per_image.T, labels
    all_images = gather_features(image_features, axis_name)
    all_texts = gather_features(text_features, axis_name)
    if local_loss:
        b = image_features.shape[0]
        labels = torch.arange(b, device=image_features.device) + b * group_rank(axis_name)
        return (scale * image_features @ all_texts.T, scale * text_features @ all_images.T,
                labels)
    logits_per_image = scale * all_images @ all_texts.T
    labels = torch.arange(all_images.shape[0], device=image_features.device)
    return logits_per_image, logits_per_image.T, labels


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, *, label_smoothing: float = 0.0,
              normalize: bool = True, scale_is_log: bool = True,
              axis_name=None, local_loss: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE, a scalar; on a group the global-batch mean, the same on every
    rank. The log scale is clamped at ln(100) where it is used (``torch.minimum`` splits the
    gradient at a tie, as ``jnp.minimum`` does)."""
    if normalize:
        image_features = _l2norm(image_features.to(torch.float32))
        text_features = _l2norm(text_features.to(torch.float32))
    scale = _clamped_scale(logit_scale, LOGIT_CLAMP) if scale_is_log else logit_scale
    li, lt, labels = contrastive_logits(image_features, text_features, scale, axis_name,
                                        local_loss)
    loss = 0.5 * (cross_entropy(li, labels, label_smoothing).mean()
                  + cross_entropy(lt, labels, label_smoothing).mean())
    return loss if axis_name is None else mean_over(loss, axis_name)


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
