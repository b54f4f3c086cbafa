"""The variational CLIP loss: Monte-Carlo InfoNCE, the KL to the prior and the
variance-matching term (port of ``multimodal_tpu/losses/vclip_loss.py``).

The KL dispatches on the family: a ``NormalDiag`` takes the sum over dimensions of its KL to
N(0, I), averaged over the batch; the spherical families their KL to the uniform sphere.
Every draw comes from the ``torch.Generator`` the caller passes, the image samples first.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_tpu_torch.distributions.normal import NormalDiag
from multimodal_tpu_torch.distributions.power_spherical import PowerSpherical
from multimodal_tpu_torch.losses.clip_loss import clip_loss, clip_loss_sampled


def _kl_to_prior(dist) -> torch.Tensor:
    if isinstance(dist, NormalDiag):
        return dist.kl_standard_normal().sum(dim=-1).mean()
    return dist.kl_uniform().mean()


def _expected_embedding(dist) -> torch.Tensor:
    """E[x] for a PowerSpherical, the mode for the other families."""
    return dist.mean if isinstance(dist, PowerSpherical) else dist.mode


def vclip_loss(image_dist, text_dist, image_vars: torch.Tensor, text_vars: torch.Tensor,
               logit_scale: torch.Tensor, *, generator: Optional[torch.Generator] = None,
               clip_weight: float = 1.0, kl_weight: float = 1.0, num_samples: int = 20,
               var_reg_weight: float = 0.1, use_mean_only: bool = False,
               expected_value: bool = False, label_smoothing: float = 0.1,
               is_train: bool = True, kl_weight_override: Optional[float] = None) -> dict:
    """{'total_loss', 'clip_loss', 'image_kl_loss', 'text_kl_loss', 'var_reg'}.

    Sampling is used when the KL weight is above 0, in training, and not ``use_mean_only``:
    ``num_samples`` draws of each distribution (or, with ``expected_value``, their expected
    embeddings) feed the InfoNCE; otherwise the modes do. The sampled branch needs
    ``generator``."""
    kl_w = kl_weight_override if kl_weight_override is not None else kl_weight
    use_sampling = kl_w > 0 and is_train and not use_mean_only
    if use_sampling and expected_value:
        contrastive = clip_loss(_expected_embedding(image_dist), _expected_embedding(text_dist),
                                logit_scale, label_smoothing=label_smoothing, normalize=False)
    elif use_sampling:
        if generator is None:
            raise ValueError("the sampled vclip loss needs an explicit torch.Generator")
        image_samples = image_dist.rsample(generator, (num_samples,))
        text_samples = text_dist.rsample(generator, (num_samples,))
        contrastive = clip_loss_sampled(image_samples, text_samples, logit_scale,
                                        label_smoothing=label_smoothing).mean()
    else:
        contrastive = clip_loss(image_dist.mode, text_dist.mode, logit_scale,
                                label_smoothing=label_smoothing)

    kl_image = _kl_to_prior(image_dist)
    kl_text = _kl_to_prior(text_dist)
    # variance matching: the squared log-ratio of the two concentration heads
    log_iv = torch.log(image_vars + 1e-8)
    log_tv = torch.log(text_vars + 1e-8)
    if isinstance(image_dist, NormalDiag):
        var_reg = (log_iv - log_tv).square().sum(dim=-1).mean()
    else:
        var_reg = (log_iv - log_tv).square().mean()
    total = (clip_weight * contrastive + 0.5 * kl_w * (kl_image + kl_text)
             + var_reg_weight * var_reg)
    return {"total_loss": total, "clip_loss": contrastive, "image_kl_loss": kl_image,
            "text_kl_loss": kl_text, "var_reg": var_reg}
