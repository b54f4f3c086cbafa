"""SigLIP pairwise-sigmoid contrastive loss on one device (port of
``multimodal_tpu/losses/siglip_loss.py``, dense form).

    L = -1/B * sum_i sum_j log sigmoid(z_ij * (t * x_i . y_j + b)),   z_ij = +1 iff i == j,

with t = exp(t') (learnable t', init ln 10) and the learnable bias b (init -10), every pair
term taken in float32 as softplus(-z * logit). Not ported yet: the mesh-sharded form
(``axis_name``: text blocks rotated around a ring), ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

from typing import Optional

import torch

from multimodal_tpu_torch.losses.clip_loss import _l2norm


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias: torch.Tensor, *, normalize: bool = True,
                scale_is_log: bool = True, axis_name: Optional[str] = None) -> torch.Tensor:
    """The dense SigLIP loss, a float32 scalar: the mean over images of the summed pair
    terms. ``softplus`` is ``logaddexp(x, 0)``, as ``jax.nn.softplus``."""
    if axis_name is not None:
        raise NotImplementedError("axis_name: the mesh-sharded SigLIP loss is not ported yet "
                                  "(ROADMAP Queue 1 item 9)")
    fi = image_features.to(torch.float32)
    ft = text_features.to(torch.float32)
    if normalize:
        fi, ft = _l2norm(fi), _l2norm(ft)
    t = torch.exp(logit_scale) if scale_is_log else logit_scale
    logits = t * (fi @ ft.T) + logit_bias.to(torch.float32)
    sign = 2.0 * torch.eye(fi.shape[0], ft.shape[0], dtype=torch.float32, device=fi.device) - 1.0
    x = -sign * logits
    return torch.logaddexp(x, torch.zeros_like(x)).sum() / fi.shape[0]
