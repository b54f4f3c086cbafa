"""Contrastive losses of the PyTorch port."""

from multimodal_tpu_torch.losses.clip_loss import (
    clip_loss,
    clip_loss_sampled,
    contrastive_logits,
    cross_entropy,
)
from multimodal_tpu_torch.losses.siglip_loss import siglip_loss
from multimodal_tpu_torch.losses.vclip_loss import vclip_loss

__all__ = ["clip_loss", "clip_loss_sampled", "contrastive_logits", "cross_entropy",
           "siglip_loss", "vclip_loss"]
