"""Contrastive losses of the PyTorch port."""

from multimodal_tpu_torch.losses.align_loss import align_clip_loss
from multimodal_tpu_torch.losses.clip_loss import (
    clip_loss,
    clip_loss_sampled,
    contrastive_logits,
    cross_entropy,
)
from multimodal_tpu_torch.losses.cloob_loss import cloob_loss, hopfield_retrieval, infoloob_loss
from multimodal_tpu_torch.losses.global_contrastive import chunked_clip_loss, ring_clip_loss
from multimodal_tpu_torch.losses.siglip_loss import siglip_loss
from multimodal_tpu_torch.losses.vclip_loss import vclip_loss

__all__ = ["align_clip_loss", "chunked_clip_loss", "clip_loss", "clip_loss_sampled",
           "cloob_loss", "contrastive_logits", "cross_entropy", "hopfield_retrieval",
           "infoloob_loss", "ring_clip_loss", "siglip_loss", "vclip_loss"]
