"""Contrastive losses of the PyTorch port."""

from multimodal_tpu_torch.losses.clip_loss import clip_loss, contrastive_logits, cross_entropy

__all__ = ["clip_loss", "contrastive_logits", "cross_entropy"]
