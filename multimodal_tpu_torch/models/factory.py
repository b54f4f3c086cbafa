"""Model factory: registry name -> initialized ``CLIP`` on a device (port of
``multimodal_tpu/models/factory.py:create_model``)."""

from __future__ import annotations

import torch

from multimodal_tpu_torch.models.clip import CLIP
from multimodal_tpu_torch.models.config import get_model_config


def create_model(name: str, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cpu", seed: int = 0) -> CLIP:
    """Build ``name`` with the reference's init distributions, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (the same weights on every device), then
    moved to ``device``. Parameters stay float32; ``dtype`` is the compute dtype."""
    model = CLIP(get_model_config(name), dtype=dtype)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
