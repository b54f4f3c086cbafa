"""Model factory: registry name -> initialized ``CLIP`` on a device (port of
``multimodal_tpu/models/factory.py:create_model``)."""

from __future__ import annotations

import torch

from multimodal_tpu_torch.models.clip import CLIP
from multimodal_tpu_torch.models.config import get_model_config


def create_model(name: str, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda", seed: int = 0,
                 block_mlp: bool = False) -> CLIP:
    """Build ``name`` with the reference's init distributions, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` (the same weights on every device), then
    moved to ``device``: the GPU unless the caller asks for ``"cpu"``; without a CUDA
    device that raises, it never moves to the CPU on its own. Parameters stay float32;
    ``dtype`` is the compute dtype. ``block_mlp=True`` opts into the fused MLP operator
    (on the card the hand-written ``block_mlp`` kernels) in every block that can take it."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"create_model({name!r}, device={str(device)!r}): no CUDA device is available; "
            "pass device='cpu' to build the model on the CPU")
    model = CLIP(get_model_config(name), dtype=dtype, block_mlp=block_mlp)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
