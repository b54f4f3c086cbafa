"""Device-side image normalization (port of ``multimodal_tpu/data/preprocess.py:
normalize_images``): uint8 NHWC stays uint8 on the wire and is scaled on the tensor's
device."""

from __future__ import annotations

import torch

# OpenAI CLIP dataset statistics
OPENAI_DATASET_MEAN = (0.48145466, 0.4578275, 0.40821073)
OPENAI_DATASET_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGE_SIZE = 224


def normalize_images(x: torch.Tensor, mean=OPENAI_DATASET_MEAN,
                     std=OPENAI_DATASET_STD) -> torch.Tensor:
    """uint8 (divided by 255 in float32) or float NHWC images -> normalized float32."""
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / 255.0
    mean = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean) / std
