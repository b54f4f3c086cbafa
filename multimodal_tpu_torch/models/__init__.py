"""CLIP model family for the PyTorch port."""

from multimodal_tpu_torch.models.checkpoint_interop import load_openai_state_dict
from multimodal_tpu_torch.models.clip import CLIP
from multimodal_tpu_torch.models.config import (
    CLIPConfig,
    add_model_config,
    get_model_config,
    list_models,
)
from multimodal_tpu_torch.models.factory import create_model

__all__ = [
    "CLIP",
    "CLIPConfig",
    "add_model_config",
    "create_model",
    "get_model_config",
    "list_models",
    "load_openai_state_dict",
]
