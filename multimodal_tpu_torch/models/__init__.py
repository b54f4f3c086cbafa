"""CLIP model family for the PyTorch port: two-tower, shared-trunk and variational."""

from multimodal_tpu_torch.models.checkpoint_interop import (
    load_jax_params,
    load_openai_state_dict,
)
from multimodal_tpu_torch.models.clip import CLIP, VariationalCLIP
from multimodal_tpu_torch.models.config import (
    CLIPConfig,
    VariationalConfig,
    add_model_config,
    get_model_config,
    list_models,
)
from multimodal_tpu_torch.models.factory import create_model

__all__ = [
    "CLIP",
    "CLIPConfig",
    "VariationalCLIP",
    "VariationalConfig",
    "add_model_config",
    "create_model",
    "get_model_config",
    "list_models",
    "load_jax_params",
    "load_openai_state_dict",
]
