"""CLIP model family for the PyTorch port: two-tower, shared-trunk and variational, with
LoRA adapters, MoE vision towers and the SigLIP head."""

from multimodal_tpu_torch.models.checkpoint_interop import (
    export_openai_state_dict,
    jax_adapters_to_port,
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
from multimodal_tpu_torch.models.lora import (
    ALPHA_KEY,
    extract_lora,
    is_lora_leaf,
    load_lora,
    lora_mask,
    merge_lora,
)
from multimodal_tpu_torch.models.moe import MoEMLP, collect_moe_losses, load_balance_loss

__all__ = [
    "ALPHA_KEY",
    "CLIP",
    "CLIPConfig",
    "VariationalCLIP",
    "MoEMLP",
    "VariationalConfig",
    "add_model_config",
    "collect_moe_losses",
    "create_model",
    "export_openai_state_dict",
    "extract_lora",
    "get_model_config",
    "is_lora_leaf",
    "jax_adapters_to_port",
    "list_models",
    "load_balance_loss",
    "load_jax_params",
    "load_lora",
    "load_openai_state_dict",
    "lora_mask",
    "merge_lora",
]
