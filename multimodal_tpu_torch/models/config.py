"""Typed model configuration + JSON registry (port of ``multimodal_tpu/models/config.py``).

The dataclasses and the JSON parsing are the reference's; the registry reads the JAX
package's ``models/configs/*.json``, so both packages share one source of configs."""

from __future__ import annotations

import dataclasses
import json
import os

from multimodal_tpu_torch.paths import CONFIG_DIR


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    image_size: int = 224
    patch_size: int = 32
    width: int = 768
    layers: int = 12
    heads: int = 12
    mlp_ratio: float = 4.0
    patch_dropout: float = 0.0
    ls_init_value: float | None = None
    scaled_cosine: bool = False
    scale_heads: bool = False
    global_average_pool: bool = False
    attentional_pool: bool = False
    n_queries: int = 256
    attn_pooler_heads: int = 8
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 1
    moe_capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class TextConfig:
    context_length: int = 77
    vocab_size: int = 49408
    width: int = 512
    layers: int = 12
    heads: int = 8
    mlp_ratio: float = 4.0
    ls_init_value: float | None = None


@dataclasses.dataclass(frozen=True)
class CLIPConfig:
    embed_dim: int = 512
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    share_trunk: bool = False
    remat: bool = False
    act: str = "quick_gelu"
    logit_bias_init: float | None = None
    logit_scale_init: float | None = None
    lora_rank: int = 0
    lora_alpha: float = 16.0
    int8_forward: bool = False

    def __post_init__(self):
        if self.share_trunk and (
            self.vision.width != self.text.width
            or self.vision.layers != self.text.layers
            or self.vision.heads != self.text.heads
        ):
            raise ValueError("shared trunk requires equal vision/text width, layers, heads")


@dataclasses.dataclass(frozen=True)
class VariationalConfig:
    """The heads of ``VariationalCLIP``: "Spherical" (one concentration per example, its
    log-space head clamped to [min, max]) or "Gaussian" (a variance per dimension)."""

    model_type: str = "Spherical"
    min_concentration: float = 10.0
    initial_concentration: float = 200.0
    max_concentration: float = 1e12


def _vision_from_json(d: dict) -> VisionConfig:
    return VisionConfig(
        image_size=d.get("image_size", 224),
        patch_size=d.get("patch_size", 32),
        width=d.get("width", 768),
        layers=d.get("layers", 12),
        heads=d.get("heads", d.get("width", 768) // 64),
        mlp_ratio=d.get("mlp_ratio", 4.0),
        patch_dropout=d.get("patch_dropout", 0.0),
        ls_init_value=d.get("ls_init_value"),
        scaled_cosine=d.get("scaled_cosine", False),
        scale_heads=d.get("scale_heads", False),
        global_average_pool=d.get("global_average_pool", False),
        attentional_pool=d.get("attentional_pool", False),
        n_queries=d.get("n_queries", 256),
        attn_pooler_heads=d.get("attn_pooler_heads", 8),
        moe_experts=d.get("moe_experts", 0),
        moe_every=d.get("moe_every", 2),
        moe_top_k=d.get("moe_top_k", 1),
        moe_capacity_factor=d.get("moe_capacity_factor", 1.25),
    )


def _text_from_json(d: dict) -> TextConfig:
    return TextConfig(
        context_length=d.get("context_length", 77),
        vocab_size=d.get("vocab_size", 49408),
        width=d.get("width", 512),
        layers=d.get("layers", 12),
        heads=d.get("heads", d.get("width", 512) // 64),
        mlp_ratio=d.get("mlp_ratio", 4.0),
        ls_init_value=d.get("ls_init_value"),
    )


def clip_config_from_dict(d: dict) -> CLIPConfig:
    return CLIPConfig(
        embed_dim=d.get("embed_dim", 512),
        vision=_vision_from_json(d.get("vision_cfg", {})),
        text=_text_from_json(d.get("text_cfg", {})),
        share_trunk=d.get("share_trunk", False),
        remat=d.get("remat", False),
        act=d.get("act", "quick_gelu" if d.get("quick_gelu", True) else "gelu"),
        lora_rank=d.get("lora_rank", 0),
        lora_alpha=d.get("lora_alpha", 16.0),
    )


_registry: dict = {}


def _rescan():
    _registry.clear()
    if os.path.isdir(CONFIG_DIR):
        for fname in sorted(os.listdir(CONFIG_DIR)):
            if fname.endswith(".json"):
                with open(os.path.join(CONFIG_DIR, fname)) as f:
                    _registry[fname[:-5]] = json.load(f)


def list_models() -> list:
    if not _registry:
        _rescan()
    return sorted(_registry)


def get_model_config(name: str) -> CLIPConfig:
    if not _registry:
        _rescan()
    if name not in _registry:
        raise KeyError(f"unknown model config {name!r}; available: {list_models()}")
    return clip_config_from_dict(_registry[name])


def add_model_config(name: str, cfg: dict):
    """Register an extra config at runtime."""
    if not _registry:
        _rescan()
    _registry[name] = cfg
