"""CLIP encoders, two-tower or shared-trunk (port of ``multimodal_tpu/models/clip.py``:
``VisionStem``, ``TextStem``, ``eot_pool`` and ``CLIP``). With ``cfg.share_trunk`` one
transformer, built from the vision config, serves both modalities: the text pass runs it
with a call-time ``causal=True``, and both pool through one ``ln_post`` and one
``projection``.

Images are NHWC, as in the reference. The patch embedding is a reshape plus one matrix
product with the ``[P, P, 3, W]`` kernel (identical to the stride-P convolution, and with
TF32 left off it is true float32 on the card, which cuDNN's convolution is not by default).
The final projections run in float32. ``cfg.remat`` checkpoints every block in training,
``ls_init_value`` puts a LayerScale on both residual branches, ``vision.patch_dropout`` drops
patch tokens in training (the noise comes from the generator the caller hands in), and
``block_mlp=True`` sends every block's MLP half through the fused operator.

Not ported yet (``CLIP`` raises on configs that need them): scaled-cosine attention, MoE,
LoRA, int8 MLPs, attentional and mean pooling and the SigLIP bias.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimodal_tpu_torch.models.config import CLIPConfig
from multimodal_tpu_torch.models.layers import (
    LayerNorm,
    PatchDropout,
    Transformer,
    normal_,
    resolve_act,
)

LOGIT_SCALE_INIT = 2.6592  # ln(1/0.07)


class VisionStem(nn.Module):
    """Patchify + CLS + positional embedding [+ patch dropout in training] + ln_pre ->
    token sequence."""

    def __init__(self, width: int, patch_size: int, image_size: int,
                 dtype: torch.dtype = torch.float32, patch_dropout: float = 0.0):
        super().__init__()
        self.patch_dropout = (PatchDropout(patch_dropout, num_prefix=1)
                              if patch_dropout > 0.0 else None)
        self.width, self.patch_size, self.image_size, self.dtype = (
            width, patch_size, image_size, dtype)
        grid = image_size // patch_size
        self.patch_conv = nn.Parameter(torch.empty(patch_size, patch_size, 3, width))
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.positional_embedding = nn.Parameter(torch.empty(grid * grid + 1, width))
        self.ln_pre = LayerNorm(width)

    def init_weights(self, generator: torch.Generator):
        # lecun_normal: truncated (+-2 std) normal with variance 1/fan_in, fan_in = P*P*3
        p = self.patch_size
        std = math.sqrt(1.0 / (p * p * 3)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.patch_conv, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        normal_(self.class_embedding, self.width ** -0.5, generator)
        normal_(self.positional_embedding, self.width ** -0.5, generator)

    def forward(self, images: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        b, h, w, c = images.shape
        if (h, w, c) != (self.image_size, self.image_size, 3):
            raise ValueError(f"images are {h}x{w}x{c}; the model takes "
                             f"{self.image_size}x{self.image_size}x3")
        p, g = self.patch_size, self.image_size // self.patch_size
        patches = images.to(self.dtype).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
        x = patches.reshape(b, g * g, p * p * 3) @ self.patch_conv.reshape(
            p * p * 3, self.width).to(self.dtype)
        cls = self.class_embedding.to(self.dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(self.dtype)
        if self.patch_dropout is not None:
            x = self.patch_dropout(x, generator)
        return self.ln_pre(x)


class TextStem(nn.Module):
    """Token embedding + positional embedding -> token sequence."""

    def __init__(self, width: int, vocab_size: int, context_length: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.positional_embedding = nn.Parameter(torch.empty(context_length, width))

    def init_weights(self, generator: torch.Generator):
        normal_(self.token_embedding, 0.02, generator)
        normal_(self.positional_embedding, 0.01, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return (self.token_embedding[tokens].to(self.dtype)
                + self.positional_embedding.to(self.dtype))


def eot_pool(x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The EOT position's row: argmax works because EOT (49407) is the largest token id."""
    idx = tokens.argmax(dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _check_supported(c: CLIPConfig):
    unsupported = {
        "vision.scaled_cosine": c.vision.scaled_cosine,
        "vision.attentional_pool": c.vision.attentional_pool,
        "vision.global_average_pool": c.vision.global_average_pool,
        "vision.moe_experts": c.vision.moe_experts > 0,
        "lora_rank": c.lora_rank > 0,
        "int8_forward": c.int8_forward,
        "logit_bias_init": c.logit_bias_init is not None,
    }
    missing = [k for k, on in unsupported.items() if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


class CLIP(nn.Module):
    """Two-tower CLIP, or the shared-trunk model when ``cfg.share_trunk``: ``encode_image``
    (NHWC float images), ``encode_text`` (int tokens). ``block_mlp`` (off by default, as in
    the reference) routes every block's MLP half through the fused operator."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 block_mlp: bool = False):
        super().__init__()
        _check_supported(cfg)
        self.cfg, self.dtype = cfg, dtype
        v, t = cfg.vision, cfg.text
        act = resolve_act(cfg.act)
        trunk = dict(act=act, dtype=dtype, remat=cfg.remat, block_mlp=block_mlp)
        self.visual_stem = VisionStem(v.width, v.patch_size, v.image_size, dtype=dtype,
                                      patch_dropout=v.patch_dropout)
        self.text_stem = TextStem(t.width, t.vocab_size, t.context_length, dtype=dtype)
        if cfg.share_trunk:
            if v.ls_init_value != t.ls_init_value:
                raise ValueError("a shared trunk needs vision and text ls_init_value to agree")
            self.transformer = Transformer(v.width, v.layers, v.heads, v.mlp_ratio,
                                           scale_heads=v.scale_heads,
                                           ls_init_value=v.ls_init_value, **trunk)
            self.ln_post = LayerNorm(v.width)
            self.projection = nn.Parameter(torch.empty(v.width, cfg.embed_dim))
        else:
            self.visual_transformer = Transformer(v.width, v.layers, v.heads, v.mlp_ratio,
                                                  scale_heads=v.scale_heads,
                                                  ls_init_value=v.ls_init_value, **trunk)
            self.text_transformer = Transformer(t.width, t.layers, t.heads, t.mlp_ratio,
                                                causal=True, ls_init_value=t.ls_init_value,
                                                **trunk)
            self.ln_post = LayerNorm(v.width)
            self.ln_final = LayerNorm(t.width)
            self.visual_projection = nn.Parameter(torch.empty(v.width, cfg.embed_dim))
            self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator):
        """The reference's init distributions, drawn from ``generator``."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)
        if self.cfg.share_trunk:
            normal_(self.projection, self.cfg.vision.width ** -0.5, generator)
        else:
            normal_(self.visual_projection, self.cfg.vision.width ** -0.5, generator)
            normal_(self.text_projection, self.cfg.text.width ** -0.5, generator)
        init = self.cfg.logit_scale_init
        with torch.no_grad():
            self.logit_scale.fill_(LOGIT_SCALE_INIT if init is None else init)

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the source of the patch-dropout noise, needed only in training
        with ``vision.patch_dropout`` > 0."""
        shared = self.cfg.share_trunk
        trunk = self.transformer if shared else self.visual_transformer
        x = trunk(self.visual_stem(images, generator))
        proj = self.projection if shared else self.visual_projection
        feats = self.ln_post(x[:, 0]).to(torch.float32) @ proj
        return feats / feats.norm(dim=-1, keepdim=True) if normalize else feats

    def encode_text(self, tokens: torch.Tensor, normalize: bool = False) -> torch.Tensor:
        x = self.text_stem(tokens)
        if self.cfg.share_trunk:
            # a static causal flag, so the text pass takes the block kernels as the vision
            # pass does (an additive mask would force the plain path)
            x = self.transformer(x, causal=True)
            feats = self.ln_post(eot_pool(x, tokens)).to(torch.float32) @ self.projection
        else:
            x = self.text_transformer(x)
            feats = self.ln_final(eot_pool(x, tokens)).to(torch.float32) @ self.text_projection
        return feats / feats.norm(dim=-1, keepdim=True) if normalize else feats

    def forward(self, images, tokens, normalize: bool = True,
                generator: torch.Generator | None = None) -> dict:
        return {
            "image_features": self.encode_image(images, normalize=normalize,
                                                generator=generator),
            "text_features": self.encode_text(tokens, normalize=normalize),
            "logit_scale": self.logit_scale,
        }
