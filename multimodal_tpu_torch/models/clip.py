"""CLIP encoders, two-tower or shared-trunk, and the variational CLIP (port of
``multimodal_tpu/models/clip.py``: ``VisionStem``, ``TextStem``, ``eot_pool``, ``CLIP`` and
``VariationalCLIP``). With ``cfg.share_trunk`` one transformer, built from the vision
config, serves both modalities: the text pass runs it with a call-time ``causal=True``, and
both pool through one ``ln_post`` and one ``projection``.

Images are NHWC, as in the reference. The patch embedding is a reshape plus one matrix
product with the ``[P, P, 3, W]`` kernel (identical to the stride-P convolution, and with
TF32 left off it is true float32 on the card, which cuDNN's convolution is not by default).
The final projections run in float32. ``cfg.remat`` checkpoints every block in training,
``ls_init_value`` puts a LayerScale on both residual branches, ``vision.patch_dropout`` drops
patch tokens in training (the noise comes from the generator the caller hands in), and
``block_mlp=True`` sends every block's MLP half through the fused operator. The image
features pool the CLS row, or with ``vision.global_average_pool`` the mean over all tokens, or
with ``vision.attentional_pool`` row 0 of an ``AttentionalPooler``'s queries;
``vision.scaled_cosine`` gives the vision blocks (every block of a shared trunk) cosine
attention. A text tower whose ``context_length`` is above the block operator's longest
sequence runs every block through ``attention()``, from 2048 tokens up the flash kernels.

``VariationalCLIP`` appends one learned concentration token to each tower (S=51 and S=78
for ViT-B/32, both still on the block-attention operator) and emits a distribution's
parameters: the CLS / EOT rows feed the mean heads, the last row the concentration heads.

``cfg.lora_rank`` puts a LoRA adapter on every attention and MLP projection of both models'
trunks; ``vision.moe_experts`` makes every ``moe_every``-th block of a two-tower ``CLIP``'s
vision trunk a MoE block (the shared trunk and ``VariationalCLIP`` build none, as in the
reference); ``cfg.logit_bias_init`` gives ``CLIP`` the SigLIP head's ``logit_bias`` scalar,
returned beside ``logit_scale`` (``VariationalCLIP`` builds none). ``cfg.int8_forward`` puts
every dense MLP of both models' trunks (the shared trunk too; a MoE block's stays float) on
the SwitchBack int8 GEMMs (``ops.quant.int8_dense_train``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from multimodal_tpu_torch.models.config import CLIPConfig, VariationalConfig
from multimodal_tpu_torch.models.layers import (
    AttentionalPooler,
    LayerNorm,
    PatchDropout,
    Transformer,
    init_adapters,
    normal_,
    resolve_act,
)

LOGIT_SCALE_INIT = 2.6592  # ln(1/0.07)


class VisionStem(nn.Module):
    """Patchify + CLS [+ ``extra_tokens`` learned tokens after the patches] + positional
    embedding [+ patch dropout in training] + ln_pre -> token sequence."""

    def __init__(self, width: int, patch_size: int, image_size: int,
                 dtype: torch.dtype = torch.float32, patch_dropout: float = 0.0,
                 extra_tokens: int = 0):
        super().__init__()
        self.patch_dropout = (PatchDropout(patch_dropout, num_prefix=1)
                              if patch_dropout > 0.0 else None)
        self.width, self.patch_size, self.image_size, self.dtype = (
            width, patch_size, image_size, dtype)
        grid = image_size // patch_size
        self.patch_conv = nn.Parameter(torch.empty(patch_size, patch_size, 3, width))
        self.class_embedding = nn.Parameter(torch.empty(width))
        self.extra_embedding = (nn.Parameter(torch.empty(extra_tokens, width))
                                if extra_tokens else None)
        self.positional_embedding = nn.Parameter(
            torch.empty(grid * grid + 1 + extra_tokens, width))
        self.ln_pre = LayerNorm(width)

    def init_weights(self, generator: torch.Generator):
        # lecun_normal: truncated (+-2 std) normal with variance 1/fan_in, fan_in = P*P*3
        p = self.patch_size
        std = math.sqrt(1.0 / (p * p * 3)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.patch_conv, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
        normal_(self.class_embedding, self.width ** -0.5, generator)
        if self.extra_embedding is not None:
            normal_(self.extra_embedding, 1.0, generator)
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
        tokens = [self.class_embedding.to(self.dtype).expand(b, 1, self.width), x]
        if self.extra_embedding is not None:
            tokens.append(self.extra_embedding.to(self.dtype).expand(b, -1, self.width))
        x = torch.cat(tokens, dim=1) + self.positional_embedding.to(self.dtype)
        if self.patch_dropout is not None:
            x = self.patch_dropout(x, generator)
        return self.ln_pre(x)


class TextStem(nn.Module):
    """Token embedding [+ ``extra_tokens`` learned tokens after the context] + positional
    embedding -> token sequence."""

    def __init__(self, width: int, vocab_size: int, context_length: int,
                 dtype: torch.dtype = torch.float32, extra_tokens: int = 0):
        super().__init__()
        self.width, self.dtype = width, dtype
        self.token_embedding = nn.Parameter(torch.empty(vocab_size, width))
        self.extra_embedding = (nn.Parameter(torch.empty(extra_tokens, width))
                                if extra_tokens else None)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length + extra_tokens, width))

    def init_weights(self, generator: torch.Generator):
        normal_(self.token_embedding, 0.02, generator)
        if self.extra_embedding is not None:
            normal_(self.extra_embedding, self.width ** -0.5, generator)
        normal_(self.positional_embedding, 0.01, generator)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.token_embedding[tokens].to(self.dtype)
        if self.extra_embedding is not None:
            extra = self.extra_embedding.to(self.dtype).expand(x.shape[0], -1, self.width)
            x = torch.cat([x, extra], dim=1)
        return x + self.positional_embedding.to(self.dtype)


def eot_pool(x: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The EOT position's row: argmax works because EOT (49407) is the largest token id."""
    idx = tokens.argmax(dim=-1)
    return x[torch.arange(x.shape[0], device=x.device), idx]


class CLIP(nn.Module):
    """Two-tower CLIP, or the shared-trunk model when ``cfg.share_trunk``: ``encode_image``
    (NHWC float images), ``encode_text`` (int tokens). ``block_mlp`` (off by default, as in
    the reference) routes every block's MLP half through the fused operator."""

    def __init__(self, cfg: CLIPConfig, dtype: torch.dtype = torch.float32,
                 block_mlp: bool = False):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        v, t = cfg.vision, cfg.text
        act = resolve_act(cfg.act)
        trunk = dict(act=act, dtype=dtype, remat=cfg.remat, block_mlp=block_mlp,
                     lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                     int8_fwd=cfg.int8_forward)
        self.visual_stem = VisionStem(v.width, v.patch_size, v.image_size, dtype=dtype,
                                      patch_dropout=v.patch_dropout)
        self.text_stem = TextStem(t.width, t.vocab_size, t.context_length, dtype=dtype)
        if v.attentional_pool:
            self.attn_pool = AttentionalPooler(v.width, n_head=v.attn_pooler_heads,
                                               n_queries=v.n_queries, dtype=dtype)
        if cfg.share_trunk:
            if v.ls_init_value != t.ls_init_value:
                raise ValueError("a shared trunk needs vision and text ls_init_value to agree")
            self.transformer = Transformer(v.width, v.layers, v.heads, v.mlp_ratio,
                                           scale_heads=v.scale_heads,
                                           scaled_cosine=v.scaled_cosine,
                                           ls_init_value=v.ls_init_value, **trunk)
            self.ln_post = LayerNorm(v.width)
            self.projection = nn.Parameter(torch.empty(v.width, cfg.embed_dim))
        else:
            self.visual_transformer = Transformer(v.width, v.layers, v.heads, v.mlp_ratio,
                                                  scale_heads=v.scale_heads,
                                                  scaled_cosine=v.scaled_cosine,
                                                  ls_init_value=v.ls_init_value,
                                                  moe_experts=v.moe_experts,
                                                  moe_every=v.moe_every, moe_top_k=v.moe_top_k,
                                                  moe_capacity_factor=v.moe_capacity_factor,
                                                  **trunk)
            self.text_transformer = Transformer(t.width, t.layers, t.heads, t.mlp_ratio,
                                                causal=True, ls_init_value=t.ls_init_value,
                                                **trunk)
            self.ln_post = LayerNorm(v.width)
            self.ln_final = LayerNorm(t.width)
            self.visual_projection = nn.Parameter(torch.empty(v.width, cfg.embed_dim))
            self.text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.empty(()))
        if cfg.logit_bias_init is not None:  # the SigLIP head
            self.logit_bias = nn.Parameter(torch.empty(()))

    def init_weights(self, generator: torch.Generator):
        """The reference's init distributions, drawn from ``generator``; the LoRA adapters
        last, so the base weights are those of the same seed without them."""
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
            if self.cfg.logit_bias_init is not None:
                self.logit_bias.fill_(self.cfg.logit_bias_init)
        init_adapters(self, generator)

    def _pool_image(self, x: torch.Tensor) -> torch.Tensor:
        """CLS (default), the mean over all tokens, or row 0 of the attentional pooler."""
        if self.cfg.vision.attentional_pool:
            return self.attn_pool(x)[:, 0]
        if self.cfg.vision.global_average_pool:
            return x.mean(dim=1)
        return x[:, 0]

    def encode_image(self, images: torch.Tensor, normalize: bool = False,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """``generator``: the source of the patch-dropout noise, needed only in training
        with ``vision.patch_dropout`` > 0."""
        shared = self.cfg.share_trunk
        trunk = self.transformer if shared else self.visual_transformer
        x = trunk(self.visual_stem(images, generator))
        proj = self.projection if shared else self.visual_projection
        feats = self.ln_post(self._pool_image(x)).to(torch.float32) @ proj
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
        out = {
            "image_features": self.encode_image(images, normalize=normalize,
                                                generator=generator),
            "text_features": self.encode_text(tokens, normalize=normalize),
            "logit_scale": self.logit_scale,
        }
        if self.cfg.logit_bias_init is not None:
            out["logit_bias"] = self.logit_bias
        return out


class VariationalCLIP(nn.Module):
    """CLIP that emits distribution parameters: a learned concentration token is appended to
    both towers; the CLS / EOT row goes through ``ln_post`` / ``ln_final`` to the mean head,
    the concentration token's row to the concentration head, whose log-space value has a
    learned global offset and is clamped (``_concentration``). The trunks take ``remat``,
    ``act``, ``int8_forward`` and the LoRA adapters from the config and nothing else of its
    tower options, as in the reference; there is no patch dropout, no MoE and no ``logit_bias``."""

    def __init__(self, cfg: CLIPConfig, vcfg: VariationalConfig = VariationalConfig(),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if vcfg.model_type not in ("Spherical", "Gaussian"):
            raise ValueError(f"unknown VariationalConfig.model_type {vcfg.model_type!r}")
        self.cfg, self.vcfg, self.dtype = cfg, vcfg, dtype
        v, t = cfg.vision, cfg.text
        trunk = dict(act=resolve_act(cfg.act), dtype=dtype, remat=cfg.remat,
                     lora_rank=cfg.lora_rank, lora_alpha=cfg.lora_alpha,
                     int8_fwd=cfg.int8_forward)
        self.visual_stem = VisionStem(v.width, v.patch_size, v.image_size, dtype=dtype,
                                      extra_tokens=1)
        self.text_stem = TextStem(t.width, t.vocab_size, t.context_length, dtype=dtype,
                                  extra_tokens=1)
        self.visual_transformer = Transformer(v.width, v.layers, v.heads, v.mlp_ratio, **trunk)
        # causal over context_length + 1: the concentration token, last, sees every row
        self.text_transformer = Transformer(t.width, t.layers, t.heads, t.mlp_ratio,
                                            causal=True, **trunk)
        self.ln_post = LayerNorm(v.width)
        self.ln_final = LayerNorm(t.width)
        var_dim = 1 if self.spherical else cfg.embed_dim
        self.mean_image_projection = nn.Parameter(torch.empty(v.width, cfg.embed_dim))
        self.mean_text_projection = nn.Parameter(torch.empty(t.width, cfg.embed_dim))
        self.var_image_projection = nn.Parameter(torch.empty(v.width, var_dim))
        self.var_text_projection = nn.Parameter(torch.empty(t.width, var_dim))
        if self.spherical:
            self.log_concentration_scale_image = nn.Parameter(torch.empty(()))
            self.log_concentration_scale_text = nn.Parameter(torch.empty(()))
        self.logit_scale = nn.Parameter(torch.empty(()))

    @property
    def spherical(self) -> bool:
        return self.vcfg.model_type == "Spherical"

    def init_weights(self, generator: torch.Generator):
        """The reference's init distributions, drawn from ``generator``; the log
        concentration offsets start at log(initial - min); the LoRA adapters last."""
        for m in self.modules():
            if m is not self and hasattr(m, "init_weights"):
                m.init_weights(generator)
        vscale, tscale = self.cfg.vision.width ** -0.5, self.cfg.text.width ** -0.5
        normal_(self.mean_image_projection, vscale, generator)
        normal_(self.mean_text_projection, tscale, generator)
        normal_(self.var_image_projection, vscale, generator)
        normal_(self.var_text_projection, tscale, generator)
        with torch.no_grad():
            if self.spherical:
                target = math.log(self.vcfg.initial_concentration - self.vcfg.min_concentration)
                self.log_concentration_scale_image.fill_(target)
                self.log_concentration_scale_text.fill_(target)
            self.logit_scale.fill_(LOGIT_SCALE_INIT)
        init_adapters(self, generator)

    def _concentration(self, raw: torch.Tensor, log_scale) -> torch.Tensor:
        """Spherical: clamp(log_scale + raw, 1e-3, 20) -> exp -> clamp [min, max], each clamp
        as ``jnp.clip``'s maximum-then-minimum, so a tie splits its gradient as there.
        Gaussian: exp(raw), a variance per dimension."""
        if not self.spherical:
            return torch.exp(raw)
        bound = lambda value: torch.tensor(value, dtype=raw.dtype, device=raw.device)  # noqa: E731
        log_conc = torch.minimum(torch.maximum(log_scale + raw[..., 0], bound(1e-3)), bound(20.0))
        return torch.minimum(torch.maximum(torch.exp(log_conc),
                                           bound(self.vcfg.min_concentration)),
                             bound(self.vcfg.max_concentration))

    def encode_image(self, images: torch.Tensor):
        """NHWC float images -> (mean [B, E] float32, concentration [B] or variances [B, E])."""
        x = self.visual_transformer(self.visual_stem(images))
        mean = self.ln_post(x[:, 0]).to(torch.float32) @ self.mean_image_projection
        raw = self.ln_post(x[:, -1]).to(torch.float32) @ self.var_image_projection
        scale = self.log_concentration_scale_image if self.spherical else 0.0
        return mean, self._concentration(raw, scale)

    def encode_text(self, tokens: torch.Tensor):
        """Token ids -> (mean, concentration) as ``encode_image``."""
        x = self.text_transformer(self.text_stem(tokens))
        mean = self.ln_final(eot_pool(x, tokens)).to(torch.float32) @ self.mean_text_projection
        raw = self.ln_final(x[:, -1]).to(torch.float32) @ self.var_text_projection
        scale = self.log_concentration_scale_text if self.spherical else 0.0
        return mean, self._concentration(raw, scale)

    def forward(self, images: torch.Tensor, tokens: torch.Tensor) -> dict:
        image_mean, image_conc = self.encode_image(images)
        text_mean, text_conc = self.encode_text(tokens)
        return {"image_mean": image_mean, "image_concentration": image_conc,
                "text_mean": text_mean, "text_concentration": text_conc,
                "logit_scale": self.logit_scale}
