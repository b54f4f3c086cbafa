"""Int8-quantized CLIP encoders, the W8A8 serving path (port of
``multimodal_tpu/inference_quant.py``).

Every large product of the two-tower forward (attention q/k/v/out, MLP c_fc/c_proj, the two
final projections) runs ``ops.quant.int8_matmul``: per-row int8 activations, per-column int8
weights, an int32 product and a float32 rescale with the bias (on the card the hand-written
row-quantize kernel and the int8 GEMM with the rescale in its epilogue). What is sensitive to precision
stays float: LayerNorm (``ln_rows``, float32 statistics), the attention core (the plain path,
``attention(..., impl="xla")``, float32 softmax), the patch and token embeddings, the L2
normalize. Activations are bfloat16 throughout, whatever the model's compute dtype, as in the
reference.

``quantize_clip_params`` converts a model once at serving-load time; the functional encoders
``encode_image_q`` and ``encode_text_q`` consume its result. It refuses what the reference
refuses: the shared trunk, the attentional pooler, LayerScale, scaled-cosine attention, head
scales, MoE blocks and activations other than quick_gelu and tanh-gelu. A LoRA model is
quantized from its merged weights (``Dense.weight``); the reference quantizes the base kernel
alone and drops the adapters.
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.data.preprocess import normalize_images
from multimodal_tpu_torch.models.clip import CLIP
from multimodal_tpu_torch.models.layers import gelu, quick_gelu
from multimodal_tpu_torch.ops.attention import attention
from multimodal_tpu_torch.ops.block_attention import LN_EPS, ln_rows
from multimodal_tpu_torch.ops.quant import int8_matmul, quantize_weight

_QUANT_DENSE = ("query", "key", "value", "out", "c_fc", "c_proj")


def _refusals(model) -> list[str]:
    if not isinstance(model, CLIP):
        return [f"{type(model).__name__} (the two-tower CLIP family only)"]
    cfg = model.cfg
    unsupported = {
        "share_trunk": cfg.share_trunk,
        "attentional_pool": cfg.vision.attentional_pool,
        "ls_init_value": cfg.vision.ls_init_value or cfg.text.ls_init_value,
        "scaled_cosine": cfg.vision.scaled_cosine,
        "scale_heads": cfg.vision.scale_heads,
        "moe_experts": cfg.vision.moe_experts,
    }
    bad = [k for k, v in unsupported.items() if v]
    if cfg.act not in ("quick_gelu", "gelu"):
        bad.append(f"activation {cfg.act!r}")
    return bad


def _qdense(dense) -> dict:
    wq, scale = quantize_weight(dense.weight().detach(), "divide")
    return {"kernel_q": wq, "scale": scale, "bias": dense.bias.detach()}


def _qblocks(transformer) -> list[dict]:
    blocks = []
    for blk in transformer.resblocks:
        attn, mlp = blk.attn, blk.mlp
        dense = {k: getattr(attn, k) for k in _QUANT_DENSE[:4]}
        dense.update(c_fc=mlp.c_fc, c_proj=mlp.c_proj)
        blocks.append({"ln_1": tuple(t.detach() for t in blk.ln_1.params()),
                       "ln_2": tuple(t.detach() for t in blk.ln_2.params()),
                       **{k: _qdense(d) for k, d in dense.items()}})
    return blocks


def quantize_clip_params(model) -> dict:
    """Convert a two-tower ``CLIP``: every block's q/k/v/out, c_fc and c_proj and both final
    projections become ``{"kernel_q": int8 [out, in], "scale": float32 [out], "bias"}``, each
    weight quantized per output column in the load-time ("divide") form; the stems, LayerNorms
    and biases are the model's own float tensors (detached, not copied). Raises ``ValueError``
    naming what the quantized forward does not implement."""
    bad = _refusals(model)
    if bad:
        raise ValueError(f"quantized serving does not support {bad} (plain pre-LN blocks of "
                         "the two-tower CLIP family only)")
    vs, ts = model.visual_stem, model.text_stem
    return {
        "visual_stem": {"patch_conv": vs.patch_conv.detach(),
                        "class_embedding": vs.class_embedding.detach(),
                        "positional_embedding": vs.positional_embedding.detach(),
                        "ln_pre": tuple(t.detach() for t in vs.ln_pre.params())},
        "text_stem": {"token_embedding": ts.token_embedding.detach(),
                      "positional_embedding": ts.positional_embedding.detach()},
        "visual_blocks": _qblocks(model.visual_transformer),
        "text_blocks": _qblocks(model.text_transformer),
        "ln_post": tuple(t.detach() for t in model.ln_post.params()),
        "ln_final": tuple(t.detach() for t in model.ln_final.params()),
        "visual_projection": dict(zip(("kernel_q", "scale"),
                                      quantize_weight(model.visual_projection.detach(), "divide")),
                                  bias=None),
        "text_projection": dict(zip(("kernel_q", "scale"),
                                    quantize_weight(model.text_projection.detach(), "divide")),
                                bias=None),
    }


def _dense(p: dict, x: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    return int8_matmul(x, p["kernel_q"], p["scale"], bias=p["bias"], out_dtype=out_dtype)


def _ln(params, x: torch.Tensor) -> torch.Tensor:
    return ln_rows(x, params[0], params[1], LN_EPS)


def _block(p: dict, x: torch.Tensor, heads: int, causal: bool, act: str = "quick_gelu"):
    """Pre-LN residual block (``models/layers.py:ResidualBlock``) with int8 projections."""
    b, s, w = x.shape
    h_in = _ln(p["ln_1"], x)
    q, k, v = (_dense(p[name], h_in).reshape(b, s, heads, w // heads)
               for name in ("query", "key", "value"))
    o = attention(q, k, v, causal=causal, impl="xla").reshape(b, s, w)
    x = x + _dense(p["out"], o)
    h = _dense(p["c_fc"], _ln(p["ln_2"], x))
    h = quick_gelu(h) if act == "quick_gelu" else gelu(h)
    return x + _dense(p["c_proj"], h)


def _unit(feats: torch.Tensor) -> torch.Tensor:
    return feats / torch.linalg.vector_norm(feats, dim=-1, keepdim=True)


def encode_image_q(qparams: dict, cfg, images: torch.Tensor,
                   normalize: bool = True) -> torch.Tensor:
    """Quantized twin of ``CLIP.encode_image``: NHWC uint8 (normalized here) or normalized
    float images -> float32 [B, embed_dim]. The patch embedding runs in bfloat16, then
    ``ln_pre``, the blocks, CLS or global-average pooling, ``ln_post`` and the int8
    projection with a float32 output."""
    stem, v = qparams["visual_stem"], cfg.vision
    if images.dtype == torch.uint8:
        images = normalize_images(images)
    b, p, g = images.shape[0], v.patch_size, v.image_size // v.patch_size
    bf16 = torch.bfloat16
    patches = images.to(bf16).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    kernel = stem["patch_conv"].reshape(p * p * 3, v.width).to(bf16)
    x = patches.reshape(b, g * g, p * p * 3) @ kernel
    cls = stem["class_embedding"].to(bf16).expand(b, 1, v.width)
    x = torch.cat([cls, x], dim=1) + stem["positional_embedding"].to(bf16)
    x = _ln(stem["ln_pre"], x)
    for blk in qparams["visual_blocks"]:
        x = _block(blk, x, v.heads, causal=False, act=cfg.act)
    pooled = x.mean(dim=1) if v.global_average_pool else x[:, 0]
    feats = _dense(qparams["visual_projection"], _ln(qparams["ln_post"], pooled),
                   out_dtype=torch.float32)
    return _unit(feats) if normalize else feats


def encode_text_q(qparams: dict, cfg, tokens: torch.Tensor,
                  normalize: bool = True) -> torch.Tensor:
    """Quantized twin of ``CLIP.encode_text``: int tokens [B, context_length] -> float32
    [B, embed_dim]; a bfloat16 token embedding, causal blocks, EOT pooling (the largest
    token id), ``ln_final`` and the int8 projection."""
    stem, t = qparams["text_stem"], cfg.text
    bf16 = torch.bfloat16
    x = stem["token_embedding"][tokens].to(bf16) + stem["positional_embedding"].to(bf16)
    for blk in qparams["text_blocks"]:
        x = _block(blk, x, t.heads, causal=True, act=cfg.act)
    eot = x[torch.arange(x.shape[0], device=x.device), tokens.argmax(dim=-1)]
    feats = _dense(qparams["text_projection"], _ln(qparams["ln_final"], eot),
                   out_dtype=torch.float32)
    return _unit(feats) if normalize else feats
