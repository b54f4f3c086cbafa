"""The weight bridge: OpenAI-CLIP-format state_dicts into the port's ``CLIP``.

Takes a real OpenAI CLIP ``state_dict`` (torch tensors) or the numpy dict that
``multimodal_tpu/models/checkpoint_interop.py:export_torch_state_dict`` writes from JAX
params (same names, fused ``in_proj`` [3W, W] with rows in q, k, v order). Name mapping:

    visual.conv1.weight [W,3,P,P]         -> visual_stem.patch_conv [P,P,3,W]
    visual.{class,positional}_embedding   -> visual_stem.*
    visual.ln_pre                         -> visual_stem.ln_pre
    visual.transformer.resblocks.{i}.*    -> visual_transformer.resblocks.{i}.*
    transformer.resblocks.{i}.*           -> text_transformer.resblocks.{i}.*
        attn.in_proj_{weight,bias}        -> attn.{query,key,value}.{kernel (transposed),bias}
        attn.out_proj / mlp.c_fc / mlp.c_proj -> attn.out / mlp.c_fc / mlp.c_proj (transposed)
        ln_1 / ln_2                       -> ln_1 / ln_2
    visual.ln_post / visual.proj          -> ln_post / visual_projection
    token_embedding.weight / positional_embedding -> text_stem.*
    ln_final / text_projection / logit_scale       -> the same names
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from multimodal_tpu_torch.models.clip import CLIP


def _strip_prefixes(sd: Mapping[str, Any]) -> dict:
    """Unwrap {'state_dict': ...} nesting and strip DDP 'module.'/'_orig_mod.' prefixes."""
    if "state_dict" in sd and isinstance(sd["state_dict"], Mapping):
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        for pre in ("module.", "_orig_mod."):
            if k.startswith(pre):
                k = k[len(pre):]
        out[k] = v
    return out


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v, np.float32)


def _block(sd: dict, src: str, dst: str) -> dict:
    qw, kw, vw = np.split(_f32(sd[f"{src}.attn.in_proj_weight"]), 3, axis=0)
    qb, kb, vb = np.split(_f32(sd[f"{src}.attn.in_proj_bias"]), 3, axis=0)
    out = {
        f"{dst}.attn.query.kernel": qw.T, f"{dst}.attn.query.bias": qb,
        f"{dst}.attn.key.kernel": kw.T, f"{dst}.attn.key.bias": kb,
        f"{dst}.attn.value.kernel": vw.T, f"{dst}.attn.value.bias": vb,
        f"{dst}.attn.out.kernel": _f32(sd[f"{src}.attn.out_proj.weight"]).T,
        f"{dst}.attn.out.bias": _f32(sd[f"{src}.attn.out_proj.bias"]),
        f"{dst}.mlp.c_fc.kernel": _f32(sd[f"{src}.mlp.c_fc.weight"]).T,
        f"{dst}.mlp.c_fc.bias": _f32(sd[f"{src}.mlp.c_fc.bias"]),
        f"{dst}.mlp.c_proj.kernel": _f32(sd[f"{src}.mlp.c_proj.weight"]).T,
        f"{dst}.mlp.c_proj.bias": _f32(sd[f"{src}.mlp.c_proj.bias"]),
    }
    for ln in ("ln_1", "ln_2"):
        out[f"{dst}.{ln}.weight"] = _f32(sd[f"{src}.{ln}.weight"])
        out[f"{dst}.{ln}.bias"] = _f32(sd[f"{src}.{ln}.bias"])
    return out


def _openai_to_port(sd: Mapping[str, Any], model: CLIP) -> dict:
    """OpenAI-format state_dict -> the port's parameter names (float32 numpy values)."""
    sd = _strip_prefixes(sd)
    out = {
        "visual_stem.patch_conv": np.transpose(_f32(sd["visual.conv1.weight"]), (2, 3, 1, 0)),
        "visual_stem.class_embedding": _f32(sd["visual.class_embedding"]),
        "visual_stem.positional_embedding": _f32(sd["visual.positional_embedding"]),
        "visual_stem.ln_pre.weight": _f32(sd["visual.ln_pre.weight"]),
        "visual_stem.ln_pre.bias": _f32(sd["visual.ln_pre.bias"]),
        "text_stem.token_embedding": _f32(sd["token_embedding.weight"]),
        "text_stem.positional_embedding": _f32(sd["positional_embedding"]),
        "ln_post.weight": _f32(sd["visual.ln_post.weight"]),
        "ln_post.bias": _f32(sd["visual.ln_post.bias"]),
        "ln_final.weight": _f32(sd["ln_final.weight"]),
        "ln_final.bias": _f32(sd["ln_final.bias"]),
        "visual_projection": _f32(sd["visual.proj"]),
        "text_projection": _f32(sd["text_projection"]),
        "logit_scale": _f32(sd["logit_scale"]).reshape(()),
    }
    for i in range(model.cfg.vision.layers):
        out.update(_block(sd, f"visual.transformer.resblocks.{i}",
                          f"visual_transformer.resblocks.{i}"))
    for i in range(model.cfg.text.layers):
        out.update(_block(sd, f"transformer.resblocks.{i}", f"text_transformer.resblocks.{i}"))
    return out


@torch.no_grad()
def load_openai_state_dict(model: CLIP, sd: Mapping[str, Any]) -> CLIP:
    """Copy an OpenAI-format state_dict into ``model`` in place (on its device). Every
    parameter must be covered with its exact shape; a mismatch raises."""
    converted = _openai_to_port(sd, model)
    params = dict(model.named_parameters())
    if set(converted) != set(params):
        raise ValueError(f"state_dict does not cover the model: missing "
                         f"{sorted(set(params) - set(converted))}, extra "
                         f"{sorted(set(converted) - set(params))}")
    for name, p in params.items():
        value = converted[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch at {name}: {value.shape} vs {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value, np.float32)))  # a writable copy
    return model
