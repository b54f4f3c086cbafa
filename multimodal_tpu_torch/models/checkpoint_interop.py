"""The weight bridge into the port's ``CLIP``: OpenAI-CLIP-format state_dicts
(``load_openai_state_dict``) and the JAX package's own parameter tree (``load_jax_params``).

``load_openai_state_dict`` takes a real OpenAI CLIP ``state_dict`` (torch tensors) or the
numpy dict that ``multimodal_tpu/models/checkpoint_interop.py:export_torch_state_dict``
writes from JAX params (same names, fused ``in_proj`` [3W, W] with rows in q, k, v order).
Name mapping, two towers:

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

Shared trunk (``cfg.share_trunk``): ``transformer.resblocks.{i}.*`` -> ``transformer.*``,
``visual.ln_post`` (or ``ln_post``) -> ``ln_post``, ``projection`` (or ``text_projection``)
-> ``projection``; there is no ``ln_final``. That format has no key for the per-head
``attn.head_scale`` of a ``scale_heads`` model, none for the per-head ``attn.logit_scale`` of
a ``scaled_cosine`` one or the ``attn_pool.*`` leaves of an attentional pooler, and none for
the ``ls_1.gamma`` / ``ls_2.gamma`` of a model with ``ls_init_value`` (the exporter drops
them), so such models load through ``load_jax_params``, which takes the flax tree as it is: the same layouts as
the port's ([in, out] kernels, so ``mlp.c_fc`` and ``mlp.c_proj`` arrive as the block-MLP
kernels read them), only the names differ. It is also the only way into a
``VariationalCLIP``: its tree's ``extra_embedding`` tokens, ``mean_*`` / ``var_*_projection``
heads and ``log_concentration_scale_*`` offsets keep their names in the port.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from multimodal_tpu_torch.models.clip import CLIP, VariationalCLIP


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
        "logit_scale": _f32(sd["logit_scale"]).reshape(()),
    }
    if model.cfg.share_trunk:
        ln_post = "visual.ln_post" if "visual.ln_post.weight" in sd else "ln_post"
        out["ln_post.weight"] = _f32(sd[f"{ln_post}.weight"])
        out["ln_post.bias"] = _f32(sd[f"{ln_post}.bias"])
        out["projection"] = _f32(sd["projection" if "projection" in sd else "text_projection"])
        for i in range(model.cfg.vision.layers):
            out.update(_block(sd, f"transformer.resblocks.{i}", f"transformer.resblocks.{i}"))
        return out
    out.update({
        "ln_post.weight": _f32(sd["visual.ln_post.weight"]),
        "ln_post.bias": _f32(sd["visual.ln_post.bias"]),
        "ln_final.weight": _f32(sd["ln_final.weight"]),
        "ln_final.bias": _f32(sd["ln_final.bias"]),
        "visual_projection": _f32(sd["visual.proj"]),
        "text_projection": _f32(sd["text_projection"]),
    })
    for i in range(model.cfg.vision.layers):
        out.update(_block(sd, f"visual.transformer.resblocks.{i}",
                          f"visual_transformer.resblocks.{i}"))
    for i in range(model.cfg.text.layers):
        out.update(_block(sd, f"transformer.resblocks.{i}", f"text_transformer.resblocks.{i}"))
    return out


def jax_params_to_port(params: Mapping[str, Any]) -> dict:
    """The JAX package's flax tree ({'params': ...} or its inside; leaves numpy or anything
    ``np.asarray`` takes) -> the port's parameter names, float32 numpy values. Every leaf
    keeps its layout; ``.../resblock_3/ln_1/LayerNorm_0/scale`` becomes
    ``...resblocks.3.ln_1.weight``, ``.../resblock_3/ls_1/gamma`` ``...resblocks.3.ls_1.gamma``,
    and the flax wrappers around the patch kernel and the token table drop away."""
    tree = params["params"] if "params" in params else params
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + [key])
            return
        if path[-2:-1] == ["LayerNorm_0"]:
            path = path[:-2] + [{"scale": "weight", "bias": "bias"}[path[-1]]]
        elif path[-2:] in (["patch_conv", "kernel"], ["token_embedding", "embedding"]):
            path = path[:-1]
        name = ".".join(re.sub(r"^resblock_(\d+)$", r"resblocks.\1", k) for k in path)
        out[name] = _f32(node)

    walk(tree, [])
    return out


def _fill(model: CLIP | VariationalCLIP, converted: dict, what: str):
    """Copy ``converted`` (port names -> arrays) into ``model`` in place. Every parameter
    must be covered with its exact shape; a mismatch raises."""
    params = dict(model.named_parameters())
    if set(converted) != set(params):
        raise ValueError(f"{what} does not cover the model: missing "
                         f"{sorted(set(params) - set(converted))}, extra "
                         f"{sorted(set(converted) - set(params))}")
    for name, p in params.items():
        value = converted[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch at {name}: {value.shape} vs {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value, np.float32)))  # a writable copy
    return model


@torch.no_grad()
def load_openai_state_dict(model: CLIP, sd: Mapping[str, Any]) -> CLIP:
    """Copy an OpenAI-format state_dict into ``model`` in place (on its device). Every
    parameter must be covered with its exact shape; a mismatch raises."""
    return _fill(model, _openai_to_port(sd, model), "state_dict")


@torch.no_grad()
def load_jax_params(model: CLIP | VariationalCLIP, params: Mapping[str, Any]):
    """Copy the JAX package's flax parameter tree (of a ``CLIP`` or a ``VariationalCLIP``)
    into ``model`` in place (on its device), every leaf included (``attn.head_scale``,
    ``attn.logit_scale``, ``attn_pool.*``, the LayerScale ``gamma`` and the variational
    heads too). A mismatch in names or shapes raises."""
    return _fill(model, jax_params_to_port(params), "parameter tree")
