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
heads and ``log_concentration_scale_*`` offsets keep their names in the port. The MoE
blocks' ``moe_mlp.*`` leaves (stacked experts, router), the LoRA ``*.lora_a`` / ``*.lora_b``
adapters and the SigLIP ``logit_bias`` keep theirs too; ``jax_adapters_to_port`` renames a
flat ``extract_lora`` dict of the JAX package.

``load_openai_state_dict`` into a model with LoRA adapters fills the base weights and leaves
the adapters as they are (a pretrained base under fresh adapters); into a model built at
another image size it resizes the visual positional table with ``resize_pos_embed``, the
reference's bicubic. ``export_openai_state_dict`` is its inverse, for a model the format
covers.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from multimodal_tpu_torch.models.clip import CLIP, VariationalCLIP
from multimodal_tpu_torch.models.lora import ALPHA_KEY, is_lora_leaf


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    """Keys' cubic convolution kernel (a = -0.5) at distances x >= 0."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of ``jax.image.resize(method="bicubic")`` along one axis:
    half-pixel sample points, the kernel widened by the scale when shrinking (antialias),
    each column normalized to sum 1, columns whose sample falls outside the input zero."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(n_out) / f32(n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    w = _keys_cubic(np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) / kernel_scale)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, 1), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(f32)


def resize_pos_embed(pos: np.ndarray, target_len: int, num_prefix: int = 1) -> np.ndarray:
    """Bicubic-resize the square grid part of a ViT positional table [1 + g*g, W] to
    ``target_len`` rows, as the reference does (``jax.image.resize``'s bicubic); the prefix
    (CLS) rows pass through unchanged."""
    if pos.shape[0] == target_len:
        return pos
    prefix, grid = pos[:num_prefix], pos[num_prefix:]
    old, new = int(np.sqrt(grid.shape[0])), int(np.sqrt(target_len - num_prefix))
    if old * old != grid.shape[0] or new * new != target_len - num_prefix:
        raise ValueError(f"cannot resize pos embed {pos.shape[0]} -> {target_len}")
    w = _resize_weights(old, new)
    img = np.asarray(grid, np.float32).reshape(old, old, -1)
    resized = np.einsum("hwc,hi,wj->ijc", img, w, w).reshape(new * new, -1)
    return np.concatenate([prefix, resized], axis=0).astype(pos.dtype)


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
    grid = model.cfg.vision.image_size // model.cfg.vision.patch_size
    out = {
        "visual_stem.patch_conv": np.transpose(_f32(sd["visual.conv1.weight"]), (2, 3, 1, 0)),
        "visual_stem.class_embedding": _f32(sd["visual.class_embedding"]),
        "visual_stem.positional_embedding": resize_pos_embed(
            _f32(sd["visual.positional_embedding"]), grid * grid + 1),
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


def _port_name(path: list) -> str:
    """A flax leaf path -> the port's parameter name."""
    if path[-2:-1] == ["LayerNorm_0"]:
        path = path[:-2] + [{"scale": "weight", "bias": "bias"}[path[-1]]]
    elif path[-2:] in (["patch_conv", "kernel"], ["token_embedding", "embedding"]):
        path = path[:-1]
    return ".".join(re.sub(r"^resblock_(\d+)$", r"resblocks.\1", k) for k in path)


def jax_params_to_port(params: Mapping[str, Any]) -> dict:
    """The JAX package's flax tree ({'params': ...} or its inside; leaves numpy or anything
    ``np.asarray`` takes) -> the port's parameter names, float32 numpy values. Every leaf
    keeps its layout; ``.../resblock_3/ln_1/LayerNorm_0/scale`` becomes
    ``...resblocks.3.ln_1.weight``, ``.../resblock_3/ls_1/gamma`` ``...resblocks.3.ls_1.gamma``,
    ``.../resblock_1/moe_mlp/router/kernel`` ``...resblocks.1.moe_mlp.router.kernel``, and the
    flax wrappers around the patch kernel and the token table drop away."""
    tree = params["params"] if "params" in params else params
    out = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for key, child in node.items():
                walk(child, path + [key])
            return
        out[_port_name(path)] = _f32(node)

    walk(tree, [])
    return out


def jax_adapters_to_port(adapters: Mapping[str, Any]) -> dict:
    """A flat adapter dict of the JAX package's ``extract_lora`` ("/"-joined flax paths) ->
    the port's names, float32 numpy values; the ``ALPHA_KEY`` entry stays as it is."""
    out = {_port_name(k.split("/")): _f32(v) for k, v in adapters.items() if k != ALPHA_KEY}
    if ALPHA_KEY in adapters:
        out[ALPHA_KEY] = np.float32(adapters[ALPHA_KEY])
    return out


def _fill(model: CLIP | VariationalCLIP, converted: dict, what: str, keep=lambda name: False):
    """Copy ``converted`` (port names -> arrays) into ``model`` in place. Every parameter
    must be covered with its exact shape, except those ``keep`` names, which stay as they
    are when ``converted`` lacks them; a mismatch raises."""
    params = dict(model.named_parameters())
    missing = {n for n in set(params) - set(converted) if not keep(n)}
    extra = set(converted) - set(params)
    if missing or extra:
        raise ValueError(f"{what} does not cover the model: missing {sorted(missing)}, "
                         f"extra {sorted(extra)}")
    for name, p in params.items():
        if name not in converted:
            continue
        value = converted[name]
        if tuple(value.shape) != tuple(p.shape):
            raise ValueError(f"shape mismatch at {name}: {value.shape} vs {tuple(p.shape)}")
        p.copy_(torch.from_numpy(np.array(value, np.float32)))  # a writable copy
    return model


@torch.no_grad()
def load_openai_state_dict(model: CLIP, sd: Mapping[str, Any]) -> CLIP:
    """Copy an OpenAI-format state_dict into ``model`` in place (on its device). Every
    parameter but the LoRA adapters must be covered with its exact shape, after the visual
    positional table is resized to the model's grid; a mismatch raises. The adapters keep
    their values (the reference's ``load_pretrained``: a base checkpoint under fresh
    adapters)."""
    return _fill(model, _openai_to_port(sd, model), "state_dict", keep=is_lora_leaf)


def _export_block(get, src: str, dst: str) -> dict:
    """One block's port leaves (``get(name)``) -> OpenAI names (q, k, v re-fused into
    in_proj [3W, W])."""
    g = lambda name: get(f"{src}.{name}")  # noqa: E731
    qkv = ("query", "key", "value")
    return {
        f"{dst}.attn.in_proj_weight": np.concatenate([g(f"attn.{k}.kernel").T for k in qkv]),
        f"{dst}.attn.in_proj_bias": np.concatenate([g(f"attn.{k}.bias") for k in qkv]),
        f"{dst}.attn.out_proj.weight": g("attn.out.kernel").T,
        f"{dst}.attn.out_proj.bias": g("attn.out.bias"),
        f"{dst}.ln_1.weight": g("ln_1.weight"), f"{dst}.ln_1.bias": g("ln_1.bias"),
        f"{dst}.ln_2.weight": g("ln_2.weight"), f"{dst}.ln_2.bias": g("ln_2.bias"),
        f"{dst}.mlp.c_fc.weight": g("mlp.c_fc.kernel").T,
        f"{dst}.mlp.c_fc.bias": g("mlp.c_fc.bias"),
        f"{dst}.mlp.c_proj.weight": g("mlp.c_proj.kernel").T,
        f"{dst}.mlp.c_proj.bias": g("mlp.c_proj.bias"),
    }


@torch.no_grad()
def export_openai_state_dict(model: CLIP) -> dict:
    """``model``'s parameters as an OpenAI-format state_dict (float32 numpy values), the
    inverse of ``load_openai_state_dict`` and the layout of the reference's
    ``export_torch_state_dict``. A leaf the format has no key for (LoRA adapters, MoE
    experts, head scales, LayerScale, the SigLIP bias, ...) raises rather than being
    dropped; merge adapters first (``merge_lora``)."""
    p = {n: t.detach().to("cpu", torch.float32).numpy() for n, t in model.named_parameters()}
    used: set = set()

    def g(name):
        used.add(name)
        return p[name]

    sd = {
        "visual.conv1.weight": np.transpose(g("visual_stem.patch_conv"), (3, 2, 0, 1)),
        "visual.class_embedding": g("visual_stem.class_embedding"),
        "visual.positional_embedding": g("visual_stem.positional_embedding"),
        "visual.ln_pre.weight": g("visual_stem.ln_pre.weight"),
        "visual.ln_pre.bias": g("visual_stem.ln_pre.bias"),
        "token_embedding.weight": g("text_stem.token_embedding"),
        "positional_embedding": g("text_stem.positional_embedding"),
        "logit_scale": g("logit_scale"),
        "visual.ln_post.weight": g("ln_post.weight"),
        "visual.ln_post.bias": g("ln_post.bias"),
    }
    cfg = model.cfg
    if cfg.share_trunk:
        towers = [("transformer", "transformer", cfg.vision.layers)]
        sd["projection"] = g("projection")
    else:
        towers = [("visual_transformer", "visual.transformer", cfg.vision.layers),
                  ("text_transformer", "transformer", cfg.text.layers)]
        sd.update({"ln_final.weight": g("ln_final.weight"), "ln_final.bias": g("ln_final.bias"),
                   "visual.proj": g("visual_projection"),
                   "text_projection": g("text_projection")})
    for src, dst, layers in towers:
        for i in range(layers):
            try:
                sd.update(_export_block(g, f"{src}.resblocks.{i}", f"{dst}.resblocks.{i}"))
            except KeyError as err:
                raise ValueError(f"the OpenAI format has no key for {src}.resblocks.{i}: "
                                 f"{err}") from None
    left = sorted(set(p) - used)
    if left:
        raise ValueError(f"the OpenAI format has no key for {left}")
    return sd


@torch.no_grad()
def load_jax_params(model: CLIP | VariationalCLIP, params: Mapping[str, Any]):
    """Copy the JAX package's flax parameter tree (of a ``CLIP`` or a ``VariationalCLIP``)
    into ``model`` in place (on its device), every leaf included (``attn.head_scale``,
    ``attn.logit_scale``, ``attn_pool.*``, the LayerScale ``gamma`` and the variational
    heads too). A mismatch in names or shapes raises."""
    return _fill(model, jax_params_to_port(params), "parameter tree")
