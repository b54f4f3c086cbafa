"""The large-ViT family and the other shipped configs in the port against the JAX package, on
the CPU: ViT-L/14, ViT-H/14, ViT-g/14 (S = 257 from 224 px images and 14 px patches; H/14 and
g/14 with the tanh GELU and head dims 80 and 88, g/14's MLP 4.3637 x 1408 floored to 6144),
ViT-L-16, ViT-S-16-128, ViT-B-16-512 and ViT-B-32-two-tower-16.

- Each config parses to the same dataclass, field by field, in both packages; the block
  operator's support, its LayerNorm fold and the fused / flash choices agree per tower with
  the JAX package's rules at that tower's S, W and H (tolerance: none, equality).
- At full width with one layer a tower, the port's model has the parameter names and shapes
  that the JAX package's ``export_torch_state_dict`` gives (through the port's own
  ``export_openai_state_dict``), its MLP hidden width is JAX's, and its forward takes the route
  those rules name: one call of the LN-fold operator per vision block (S > 128), one of the
  non-LN operator per text block.
- At two layers a tower, loss and every gradient leaf against ``jax.grad`` through
  ``load_jax_params``, at ``tests/test_torch_train_step.py``'s float32 tolerances (loss rtol
  1e-5; each leaf atol 1e-4 x max(1, max|leaf|), rtol 1e-3), at widths where the port's
  dispatch takes the full config's route: head dim 64 (L/14) at W=256 H=4, head dim 80 (H/14)
  at W=640 H=8. Head dim 88 has no narrower width the operator takes (W must be a multiple of
  128, so 88 H must be: H a multiple of 16), so g/14's case runs at its own W=1408 H=16. The
  JAX package's block kernel runs only on a TPU, so its side is the plain attention path; the
  port's is the block operator's plain versions (``ops/block_attention.py``).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
from multimodal_tpu.models.config import get_model_config as jax_get_model_config
from multimodal_tpu.ops import block_attention as jax_ba
from multimodal_tpu.ops import flash_attention as jax_fl
from multimodal_tpu.ops import fused_attention as jax_fa
from multimodal_tpu_torch.models import (
    add_model_config,
    create_model,
    export_openai_state_dict,
    get_model_config,
    load_jax_params,
)
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.ops import block_attention as ba
from multimodal_tpu_torch.ops import flash_attention as fl
from multimodal_tpu_torch.ops import fused_attention as fa
from torch_jax_models import assert_grads_close, batch, random_params

torch.set_num_threads(1)

CONFIGS = ["ViT-L-14", "ViT-H-14", "ViT-g-14", "ViT-L-16", "ViT-S-16-128", "ViT-B-16-512",
           "ViT-B-32-two-tower-16"]
LARGE = {"ViT-L-14": (24, 1024, 64), "ViT-H-14": (32, 1280, 80), "ViT-g-14": (40, 1408, 88)}
B = 2


def _towers(cfg):
    """(name, S, W, H, causal) of each tower's attention; a shared trunk's two passes."""
    s_vision = (cfg.vision.image_size // cfg.vision.patch_size) ** 2 + 1
    return [("vision", s_vision, cfg.vision.width, cfg.vision.heads, False),
            ("text", cfg.text.context_length, cfg.text.width, cfg.text.heads, True)]


def _jax_ln_fold(s: int) -> bool:
    """The JAX package's default fold rule (``block_attention``): S > 128 and the whole-group
    projection on the 16-aligned length it pads to."""
    return s > 128 and jax_ba._group_proj_enabled(s + (-s) % 16)


def _register(name: str, base: str, vision: dict, text: dict) -> str:
    """``base``'s JSON with ``vision`` / ``text`` overrides, registered in both packages."""
    import json

    from multimodal_tpu_torch.paths import CONFIG_DIR

    with open(f"{CONFIG_DIR}/{base}.json") as f:
        d = json.load(f)
    d["vision_cfg"].update(vision)
    d["text_cfg"].update(text)
    jax_add_model_config(name, d)
    add_model_config(name, d)
    return name


@pytest.mark.parametrize("name", CONFIGS)
def test_config_equals_jax_field_by_field(name):
    got, want = get_model_config(name), jax_get_model_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    s_vision = (got.vision.image_size // got.vision.patch_size) ** 2 + 1
    if name in LARGE:
        layers, width, head_dim = LARGE[name]
        assert (got.vision.layers, got.vision.width, got.vision.heads) == (layers, width, 16)
        assert got.vision.width // got.vision.heads == head_dim
        assert (got.vision.image_size, got.vision.patch_size, s_vision) == (224, 14, 257)
        assert got.act == ("quick_gelu" if name == "ViT-L-14" else "gelu")
    if name == "ViT-g-14":
        assert got.vision.mlp_ratio == 4.3637
        assert int(got.vision.width * got.vision.mlp_ratio) == 6144
    if name in ("ViT-H-14", "ViT-g-14"):
        assert (got.text.width, got.text.heads, got.text.layers) == (1024, 16, 24)


@pytest.mark.parametrize("name", CONFIGS)
def test_dispatch_agrees_with_jax_per_tower(name):
    """Block-operator support, the LN fold, and the fused / flash choice of the plain-path
    fallback, per tower at the config's S, W, H (and B=8, which the rules ignore)."""
    cfg = get_model_config(name)
    for tower, s, w, h, causal in _towers(cfg):
        d = w // h
        port = (ba.block_attn_supported(8, s, w, h), s > ba.LN_FOLD_MIN_SEQ,
                fa.fused_supported(s, d), fl.flash_supported((8, s, h, d), (8, s, h, d), causal))
        ref = (jax_ba.block_attn_supported(8, s, w, h), _jax_ln_fold(s),
               jax_fa.fused_supported(s, d),
               jax_fl.flash_supported((8, s, h, d), (8, s, h, d), causal))
        assert port == ref, (tower, s, w, h)
        assert port[0], f"{name} {tower}: every shipped tower takes the block operator"
    if name in LARGE:
        assert [t[1] > ba.LN_FOLD_MIN_SEQ for t in _towers(cfg)] == [True, False]


@functools.lru_cache(maxsize=None)
def _one_layer(name: str) -> str:
    return _register(f"{name}-1layer", name, {"layers": 1}, {"layers": 1})


@pytest.mark.parametrize("name", CONFIGS)
def test_full_width_parameters_and_route(name, monkeypatch):
    """Full width, one layer a tower: the OpenAI-format names and shapes of JAX's export, the
    MLP's hidden width, and the operator each tower's block calls in a forward."""
    one = _one_layer(name)
    cfg = get_model_config(one)
    jm = jax_create_model(one)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *batch(cfg, 1)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in export_torch_state_dict(zeros, jm.cfg).items()}
    model = create_model(one, device="cpu")
    got = {k: tuple(v.shape) for k, v in export_openai_state_dict(model).items()}
    assert got == want
    hidden = int(cfg.vision.width * cfg.vision.mlp_ratio)
    block = (model.transformer if cfg.share_trunk else model.visual_transformer).resblocks[0]
    assert block.mlp.hidden == hidden
    if name == "ViT-g-14":
        assert hidden == 6144

    calls = []
    real_ln, real_apply = ba.block_attention_ln, ba.BlockAttention.apply
    monkeypatch.setattr(ba, "block_attention_ln",
                        lambda x, *a, **k: calls.append(("ln", x.shape[1])) or real_ln(x, *a, **k))
    monkeypatch.setattr(ba.BlockAttention, "apply",
                        lambda x, *a: calls.append(("plain", x.shape[1])) or real_apply(x, *a))
    images, tokens = (torch.from_numpy(a) for a in batch(cfg, 1))
    with torch.no_grad():
        model.encode_image(images)
        model.encode_text(tokens.long())
    (_, s_vision, *_), (_, s_text, *_) = _towers(cfg)
    route = lambda s: "ln" if s > ba.LN_FOLD_MIN_SEQ else "plain"  # noqa: E731
    assert calls == [(route(s_vision), s_vision), (route(s_text), s_text)]


# (case, base config, vision overrides, text overrides): two layers a tower at widths where the
# port's dispatch takes the full config's route (the vision blocks through the LN-fold operator
# at S = 257, the text blocks through the non-LN one at S = 77 causal)
ROUTES = [
    ("L14-D64", "ViT-L-14", {"width": 256, "heads": 4, "layers": 2},
     {"width": 256, "heads": 4, "layers": 2}),
    ("H14-D80", "ViT-H-14", {"width": 640, "heads": 8, "layers": 2},
     {"width": 256, "heads": 4, "layers": 2}),
    ("g14-D88", "ViT-g-14", {"layers": 2}, {"width": 256, "heads": 4, "layers": 2}),
]


@pytest.mark.parametrize("case,base,vision,text", ROUTES, ids=[r[0] for r in ROUTES])
def test_two_layer_loss_and_gradients_match_jax(case, base, vision, text):
    from multimodal_tpu.train.engine import make_loss_fn as jax_loss_fn
    from multimodal_tpu_torch.train import make_loss_fn

    name = _register(f"{base}-{case}", base, vision, text)
    cfg = get_model_config(name)
    (_, s, w, h, _), (_, st, wt, ht, _) = _towers(cfg)
    assert s == 257 and ba.block_attn_supported(B, s, w, h) and s > ba.LN_FOLD_MIN_SEQ
    assert ba.block_attn_supported(B, st, wt, ht) and st <= ba.LN_FOLD_MIN_SEQ
    assert w // h == {"L14": 64, "H14": 80, "g14": 88}[case[:3]]
    jm = jax_create_model(name)
    params = random_params(jm)
    pm = load_jax_params(create_model(name, device="cpu"), params)
    images, tokens = batch(jm.cfg, B)
    loss_fn = jax_loss_fn(jm, "clip")
    data = {"image": images, "text": tokens}
    want_loss, want = jax.value_and_grad(
        lambda p: loss_fn(p, data, jax.random.PRNGKey(0))[0])(params)
    pm.zero_grad(set_to_none=True)
    loss, _ = make_loss_fn(pm, "clip")(
        pm, {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    got = {n: p.grad.numpy() for n, p in pm.named_parameters()}
    assert_grads_close(got, jax_params_to_port(jax.device_get(want)))
