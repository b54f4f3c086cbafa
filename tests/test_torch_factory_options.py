"""The port's ``create_model`` options against the JAX package's ``create_model``: the same
config field for field for each option, the forward of a model built at a forced image size
(weights through ``load_jax_params``; tolerance 2e-4, ``tests/test_torch_clip.py``'s), the
refusals, and the positional table's bicubic resize against JAX's
``convert_torch_state_dict`` (float32 weights of one sum order: 1e-6).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models.checkpoint_interop import (
    convert_torch_state_dict,
    export_torch_state_dict,
)
from multimodal_tpu.models.checkpoint_interop import resize_pos_embed as jax_resize_pos_embed
from multimodal_tpu_torch.models import create_model, load_jax_params, load_openai_state_dict
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port, resize_pos_embed
from multimodal_tpu_torch.models.factory import model_config
from multimodal_tpu_torch.models.layers import MLP
from torch_jax_models import batch, random_params

torch.set_num_threads(1)

OPTIONS = [
    {"force_image_size": 48},
    {"remat": True},
    {"remat": False},
    {"patch_dropout": 0.5},
    {"force_quick_gelu": True},
    {"siglip": True},
    {"lora_rank": 4},
    {"lora_rank": 4, "lora_alpha": 8.0},
    {"lora_rank": 0, "lora_alpha": 8.0},
    {"force_image_size": 64, "remat": True, "lora_rank": 2, "siglip": True,
     "patch_dropout": 0.25},
]


@pytest.mark.parametrize("name", ["tiny-test", "ViT-B-32"])
@pytest.mark.parametrize("options", OPTIONS, ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_each_option_builds_the_jax_config(name, options):
    """``model_config`` (what ``create_model`` builds from) equals JAX's ``cfg`` field for
    field; at tiny-test the built model carries it."""
    if name == "ViT-B-32" and options.get("force_image_size"):
        options = dict(options, force_image_size=384)
    want = dataclasses.asdict(jax_create_model(name, **options).cfg)
    assert dataclasses.asdict(model_config(name, **options)) == want
    if name == "tiny-test":
        assert dataclasses.asdict(create_model(name, device="cpu", **options).cfg) == want


def test_option_effects_on_the_model():
    m = create_model("tiny-test", device="cpu", siglip=True, remat=True, patch_dropout=0.5)
    torch.testing.assert_close(m.logit_bias, torch.tensor(-10.0))
    torch.testing.assert_close(m.logit_scale, torch.tensor(float(np.log(10.0))))
    assert m.visual_transformer.remat and m.text_transformer.remat
    assert m.visual_stem.patch_dropout.rate == 0.5
    images, tokens = batch(m.cfg, 2)
    with torch.no_grad():
        out = m(torch.from_numpy(images).float(), torch.from_numpy(tokens).long())
    assert out["logit_bias"] is m.logit_bias
    assert "logit_bias" not in create_model("tiny-test", device="cpu")(
        torch.from_numpy(images).float(), torch.from_numpy(tokens).long())


def test_force_image_size_forward_matches_jax_at_48px():
    """tiny-test (patch 16) at 48 px: a 3 x 3 grid, S = 10 in the vision tower."""
    jm = jax_create_model("tiny-test", force_image_size=48)
    params = random_params(jm)
    pm = load_jax_params(create_model("tiny-test", force_image_size=48, device="cpu"), params)
    assert pm.visual_stem.positional_embedding.shape == (10, 64)
    images, tokens = batch(jm.cfg, 3)
    images = images.astype(np.float32) / 255.0 - 0.5
    want = jm.apply(params, images, tokens)
    with torch.no_grad():
        got = pm(torch.from_numpy(images), torch.from_numpy(tokens).long())
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=2e-4, rtol=2e-4,
                                   err_msg=k)


def test_force_image_size_off_the_patch_grid_raises():
    with pytest.raises(ValueError, match="not a multiple of the model's patch size 16") as port:
        create_model("tiny-test", force_image_size=40, device="cpu")
    with pytest.raises(ValueError) as ref:
        jax_create_model("tiny-test", force_image_size=40)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("variational", [False, True])
def test_int8_forward_is_refused_naming_its_roadmap_item(variational):
    """Refused until ROADMAP Queue 1 item 4 was ported; now ``int8_forward`` builds both
    model kinds with every dense MLP on the int8 GEMMs, as the reference's factory does."""
    model = create_model("tiny-test", int8_forward=True, variational=variational, device="cpu")
    mlps = [m for m in model.modules() if isinstance(m, MLP)]
    assert model.cfg.int8_forward and len(mlps) == 4 and all(m.int8_fwd for m in mlps)


@pytest.mark.parametrize("old,new", [(7, 12), (12, 7), (2, 3), (3, 2)])
def test_resize_pos_embed_matches_jax(old, new):
    """Up (ViT-B/32 224 -> 384 px: 7 -> 12) and down (12 -> 7, the antialiased kernel)."""
    pos = np.random.default_rng(old * 10 + new).standard_normal(
        (old * old + 1, 8)).astype(np.float32)
    got = resize_pos_embed(pos, new * new + 1)
    want = np.asarray(jax_resize_pos_embed(pos, new * new + 1))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got[0], pos[0])
    assert resize_pos_embed(pos, old * old + 1) is pos
    with pytest.raises(ValueError, match="cannot resize"):
        resize_pos_embed(pos, new * new + 2)


def test_openai_load_into_a_forced_size_resizes_like_jax():
    """A 32 px checkpoint into the 48 px model: the port's load equals JAX's
    ``convert_torch_state_dict`` at 48 px, every leaf."""
    jm = jax_create_model("tiny-test")
    sd = export_torch_state_dict(random_params(jm), jm.cfg)
    cfg48 = jax_create_model("tiny-test", force_image_size=48).cfg
    want = jax_params_to_port(jax.device_get(convert_torch_state_dict(sd, cfg48)))
    pm = load_openai_state_dict(create_model("tiny-test", force_image_size=48, device="cpu"), sd)
    for n, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-6, rtol=1e-6, err_msg=n)
