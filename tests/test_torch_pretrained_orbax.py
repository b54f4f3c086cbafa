"""``--pretrained`` from an Orbax directory: the fixture is written with the JAX package's
``orbax.checkpoint.StandardCheckpointer`` into ``tmp_path`` (seeded numpy parameters); the
port reads it with ``tensorstore`` alone and maps it with ``jax_params_to_port``. Held to the
JAX package's ``load_pretrained`` of the same directory: image and text features at atol
2e-4 (``tests/test_torch_serving.py``'s float32 CPU tolerance), the LoRA probe (a fine-tune's
save restores its adapters, a base save keeps the fresh ones and says so), the
``force_image_size`` resize of the positional table, a shape mismatch raising, and a missing
``tensorstore`` raising an ``ImportError`` that names it."""

import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import init_params
from multimodal_tpu.models.checkpoint_interop import load_pretrained as jax_load_pretrained
from multimodal_tpu.models.config import get_model_config
from multimodal_tpu_torch.models import (
    add_model_config,
    create_model,
    load_pretrained,
    read_orbax_params,
)
from multimodal_tpu_torch.models.lora import is_lora_leaf
from torch_jax_models import random_params

torch.set_num_threads(1)

NAME = "tiny-orbax-torch"
CFG = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 2, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 512, "width": 64, "layers": 2,
                 "heads": 2},
}
add_model_config(NAME, CFG)
jax_add_model_config(NAME, CFG)
LORA = dict(lora_rank=4, lora_alpha=8.0)


def _save(path, params):
    import orbax.checkpoint as ocp

    ckptr = ocp.StandardCheckpointer()
    ckptr.save(str(path), jax.tree_util.tree_map(jnp.asarray, params))
    ckptr.wait_until_finished()
    return str(path)


@pytest.fixture(scope="module")
def saves(tmp_path_factory):
    root = tmp_path_factory.mktemp("orbax")
    base = random_params(jax_create_model(NAME), seed=1)
    tuned = random_params(jax_create_model(NAME, **LORA), seed=2)
    wide = dict(CFG, vision_cfg=dict(CFG["vision_cfg"], width=128))
    jax_add_model_config(NAME + "-wide", wide)
    return {"base": _save(root / "base", base), "lora": _save(root / "lora", tuned),
            "wide": _save(root / "wide", random_params(jax_create_model(NAME + "-wide")))}


def _inputs(image_size=32):
    rng = np.random.default_rng(0)
    images = rng.standard_normal((3, image_size, image_size, 3)).astype(np.float32)
    tokens = rng.integers(1, 511, (3, 16))
    tokens[:, 7] = 511  # one EOT (the largest id) per row
    return images, tokens


def _features_match(pm, jm, params, image_size=32):
    images, tokens = _inputs(image_size)
    want_i = np.asarray(jm.apply(params, jnp.asarray(images), method=jm.encode_image))
    want_t = np.asarray(jm.apply(params, jnp.asarray(tokens), method=jm.encode_text))
    with torch.no_grad():
        got_i = pm.eval().encode_image(torch.from_numpy(images)).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got_i, want_i, atol=2e-4)
    np.testing.assert_allclose(got_t, want_t, atol=2e-4)


def _jax_load(path, **kw):
    jm = jax_create_model(NAME, **kw)
    params = jax_load_pretrained(path, init_params(jm, jax.random.PRNGKey(0)),
                                 get_model_config(NAME))
    return jm, params


def test_reader_returns_the_saved_tree(saves):
    tree = read_orbax_params(saves["base"])
    want = random_params(jax_create_model(NAME), seed=1)
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(flat_want) == len(jax.tree_util.tree_leaves(tree))
    for path, leaf in flat_want:
        node = tree
        for k in path:
            node = node[k.key]
        np.testing.assert_array_equal(node, leaf)


def test_features_match_jax_load_pretrained(saves):
    pm = load_pretrained(create_model(NAME, device="cpu", seed=3), saves["base"])
    _features_match(pm, *_jax_load(saves["base"]))


def test_lora_checkpoint_restores_its_adapters(saves):
    pm = load_pretrained(create_model(NAME, device="cpu", seed=3, **LORA), saves["lora"])
    jm, params = _jax_load(saves["lora"], **LORA)
    tree = read_orbax_params(saves["lora"])
    b = tree["params"]["visual_transformer"]["resblock_0"]["attn"]["query"]["lora_b"]
    got = dict(pm.named_parameters())["visual_transformer.resblocks.0.attn.query.lora_b"]
    np.testing.assert_array_equal(got.detach().numpy(), b)
    _features_match(pm, jm, params)


def test_base_checkpoint_keeps_fresh_adapters_and_says_so(saves, caplog):
    pm = create_model(NAME, device="cpu", seed=3, **LORA)
    fresh = {n: p.detach().clone() for n, p in pm.named_parameters() if is_lora_leaf(n)}
    assert fresh
    with caplog.at_level(logging.INFO):
        load_pretrained(pm, saves["base"])
    assert "no LoRA adapter leaves" in caplog.text
    for n, p in pm.named_parameters():
        if is_lora_leaf(n):
            assert torch.equal(p, fresh[n]), n
    base = load_pretrained(create_model(NAME, device="cpu"), saves["base"])
    for n, p in base.named_parameters():
        assert torch.equal(dict(pm.named_parameters())[n], p), n


def test_force_image_size_resizes_the_positional_table(saves):
    """The reference resizes after Orbax restores the checkpoint's shapes; the installed Orbax
    refuses a template of another shape first, so the JAX side here restores at the saved
    size and applies its own ``resize_pos_embed``, the step its loader means to take."""
    from multimodal_tpu.models.checkpoint_interop import resize_pos_embed

    pm = load_pretrained(create_model(NAME, device="cpu", force_image_size=48), saves["base"])
    assert pm.visual_stem.positional_embedding.shape[0] == 10
    _, params = _jax_load(saves["base"])
    stem = dict(params["params"]["visual_stem"])
    stem["positional_embedding"] = resize_pos_embed(
        np.asarray(stem["positional_embedding"], np.float32), 10)
    params = {"params": dict(params["params"], visual_stem=stem)}
    _features_match(pm, jax_create_model(NAME, force_image_size=48), params, image_size=48)


def test_shape_mismatch_raises(saves):
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pretrained(create_model(NAME, device="cpu"), saves["wide"])
    with pytest.raises(ValueError, match="does not cover"):  # adapters it does not have
        load_pretrained(create_model(NAME, device="cpu"), saves["lora"])


def test_missing_tensorstore_raises_naming_it(saves, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore"):
        load_pretrained(create_model(NAME, device="cpu"), saves["base"])
