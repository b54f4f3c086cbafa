"""The long-context causal text path of the PyTorch port as a whole: a tiny two-tower model
whose text ``context_length`` (384) is above the block operator's longest sequence, so that
every text block projects q, k, v with plain products and calls ``attention()``, routed here
through ``FlashAttention`` (its plain versions: two 256-key tiles), against the JAX model with
the same weights; and the serving path (``Embedder``, ``EmbeddingService``) at that length.

On a CUDA tensor ``attention()`` takes the flash kernels by itself from 2048 tokens up; on the
CPU ``auto`` is the plain path, so the test pins ``impl="flash"`` for the causal calls. The JAX
side runs its plain attention path, as it does on any backend but the TPU.

Tolerances, float32 on the CPU: features atol = rtol = 1e-4; one train step's loss and grad
norm rtol 1e-5, every gradient leaf atol 1e-4 x max(1, max|leaf|) and rtol 1e-3, parameters
after the step atol 2e-5, rtol 1e-5 (those of tests/test_torch_train_step.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import init_params
from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
from multimodal_tpu_torch.inference import Embedder
from multimodal_tpu_torch.models import (
    add_model_config,
    create_model,
    layers,
    load_jax_params,
    load_openai_state_dict,
)
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.ops import flash_attention as fl
from multimodal_tpu_torch.ops.attention import attention
from multimodal_tpu_torch.ops.block_attention import MAX_BLOCK_SEQ
from multimodal_tpu_torch.serving import EmbeddingService
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step

torch.set_num_threads(1)

NAME = "tiny-long-context"
CTX = 384
OPT = dict(weight_decay=0.1, grad_clip_norm=1.0)
B = 4
CONFIG = {
    "embed_dim": 32,
    "vision_cfg": {"image_size": 32, "patch_size": 8, "width": 64, "layers": 2, "heads": 2},
    "text_cfg": {"context_length": CTX, "vocab_size": 49408, "width": 64, "layers": 2,
                 "heads": 2},
}
add_model_config(NAME, CONFIG)
jax_add_model_config(NAME, CONFIG)


def _random_params(jm, seed=0):
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))

    def leaf(path, s):
        name = "/".join(k.key for k in path)
        n = rng.standard_normal(s.shape, dtype=np.float32)
        if not s.shape:
            return np.float32(2.6592)
        if len(s.shape) == 1:
            return 1 + 0.1 * n if name.endswith("LayerNorm_0/scale") else 0.02 * n
        return n * np.float32(np.prod(s.shape[:-1]) ** -0.5)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@functools.lru_cache(maxsize=None)
def _jax_model():
    jm = jax_create_model(NAME)
    return jm, _random_params(jm)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.vision.image_size
    images = rng.integers(0, 256, (B, s, s, 3), dtype=np.uint8)
    tokens = rng.integers(1, cfg.text.vocab_size - 1, (B, cfg.text.context_length))
    # the EOT (the largest id) late in the sequence, past the first 256-key tile
    tokens[np.arange(B), rng.integers(300, cfg.text.context_length, B)] = cfg.text.vocab_size - 1
    return images, tokens.astype(np.int32)


@pytest.fixture
def through_flash(monkeypatch):
    """Route every causal ``attention()`` call of the blocks to the flash operator and record
    the shapes it saw."""
    seen = []

    def routed(q, k, v, *, causal=False, **kw):
        if causal:
            seen.append(tuple(q.shape))
            kw["impl"] = "flash"
        return attention(q, k, v, causal=causal, **kw)

    monkeypatch.setattr(layers, "attention", routed)
    return seen


def test_long_text_tower_leaves_the_block_operator():
    assert CTX > MAX_BLOCK_SEQ and not layers.block_attn_supported(B, CTX, 64, 2)
    assert layers.block_attn_supported(B, 17, 64, 2) == layers.block_attn_supported(B, 16, 64, 2)
    model = create_model(NAME, device="cpu")
    assert model.text_stem.positional_embedding.shape == (CTX, 64)
    assert all(blk.attn.causal for blk in model.text_transformer.resblocks)


def test_features_match_jax(through_flash):
    jm, params = _jax_model()
    pm = load_jax_params(create_model(NAME, device="cpu"), params)
    images, tokens = _batch(jm.cfg, seed=1)
    images = ((images.astype(np.float32) / 255.0) - 0.5) / 0.25
    enc = lambda method: jax.jit(functools.partial(jm.apply, method=method))  # noqa: E731
    want_i = np.asarray(enc(jm.encode_image)(params, jnp.asarray(images)))
    want_t = np.asarray(enc(jm.encode_text)(params, jnp.asarray(tokens)))
    with torch.inference_mode():
        got_i = pm.encode_image(torch.from_numpy(images)).numpy()
        got_t = pm.encode_text(torch.from_numpy(tokens).long()).numpy()
    np.testing.assert_allclose(got_i, want_i, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got_t, want_t, atol=1e-4, rtol=1e-4)
    assert through_flash == [(B, CTX, 2, 32)] * 2  # every text block, no vision block


def test_openai_format_weights_give_the_same_text_features(through_flash):
    jm, params = _jax_model()
    a = load_jax_params(create_model(NAME, device="cpu"), params)
    b = load_openai_state_dict(create_model(NAME, device="cpu"),
                               export_torch_state_dict(params, jm.cfg))
    tokens = torch.from_numpy(_batch(jm.cfg)[1]).long()
    with torch.inference_mode():
        assert torch.equal(a.encode_text(tokens), b.encode_text(tokens))


@functools.lru_cache(maxsize=None)
def _jax_step():
    from multimodal_tpu.train import TrainState as JaxState
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import make_train_step as jax_train_step
    from multimodal_tpu.train.engine import make_loss_fn

    jm, params = _jax_model()
    params = jax.tree_util.tree_map(jnp.asarray, params)
    images, tokens = _batch(jm.cfg)
    batch = {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}
    rng = jax.random.PRNGKey(0)
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    loss_fn = make_loss_fn(jm, "clip")
    grads = jax.jit(jax.grad(lambda p: loss_fn(p, batch, rng)[0]))(params)
    state, m = jax_train_step(jm, tx, loss_type="clip", donate=False)(
        JaxState.create(params, tx), batch, rng)
    metrics = {k: float(m[k]) for k in ("loss", "logit_scale", "grad_norm")}
    return metrics, jax_params_to_port(grads), jax_params_to_port(state.params)


@pytest.fixture
def port_step(through_flash):
    model = load_jax_params(create_model(NAME, device="cpu"), _jax_model()[1])
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    images, tokens = _batch(model.cfg)
    fl.launches.reset_launch_counts()
    m = make_train_step(model, opt)(TrainState.create(model, opt), {
        "image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()})
    grads = {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()}
    return model, {k: float(v) for k, v in m.items()}, grads, list(through_flash)


def test_train_step_loss_and_grad_norm_match_jax(port_step):
    want, _, _ = _jax_step()
    _, got, _, seen = port_step
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=1e-5)
    np.testing.assert_allclose(got["logit_scale"], want["logit_scale"], rtol=1e-6)
    assert seen == [(B, CTX, 2, 32)] * 2
    assert not any(fl.launches.launch_counts().values())  # plain versions: nothing launched


def test_train_step_every_grad_leaf_matches_jax(port_step):
    _, want, _ = _jax_step()
    _, _, got, _ = port_step
    assert set(want) == set(got)
    for n, w in want.items():
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(got[n], w, atol=1e-4 * scale, rtol=1e-3, err_msg=n)
    assert np.abs(got["text_stem.positional_embedding"][300:]).max() > 0


def test_train_step_updated_params_match_jax(port_step):
    _, _, want = _jax_step()
    model = port_step[0]
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=2e-5, rtol=1e-5, err_msg=n)


def test_serving_path_tokenizes_to_the_models_context_length(through_flash):
    """``Embedder`` and ``EmbeddingService`` read the context length from the model's config:
    a caption becomes [1, 384] tokens (padded to the bucket), the EOT row is pooled, and the
    service's answer is the embedder's."""
    model = load_jax_params(create_model(NAME, device="cpu"), _jax_model()[1])
    texts = ["a photo of a cat", "two dogs " * 200]  # the second is cut at 384 tokens
    emb = Embedder(model, batch_size=2)
    got = emb.embed_texts(texts)
    assert got.shape == (2, 32) and np.allclose(np.linalg.norm(got, axis=-1), 1, atol=1e-5)
    assert through_flash == [(2, CTX, 2, 32)] * 2
    svc = EmbeddingService(model, max_batch=2, max_wait_ms=1.0)
    try:
        np.testing.assert_allclose(svc.embed_texts(texts), got, atol=1e-6)
    finally:
        svc.close()
    from multimodal_tpu_torch.data.tokenizer import tokenize
    tokens = tokenize(texts, CTX)
    assert tokens.shape == (2, CTX) and tokens[1].argmax() == CTX - 1 and tokens[0, 7:].max() == 0
