"""The rest of the port's ``Embedder`` API against the JAX ``Embedder`` on the same seeded
weights (carried across by ``load_jax_params``; float32 on the CPU, atol 2e-4 as
``tests/test_torch_serving.py``): ``normalize=False``, ``embed_tokens`` and
``embed_texts(context_length=)``; and the bounded in-flight window of ``_batched``, whose
output equals a chunk-by-chunk loop of single encodes bit for bit."""

import numpy as np
import pytest
import torch

from multimodal_tpu.inference import Embedder as JaxEmbedder
from multimodal_tpu.models import add_model_config as jax_add_model_config
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu_torch.data.tokenizer import tokenize
from multimodal_tpu_torch.inference import Embedder
from multimodal_tpu_torch.models import add_model_config, create_model, load_jax_params
from torch_jax_models import random_params

torch.set_num_threads(1)

NAME = "tiny-embedder-api"
CFG = {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 1, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "layers": 1,
                 "heads": 2},
}
add_model_config(NAME, CFG)
jax_add_model_config(NAME, CFG)
TEXTS = ["a cat", "a dog on a mat", "two birds", "a red car", "snow"]


@pytest.fixture(scope="module")
def models():
    jm = jax_create_model(NAME)
    params = random_params(jm, seed=4)
    pm = load_jax_params(create_model(NAME, device="cpu"), params)
    return pm, jm, params


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)


@pytest.mark.parametrize("normalize", [False, True])
def test_normalize_matches_jax(models, normalize):
    pm, jm, params = models
    ours = Embedder(pm, batch_size=4, normalize=normalize)
    theirs = JaxEmbedder(jm, params, batch_size=4, normalize=normalize)
    imgs = _images(6)
    got_i, got_t = ours.embed_images(imgs), ours.embed_texts(TEXTS)
    np.testing.assert_allclose(got_i, theirs.embed_images(imgs), atol=2e-4)
    np.testing.assert_allclose(got_t, theirs.embed_texts(TEXTS), atol=2e-4)
    norms = np.linalg.norm(np.concatenate([got_i, got_t]), axis=-1)
    assert np.allclose(norms, 1.0, atol=1e-5) == normalize


def test_embed_tokens_and_context_length_match_jax(models):
    pm, jm, params = models
    ours, theirs = Embedder(pm, batch_size=4), JaxEmbedder(jm, params, batch_size=4)
    ctx = CFG["text_cfg"]["context_length"]
    tokens = tokenize(TEXTS, ctx)
    got = ours.embed_tokens(tokens)
    np.testing.assert_allclose(got, theirs.embed_tokens(tokens), atol=2e-4)
    np.testing.assert_array_equal(got, ours.embed_texts(TEXTS))
    np.testing.assert_array_equal(ours.embed_texts(TEXTS, context_length=ctx), got)
    np.testing.assert_allclose(ours.embed_texts(TEXTS, context_length=ctx),
                               theirs.embed_texts(TEXTS, context_length=ctx), atol=2e-4)
    np.testing.assert_array_equal(ours.embed_tokens(torch.from_numpy(tokens)), got)


def _chunk_loop(emb: Embedder, encode, array):
    """The synchronous form: one encode per padded chunk, fetched before the next."""
    outs = []
    for start in range(0, len(array), emb.batch_size):
        chunk = array[start : start + emb.batch_size]
        n = len(chunk)
        if n < emb.batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], emb.batch_size - n, axis=0)])
        outs.append(encode(chunk)[:n])
    return np.concatenate(outs)


@pytest.mark.parametrize("n", [4, 12, 16, 28, 27, 1])  # 1, 3, 4 and 7 chunks; ragged tails
def test_windowed_batches_equal_the_chunk_loop_bit_for_bit(models, n):
    pm, _, _ = models
    emb = Embedder(pm, batch_size=4)
    imgs = _images(n, seed=n)
    np.testing.assert_array_equal(emb.embed_images(imgs),
                                  _chunk_loop(emb, emb.encode_images, imgs))
    tokens = tokenize([f"caption number {i}" for i in range(n)], 16)
    np.testing.assert_array_equal(emb.embed_tokens(tokens),
                                  _chunk_loop(emb, emb.encode_tokens, tokens))


def test_window_bounds_the_chunks_in_flight(models, monkeypatch):
    """At most WINDOW + 1 chunks are encoded before the first host fetch, as the reference's
    ``len(in_flight) > 3`` drain."""
    pm, _, _ = models
    emb = Embedder(pm, batch_size=2)
    encoded, fetched_at = [], []
    real = emb._image_features

    def spy(chunk):
        encoded.append(len(chunk))
        return real(chunk)

    orig_numpy = torch.Tensor.numpy

    def numpy_spy(t, *a, **kw):
        fetched_at.append(len(encoded))
        return orig_numpy(t, *a, **kw)

    monkeypatch.setattr(torch.Tensor, "numpy", numpy_spy)
    emb._batched(spy, _images(14))
    assert len(encoded) == 7
    assert fetched_at[:4] == [Embedder.WINDOW + 1, 5, 6, 7]
