"""On the card (``-m cuda``; imports no JAX): the windowed ``Embedder._batched`` (chunks
encoded ahead of the host fetch, copied into pinned buffers) equals a chunk-by-chunk loop of
synchronous encodes bit for bit, from numpy and from a batch already on the card, with a
ragged tail; and ``normalize=False`` rows are the normalized rows times their norms."""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.inference import Embedder
from multimodal_tpu_torch.models import add_model_config, create_model

NAME = "tiny-embedder-cuda"
add_model_config(NAME, {
    "embed_dim": 16,
    "vision_cfg": {"image_size": 32, "patch_size": 16, "width": 64, "layers": 1, "heads": 2},
    "text_cfg": {"context_length": 16, "vocab_size": 49408, "width": 64, "layers": 1,
                 "heads": 2},
})


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return create_model(NAME, seed=0)


def _chunk_loop(emb, array):
    outs = []
    for start in range(0, len(array), emb.batch_size):
        chunk = array[start : start + emb.batch_size]
        n = len(chunk)
        if n < emb.batch_size:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], emb.batch_size - n, axis=0)])
        outs.append(emb.encode_images(chunk)[:n])
    return np.concatenate(outs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 24, 32, 56, 61])  # 1, 3, 4 and 7 chunks; a ragged tail
def test_windowed_batches_on_the_card_equal_the_chunk_loop(model, n):
    emb = Embedder(model, batch_size=8)
    imgs = np.random.default_rng(n).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    want = _chunk_loop(emb, imgs)
    np.testing.assert_array_equal(emb.embed_images(imgs), want)
    np.testing.assert_array_equal(emb.embed_images(torch.from_numpy(imgs).cuda()), want)


@pytest.mark.cuda
def test_unnormalized_rows_on_the_card(model):
    imgs = np.random.default_rng(0).integers(0, 256, (10, 32, 32, 3), dtype=np.uint8)
    unit = Embedder(model, batch_size=8).embed_images(imgs)
    raw = Embedder(model, batch_size=8, normalize=False).embed_images(imgs)
    norms = np.linalg.norm(raw, axis=-1, keepdims=True)
    assert not np.allclose(norms, 1.0, atol=1e-3)
    np.testing.assert_allclose(raw / norms, unit, atol=1e-6)
