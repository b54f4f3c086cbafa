"""The port's Llama captioner adapter (``multimodal_tpu_torch/models/llama_captioner.py``)
against the JAX package's, on the CPU, over a tiny random local LlamaForCausalLM snapshot (no
hub access): with JAX's projection carried across, the same soft prefix (atol 1e-6) and the
same greedy captions; the adapter's own seeded projection deterministic; a missing
``transformers`` named by the ``ImportError``."""

import sys

import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from multimodal_tpu.models.llama_captioner import LlamaCaptioner as JaxLlamaCaptioner  # noqa: E402
from multimodal_tpu_torch.models.llama_captioner import LlamaCaptioner  # noqa: E402

CLIP_DIM = 32
HIDDEN = 32
VOCAB = 256


@pytest.fixture(scope="module")
def llama_snapshot(tmp_path_factory):
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Whitespace
    from transformers import LlamaConfig, LlamaForCausalLM, PreTrainedTokenizerFast

    path = tmp_path_factory.mktemp("llama_tiny_torch")
    torch.manual_seed(0)
    cfg = LlamaConfig(vocab_size=VOCAB, hidden_size=HIDDEN, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=128, bos_token_id=1, eos_token_id=2)
    LlamaForCausalLM(cfg).save_pretrained(path)
    words = ["<unk>", "<s>", "</s>", "A", "photo", "of", "a", "the", "cat", "dog", "red",
             "blue", "circle", "square", "on", "and", "small", "large"]
    tok = Tokenizer(WordLevel({w: i for i, w in enumerate(words)}, unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
                            eos_token="</s>").save_pretrained(path)
    return str(path)


def test_captions_equal_jax_with_its_projection(llama_snapshot):
    embeds = (np.random.default_rng(0).standard_normal((3, CLIP_DIM)) * 4).astype(np.float32)
    ref = JaxLlamaCaptioner(llama_snapshot, clip_dim=CLIP_DIM, max_new_tokens=8)
    cap = LlamaCaptioner(llama_snapshot, clip_dim=CLIP_DIM, max_new_tokens=8, device="cpu")
    cap.projection = torch.from_numpy(np.array(ref.projection))
    np.testing.assert_allclose(cap.project(embeds).numpy(), ref.project(embeds), atol=1e-6)
    for prompt in ("A photo of", "the"):
        assert cap.generate_caption(embeds, prompt=prompt) == ref.generate_caption(
            embeds, prompt=prompt)


def test_own_projection_is_seeded(llama_snapshot):
    a = LlamaCaptioner(llama_snapshot, clip_dim=CLIP_DIM, seed=3, max_new_tokens=6,
                       device="cpu")
    b = LlamaCaptioner(llama_snapshot, clip_dim=CLIP_DIM, seed=3, max_new_tokens=6,
                       device="cpu")
    assert torch.equal(a.projection, b.projection)
    assert a.projection.shape == (CLIP_DIM, HIDDEN)
    assert abs(float(a.projection.std()) - CLIP_DIM ** -0.5) < 0.05
    embeds = np.random.default_rng(1).standard_normal((2, CLIP_DIM)).astype(np.float32)
    assert a.project(embeds).shape == (2, 1, HIDDEN)
    assert a.generate_caption(embeds) == b.generate_caption(embeds)


def test_missing_transformers_is_named(llama_snapshot, monkeypatch):
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        LlamaCaptioner(llama_snapshot, device="cpu")


def test_lands_on_the_card_or_raises(llama_snapshot):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LlamaCaptioner(llama_snapshot, clip_dim=CLIP_DIM)
