"""The port's tokenizer, with ``regex`` and with the exact stdlib classes, against the JAX
package's Python BPE path (``tokenize(..., use_native=False)``)."""

import functools

import numpy as np
import pytest

from multimodal_tpu.data.tokenizer import tokenize as jax_tokenize
from multimodal_tpu_torch.data.tokenizer import SimpleTokenizer, tokenize

CAPTIONS = [
    "a photo of a cat",  # ASCII
    "Two dogs, playing in the park!! (2024) it's don't we'll",
    "CAFÉ au lait à la crème, naïve façade — jalapeño",  # Latin-1
    "CafÃ© con leche",  # cp1252 mojibake, repaired before the split
    "東京タワーの夜景 and 한국어 문장",  # CJK
    "pizza 🍕 time 😀👍🏽 ✨",  # emoji
    "x²½ Ⅻ ٣ ⅻ ¼ ① ⁵",  # No / Nl / Nd numbers
    "tab\tnew\nline\x1cunit nbsp",  # whitespace edges (U+001C is not \s)
    "&amp;lt;b&amp;gt; html &quot;quoted&quot;",
    "",
]


@functools.lru_cache(maxsize=None)
def _tokenizer(use_regex: bool) -> SimpleTokenizer:
    return SimpleTokenizer(use_regex=use_regex)


@pytest.mark.parametrize("use_regex", [True, False])
def test_matches_jax_python_bpe(use_regex):
    got = tokenize(CAPTIONS, tokenizer=_tokenizer(use_regex))
    want = jax_tokenize(CAPTIONS, use_native=False)
    assert got.dtype == np.int32 and got.shape == (len(CAPTIONS), 77)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("use_regex", [True, False])
def test_truncation_keeps_eot(use_regex):
    long = " ".join(f"word{i} ²" for i in range(100))
    for ctx in (77, 16):
        got = tokenize([long, "short"], context_length=ctx, tokenizer=_tokenizer(use_regex))
        want = jax_tokenize([long, "short"], context_length=ctx, use_native=False)
        np.testing.assert_array_equal(got, want)
        assert got[0, -1] == _tokenizer(use_regex).eot_token_id


def test_stdlib_classes_are_exact_where_the_shortcut_is_not():
    import re

    words = _tokenizer(False)._token_re.findall("x²½ Ⅻ")
    assert words == ["x", "²", "½", "Ⅻ"]
    assert re.findall(r"[^\W\d_]+", "x²½") == ["x²½"]  # the inexact shortcut


def test_decode_round_trip():
    tok = _tokenizer(False)
    ids = tok.encode("a photo of a cat")
    assert tok.decode(ids).strip() == "a photo of a cat"
