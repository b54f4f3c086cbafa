"""The port's native BPE tokenizer (``multimodal_tpu_torch/native/bpe_tokenizer.cc`` through
``native/bindings.bpe_encode_batch`` and ``data/tokenizer.tokenize``) against the JAX package's
native tokenizer and against the port's Python tokenizer, on the CPU.

Tolerance: none. Over a seeded ASCII corpus (contractions, digit runs, punctuation runs,
repeated whitespace, empty strings, the special literals, captions longer than the context)
the ids are equal bit for bit at context lengths 77 and 32, from one thread and from many. A
batch with a non-ASCII character or an HTML entity is not the native tokenizer's: it takes the
Python path and still equals JAX's ``tokenize``."""

import os
import sys
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from multimodal_tpu.data.tokenizer import tokenize as jax_tokenize
from multimodal_tpu.native import bindings as jax_bindings
from multimodal_tpu_torch.data.tokenizer import default_tokenizer, tokenize
from multimodal_tpu_torch.native import bindings
from multimodal_tpu_torch.paths import BPE_VOCAB_PATH

WORDS = ["a", "photo", "of", "the", "cat", "dogs", "playing", "in", "snow", "red", "car",
         "bridge", "New", "YORK", "McDonald", "hello", "world", "zebra", "xylophone",
         "antidisestablishmentarianism", "qwzx", "e-mail", "co-op", "rock'n'roll", "naïve"]
CONTRACTIONS = ["it's", "don't", "they're", "we've", "I'm", "we'll", "he'd", "IT'S", "o'clock",
                "'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'", "''", "'x", "rock'"]
PUNCT = ["!", "!!!", "...", "?!", ",", ";:", "--", "(", ")", "[]", "{}", "<>", "@#$%", "*^",
         "_", "__init__", "~/", "\\", "/", "|", "\"", "`", "'''", "-'s", "+=", "<|"]
SPACES = [" ", "  ", "\t", "\n", " \t\n ", "\r\n", "\x0b", "\x0c", "   "]
SPECIALS = ["<|startoftext|>", "<|endoftext|>", "x<|endoftext|>y", "!<|endoftext|>"]


def _digits(rng) -> str:
    return "".join(str(d) for d in rng.integers(0, 10, rng.integers(1, 12)))


def _caption(rng, n_words: int) -> str:
    """ASCII pieces joined by whitespace runs, sometimes glued with no space between."""
    pieces = []
    for _ in range(n_words):
        kind = rng.integers(0, 10)
        if kind < 5:
            w = str(rng.choice(WORDS[:-1]))  # the last word is not ASCII
        elif kind == 5:
            w = str(rng.choice(CONTRACTIONS))
        elif kind == 6:
            w = _digits(rng)
        elif kind == 7:
            w = str(rng.choice(PUNCT))
        elif kind == 8:
            w = str(rng.choice(WORDS[:-1])) + str(rng.choice(PUNCT + CONTRACTIONS)) + _digits(rng)
        else:
            w = str(rng.choice(SPECIALS)) if rng.random() < 0.2 else str(rng.choice(WORDS[:-1]))
        pieces.append(w)
        pieces.append(str(rng.choice(SPACES)) if rng.random() < 0.85 else "")
    return "".join(pieces)


def corpus(seed: int, n: int = 400) -> list[str]:
    """Seeded captions of 0-120 pieces (so some run past 77 tokens), plus fixed edge cases."""
    rng = np.random.default_rng(seed)
    texts = [_caption(rng, int(k)) for k in rng.integers(0, 40, n - 60)]
    texts += [_caption(rng, int(k)) for k in rng.integers(60, 121, 40)]
    texts += ["", " ", "\t\n", "A", "1", "12345678901234567890", "!!!!!!!!", "it's", "'s'",
              "don't stop", "Two   dogs\tplaying\n\nin the SNOW.", "a" * 200, "ab " * 100,
              "<|startoftext|>", "<|endoftext|>", "1.5 x 10^3 = 1500!", "e.g. U.S.A.",
              "'ll've'd", "x'sy", "#hashtag @user http://example.com/a_b?c=d"]
    return texts


def _jax_native(texts: list[str], context_length: int) -> np.ndarray:
    from multimodal_tpu.data.tokenizer import DEFAULT_BPE_PATH

    out = jax_bindings.bpe_encode_batch(texts, DEFAULT_BPE_PATH, context_length)
    assert out is not None, "the JAX package's native tokenizer did not take an ASCII batch"
    return out


def _python(texts: list[str], context_length: int) -> np.ndarray:
    return tokenize(texts, context_length, use_native=False)


@pytest.mark.parametrize("context_length", [77, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_native_equals_jax_native_and_python(seed, context_length):
    texts = corpus(seed)
    got = bindings.bpe_encode_batch(texts, BPE_VOCAB_PATH, context_length)
    assert got is not None and got.dtype == np.int32
    assert got.shape == (len(texts), context_length)
    np.testing.assert_array_equal(got, _jax_native(texts, context_length))
    np.testing.assert_array_equal(got, _python(texts, context_length))
    np.testing.assert_array_equal(tokenize(texts, context_length), got)
    # the corpus reaches what it is meant to: truncated rows (EOT in the last slot, no zero)
    # and empty captions (SOT, EOT)
    eot, sot = default_tokenizer().eot_token_id, default_tokenizer().sot_token_id
    full = (got != 0).all(1)
    assert full.sum() >= 10 and (got[full, -1] == eot).all()
    assert (got[texts.index("")][:3] == [sot, eot, 0]).all()


@pytest.mark.parametrize("context_length", [1, 2, 5])
def test_short_contexts_keep_eot_last(context_length):
    texts = corpus(3, n=100)
    got = bindings.bpe_encode_batch(texts, BPE_VOCAB_PATH, context_length)
    np.testing.assert_array_equal(got, _jax_native(texts, context_length))
    np.testing.assert_array_equal(got, _python(texts, context_length))


def test_words_and_contractions_split_as_the_pattern():
    """Single captions whose words lean on each alternative of the pattern, one at a time."""
    texts = CONTRACTIONS + PUNCT + SPECIALS + WORDS[:-1] + ["".join(SPACES) + "x"]
    for text in texts:
        got = bindings.bpe_encode_batch([text], BPE_VOCAB_PATH, 77)
        np.testing.assert_array_equal(got, _python([text], 77), err_msg=repr(text))
        np.testing.assert_array_equal(got, _jax_native([text], 77), err_msg=repr(text))


def test_many_threads_give_the_same_ids():
    """Reader threads tokenize at once: 16 threads over 64 batches share one handle and its
    word cache, and every batch equals the single-threaded Python ids."""
    texts = corpus(4, n=640)
    batches = [texts[i::64] for i in range(64)]
    want = [_python(b, 77) for b in batches]
    with ThreadPoolExecutor(max_workers=16) as pool:
        got = list(pool.map(lambda b: tokenize(b, 77), batches))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_handle_is_made_once_under_concurrency(monkeypatch):
    """Threads (more than the cores, switching every microsecond) that ask for the tokenizer at
    the same moment get one handle, made once."""
    monkeypatch.setattr(bindings, "_bpe_handles", {})
    made = []
    lib = bindings.load("host")
    real = lib.mm_bpe_create

    class Counting:
        def __call__(self, *a):
            made.append(1)
            return real(*a)

    monkeypatch.setattr(lib, "mm_bpe_create", Counting())
    barrier = threading.Barrier(16, timeout=60)

    def ask(_):
        barrier.wait()
        return bindings._bpe(BPE_VOCAB_PATH)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as pool:
            handles = set(pool.map(ask, range(16), timeout=120))
    finally:
        sys.setswitchinterval(interval)
    assert len(handles) == 1 and len(made) == 1


@pytest.mark.parametrize("text", ["café au lait", "naïve", "a &amp; b", "R&D", "tom &lt;3",
                                  "日本語のキャプション", " non-breaking"])
def test_non_ascii_and_entities_take_the_python_path(text):
    """Such a batch is the Python tokenizer's (normalization, unescaping): the native call
    declines it, and ``tokenize`` gives JAX's ids."""
    batch = ["a photo of a cat", text]
    assert bindings.bpe_encode_batch(batch, BPE_VOCAB_PATH, 77) is None
    np.testing.assert_array_equal(tokenize(batch), jax_tokenize(batch))
    np.testing.assert_array_equal(tokenize(batch), _python(batch, 77))


def test_control_bytes_take_the_python_path():
    """An ASCII byte outside printable ASCII and whitespace (the Python path's text fixing may
    drop it) is not the native tokenizer's either."""
    batch = ["ok", "bell\x07here", "del\x7f"]
    assert bindings.bpe_encode_batch(batch, BPE_VOCAB_PATH, 77) is None
    np.testing.assert_array_equal(tokenize(batch), jax_tokenize(batch))


def test_custom_tokenizer_or_use_native_false_skip_the_library(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the native tokenizer was called")

    monkeypatch.setattr(bindings, "bpe_encode_batch", refuse)
    texts = corpus(5, n=80)
    np.testing.assert_array_equal(tokenize(texts, use_native=False), jax_tokenize(texts))
    np.testing.assert_array_equal(tokenize(texts, tokenizer=default_tokenizer()),
                                  jax_tokenize(texts))


def test_library_needs_no_zlib_and_rejects_a_foreign_vocabulary(tmp_path):
    """The host library's sources include no zlib and link nothing; the vocabulary is read
    by Python. A file that is not the CLIP merge list raises instead of tokenizing."""
    sources, link = bindings.LIBRARIES["host"]
    assert "bpe_tokenizer.cc" in sources and link == ()
    with open(os.path.join(os.path.dirname(bindings.__file__), "bpe_tokenizer.cc")) as f:
        assert "zlib" not in f.read().split("#include <cctype>")[1]
    import gzip

    bad = tmp_path / "bad.txt.gz"
    with gzip.open(bad, "wt") as f:
        f.write("#version: 0.2\na b\nab c\n")
    with pytest.raises(ValueError, match="merge rules"):
        bindings.bpe_encode_batch(["a"], str(bad))
