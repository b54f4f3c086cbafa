"""Semantic caption embeddings for AlignCLIP's NL semantic supervision (port of
``multimodal_tpu/data/semantic.py``: ``HashingSemanticEncoder`` and
``make_semantic_encoder``).

The encoder maps captions to ``[B, D]`` float32 rows, L2-normalized, which the align loss
turns into its ``1 - S S^T`` weights. ``HashingSemanticEncoder`` is deterministic
bag-of-n-grams feature hashing: no weights and no network; captions that share words get a
high cosine similarity, disjoint ones a low one.

Not ported yet: the reference's ``HFSentenceEncoder`` (a local sentence-transformers
snapshot through ``transformers``), ROADMAP Queue 1 item 8; ``make_semantic_encoder`` with a
model path raises ``NotImplementedError``."""

from __future__ import annotations

import hashlib
import re
from typing import Sequence

import numpy as np

_WORD = re.compile(r"[a-z0-9']+")


class HashingSemanticEncoder:
    def __init__(self, dim: int = 256, ngrams: int = 2):
        self.dim = dim
        self.ngrams = ngrams

    def _bucket(self, token: str) -> tuple[int, float]:
        h = hashlib.blake2b(token.encode(), digest_size=8).digest()
        return int.from_bytes(h[:4], "little") % self.dim, (1.0 if h[4] & 1 else -1.0)

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for row, text in enumerate(texts):
            words = _WORD.findall(text.lower())
            grams = list(words)
            for n in range(2, self.ngrams + 1):
                grams += [" ".join(words[i: i + n]) for i in range(len(words) - n + 1)]
            for g in grams:
                idx, sign = self._bucket(g)
                out[row, idx] += sign
        norms = np.linalg.norm(out, axis=1, keepdims=True)
        return out / np.maximum(norms, 1e-12)


def make_semantic_encoder(model_path: str | None = None, dim: int = 256):
    """The hashing encoder; a ``model_path`` (a sentence-transformers snapshot) raises."""
    if model_path:
        raise NotImplementedError(
            f"semantic_model_path={model_path!r}: the transformers sentence encoder "
            "(HFSentenceEncoder) is not ported yet (ROADMAP Queue 1 item 8)")
    return HashingSemanticEncoder(dim=dim)
