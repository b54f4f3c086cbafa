"""Semantic caption embeddings for AlignCLIP's NL semantic supervision (port of
``multimodal_tpu/data/semantic.py``: ``HashingSemanticEncoder``, ``HFSentenceEncoder`` and
``make_semantic_encoder``).

The encoder maps captions to ``[B, D]`` float32 rows, L2-normalized, which the align loss
turns into its ``1 - S S^T`` weights. ``HashingSemanticEncoder`` is deterministic
bag-of-n-grams feature hashing: no weights and no network; captions that share words get a
high cosine similarity, disjoint ones a low one. ``HFSentenceEncoder`` mean-pools a local
transformers snapshot (a sentence-transformers model) under the attention mask.

Unlike the reference, ``make_semantic_encoder`` never falls back: a model path that is not a
loadable snapshot, or a missing ``transformers``, raises."""

from __future__ import annotations

import hashlib
import os
import re
from typing import Sequence

import numpy as np
import torch

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


class HFSentenceEncoder:
    """Mean-pooled transformer sentence embeddings from a local snapshot (e.g.
    sentence-transformers/all-mpnet-base-v2), run on ``device``; the rows are L2-normalized
    float32 on the host. ``transformers`` is imported here, and an ``ImportError`` names it
    where it is missing."""

    def __init__(self, model_path: str, max_length: int = 128, batch_size: int = 64,
                 device="cuda"):
        try:
            from transformers import AutoModel, AutoTokenizer
        except ImportError as e:
            raise ImportError("--semantic-model-path needs the 'transformers' package, which "
                              "is not installed") from e
        if not os.path.isdir(model_path):
            raise FileNotFoundError(f"semantic model path {model_path!r} is not a directory "
                                    "(a local transformers snapshot)")
        self.device = torch.device(device)
        self.tokenizer = AutoTokenizer.from_pretrained(model_path, local_files_only=True)
        self.model = AutoModel.from_pretrained(model_path, local_files_only=True).eval()
        self.model.to(self.device)
        self.max_length = max_length
        self.batch_size = batch_size

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        outs = []
        for start in range(0, len(texts), self.batch_size):
            chunk = list(texts[start : start + self.batch_size])
            enc = self.tokenizer(chunk, padding=True, truncation=True,
                                 max_length=self.max_length, return_tensors="pt")
            enc = {k: v.to(self.device) for k, v in enc.items()}
            with torch.inference_mode():
                hidden = self.model(**enc).last_hidden_state  # [B, T, D]
                mask = enc["attention_mask"][..., None].float()
                pooled = (hidden * mask).sum(1) / mask.sum(1).clamp(min=1e-9)
            outs.append(pooled.float().cpu().numpy())
        out = np.concatenate(outs, axis=0).astype(np.float32)
        return out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-12)


def make_semantic_encoder(model_path: str | None = None, dim: int = 256, device="cuda"):
    """``HFSentenceEncoder`` on ``device`` for a ``model_path``, else the hashing encoder. A
    path that does not load raises (the reference falls back to hashing with a warning)."""
    if model_path:
        return HFSentenceEncoder(model_path, device=device)
    return HashingSemanticEncoder(dim=dim)
