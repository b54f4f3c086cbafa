"""Captioning evaluation: BLEU and the caption-model downstream metric (port of
``multimodal_tpu/eval/captioning.py``).

BLEU is the reference's own (clipped n-gram precision, brevity penalty, epsilon smoothing
for zero counts: nltk's method1), copied as it is. ``CaptioningMetric`` trains a
``ClipCaptionModel`` on frozen CLIP image embeddings, generates captions for held-out ones
and scores them: AdamW with optax's ``adamw`` defaults (b1 0.9, b2 0.999, eps 1e-8, weight
decay 1e-4 on every parameter, biases and LayerNorms included), the reference's numpy
permutation each epoch and its ``range(0, n - bs + 1, bs)`` batches.
"""

from __future__ import annotations

import logging
import math
from collections import Counter
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from multimodal_tpu_torch.inference import model_mode

log = logging.getLogger(__name__)


def _ngrams(tokens: Sequence, n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def sentence_bleu(
    references: Sequence[Sequence[str]],
    hypothesis: Sequence[str],
    weights: Sequence[float] = (0.25, 0.25, 0.25, 0.25),
    smooth_eps: float = 0.1,
) -> float:
    """Sentence BLEU with clipped n-gram precision, brevity penalty, and epsilon smoothing
    for zero counts (nltk SmoothingFunction method1 — the reference's effective setting)."""
    hyp_len = len(hypothesis)
    if hyp_len == 0:
        return 0.0
    ref_lens = [len(r) for r in references]
    closest_ref = min(ref_lens, key=lambda rl: (abs(rl - hyp_len), rl))
    bp = 1.0 if hyp_len > closest_ref else math.exp(1.0 - closest_ref / max(hyp_len, 1))

    score = 0.0
    for n, w in enumerate(weights, start=1):
        if w == 0:
            continue
        hyp_ngrams = _ngrams(hypothesis, n)
        total = max(sum(hyp_ngrams.values()), 1)
        max_ref = Counter()
        for ref in references:
            for g, c in _ngrams(ref, n).items():
                max_ref[g] = max(max_ref[g], c)
        clipped = sum(min(c, max_ref[g]) for g, c in hyp_ngrams.items())
        p_n = clipped / total if clipped > 0 else smooth_eps / total
        score += w * math.log(p_n)
    return bp * math.exp(score)


def corpus_bleu(references_list, hypotheses, **kw) -> float:
    return float(np.mean([
        sentence_bleu(refs, hyp, **kw) for refs, hyp in zip(references_list, hypotheses)
    ]))


class CaptioningMetric:
    """Train a ``ClipCaptionModel`` on frozen CLIP image embeddings, generate captions on
    held-out images, score BLEU against the ground truth. The caption model is a port
    module (its device is where the work runs); without one, the default
    ``ClipCaptionModel`` is built on ``device``."""

    def __init__(
        self,
        caption_model=None,
        tokenizer: Optional[Callable] = None,
        detokenizer: Optional[Callable] = None,
        epochs: int = 3,
        batch_size: int = 32,
        lr: float = 2e-5,
        max_gen_len: int = 40,
        temperature: float = 0.0,
        seed: int = 0,
        eos_token: Optional[int] = None,
        device: str | torch.device = "cuda",
    ):
        """eos_token: the id that ends generation AND truncates hypotheses before scoring;
        None keeps the caption model's own default (GPT-2's 50256) and truncates nothing."""
        from multimodal_tpu_torch.models.captioner import ClipCaptionModel

        self.model = caption_model or ClipCaptionModel(device=device, seed=seed)
        self.device = next(self.model.parameters()).device
        self.tokenizer = tokenizer
        self.detokenizer = detokenizer
        self.epochs = epochs
        self.batch_size = batch_size
        self.lr = lr
        self.max_gen_len = max_gen_len
        self.temperature = temperature
        self.seed = seed
        self.eos_token = eos_token

    def _upload(self, array, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=dtype).to(self.device)

    def train(self, clip_embeds: np.ndarray, token_ids: np.ndarray, params=None) -> dict:
        """Train the caption model (frozen CLIP embeddings in, next-token CE out) from
        ``params`` (a state dict) or, without them, from the weights of ``seed``; returns the
        trained state dict. token_ids: [N, T] int, 0-padded."""
        model = self.model
        n = clip_embeds.shape[0]
        if n == 0:
            raise ValueError("captioning train set is empty")
        model.load_state_dict(params if params is not None
                              else model.fresh_state_dict(self.seed))
        opt = torch.optim.AdamW(model.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4)
        bs = min(self.batch_size, n)  # never zero optimizer steps on a small train set
        rng = np.random.default_rng(self.seed)
        loss = torch.tensor(float("nan"))
        with model_mode(model, True):
            for epoch in range(self.epochs):
                order = rng.permutation(n)
                for start in range(0, n - bs + 1, bs):
                    idx = order[start : start + bs]
                    loss = model(self._upload(clip_embeds[idx], torch.float32),
                                 self._upload(token_ids[idx], torch.int64))
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
                    opt.step()
                log.info("caption epoch %d: loss %.4f", epoch, float(loss.detach()))
        return model.state_dict()

    def generate(self, params, clip_embeds: np.ndarray) -> np.ndarray:
        """Captions for ``clip_embeds`` in batches of ``batch_size`` from ``params`` (None: the
        model as it is); one generator seeded with ``seed + 1`` across the batches."""
        if params is not None:
            self.model.load_state_dict(params)
        generator = torch.Generator(device=self.device).manual_seed(self.seed + 1)
        kw = {} if self.eos_token is None else {"eos_token": self.eos_token}
        outs = []
        with model_mode(self.model, False):
            for start in range(0, clip_embeds.shape[0], self.batch_size):
                emb = self._upload(clip_embeds[start : start + self.batch_size], torch.float32)
                outs.append(self.model.generate(
                    emb, generator, max_len=self.max_gen_len, temperature=self.temperature,
                    **kw).cpu().numpy())
        return np.concatenate(outs, axis=0)

    def compute(
        self,
        train_embeds: np.ndarray,
        train_tokens: np.ndarray,
        eval_embeds: np.ndarray,
        eval_captions: Sequence[str],
        params=None,
    ) -> tuple[float, dict]:
        """Train -> generate -> BLEU. eval_captions are reference strings; generated ids are
        detokenized with ``self.detokenizer``."""
        params = self.train(train_embeds, train_tokens, params=params)
        gen_ids = self.generate(params, eval_embeds)
        detok = self.detokenizer or (lambda ids: " ".join(str(i) for i in ids if i > 0))

        def clean(row):
            ids = [int(t) for t in row]
            if self.eos_token is not None and self.eos_token in ids:
                ids = ids[: ids.index(self.eos_token)]  # drop EOS and everything after
            return [t for t in ids if t > 0]

        hyps = [detok(clean(row)).split() for row in gen_ids]
        refs = [[c.split()] for c in eval_captions]
        bleu = corpus_bleu(refs, hyps)
        return bleu, {"bleu": bleu, "num_eval": len(hyps)}
