"""Zero-shot classification: template-averaged classifier weights and top-k accuracy (port of
``multimodal_tpu/eval/zero_shot.py``). For each class every template's text embedding is
normalized, the templates are averaged and the mean renormalized; an image's logits are
``100 * features @ classifier``. The encode callables take torch tensors on the model's
device (int tokens [N, ctx]; NHWC images, uint8 or normalized) and return features [N, E]."""

from __future__ import annotations

from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from multimodal_tpu_torch.data.tokenizer import tokenize
from multimodal_tpu_torch.eval.metadata import apply_templates


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def build_zero_shot_classifier(encode_text_fn: Callable, classnames: Sequence[str],
                               templates: Sequence[str], batch_classes: int = 10,
                               tokenizer=None, context_length: int = 77,
                               device="cuda") -> torch.Tensor:
    """[E, C] float32 classifier weights on ``device``, ``batch_classes`` classes' templates
    encoded per call."""
    num_templates = len(templates)
    weights = []
    for start in range(0, len(classnames), batch_classes):
        chunk = classnames[start : start + batch_classes]
        texts = [t for c in chunk for t in apply_templates(c, list(templates))]
        tokens = tokenize(texts, context_length=context_length, tokenizer=tokenizer)
        feats = encode_text_fn(torch.from_numpy(tokens.astype(np.int64)).to(device))
        feats = _unit(feats.to(torch.float32).reshape(len(chunk), num_templates, -1))
        weights.append(_unit(feats.mean(dim=1)))
    return torch.cat(weights).T.contiguous()


def accuracy_counts(logits, targets, topk=(1, 5)) -> list:
    """Counts of top-k hits, as floats; ``k`` is capped at the number of classes."""
    logits = torch.as_tensor(logits)
    targets = torch.as_tensor(np.asarray(targets), device=logits.device).to(torch.int64)
    out = []
    for k in topk:
        top = logits.topk(min(k, logits.shape[-1]), dim=-1).indices
        out.append(float((top == targets[:, None]).any(dim=-1).sum()))
    return out


def zero_shot_eval(encode_image_fn: Callable, classifier: torch.Tensor, batches: Iterable,
                   topk=(1, 5)) -> dict:
    """``batches`` yield (images, labels), the images numpy or tensors; they go to the
    classifier's device. Returns {'top1': accuracy, 'top5': accuracy}."""
    counts = [0.0 for _ in topk]
    n = 0
    for images, labels in batches:
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(images))
        feats = _unit(encode_image_fn(x.to(classifier.device)).to(torch.float32))
        logits = 100.0 * feats @ classifier
        counts = [a + b for a, b in zip(counts, accuracy_counts(logits, labels, topk))]
        n += len(labels)
    return {f"top{k}": counts[i] / max(n, 1) for i, k in enumerate(topk)}
