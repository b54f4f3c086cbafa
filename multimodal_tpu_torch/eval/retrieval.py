"""Cross-modal retrieval metrics (port of ``multimodal_tpu/eval/retrieval.py``): R@K both
ways over captions mapped to images, and the paired-set statistics of a validation pass.
Host-side numpy on float32 rows, L2-normalized with a 1e-12 floor."""

from __future__ import annotations

import numpy as np


def _l2_normalize(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), np.float32(1e-12))


def recall_at_k(image_features, text_features, text_to_image: np.ndarray,
                ks=(1, 5, 10)) -> dict:
    """image_features [Ni, E]; text_features [Nt, E]; text_to_image [Nt] maps each caption to
    its image. Returns ``text_to_image_R@k`` (the paired image in a caption's top k) and
    ``image_to_text_R@k`` (any of an image's captions in its top k)."""
    img, txt = _l2_normalize(image_features), _l2_normalize(text_features)
    t2i = np.asarray(text_to_image)
    sims = txt @ img.T
    out = {}
    order = np.argsort(-sims, axis=-1)
    for k in ks:
        out[f"text_to_image_R@{k}"] = float((order[:, :k] == t2i[:, None]).any(axis=-1).mean())
    order_i = np.argsort(-sims.T, axis=-1)
    for k in ks:
        hits = t2i[order_i[:, :k]] == np.arange(img.shape[0])[:, None]
        out[f"image_to_text_R@{k}"] = float(hits.any(axis=-1).mean())
    return out


def get_clip_metrics(image_features, text_features, logit_scale=1.0) -> dict:
    """Paired-set retrieval with the diagonal as the target: R@{1,5,10} and the mean and
    median rank, both ways."""
    img, txt = _l2_normalize(image_features), _l2_normalize(text_features)
    logits_per_image = float(logit_scale) * img @ txt.T
    metrics = {}
    for name, logits in (("image_to_text", logits_per_image),
                         ("text_to_image", logits_per_image.T)):
        ranking = np.argsort(-logits, axis=-1)
        n = logits.shape[0]
        preds = np.argmax(ranking == np.arange(n)[:, None], axis=-1)
        metrics[f"{name}_mean_rank"] = float(preds.mean() + 1)
        metrics[f"{name}_median_rank"] = float(np.floor(np.median(preds)) + 1)
        for k in (1, 5, 10):
            metrics[f"{name}_R@{k}"] = float((preds < k).mean())
    return metrics
