"""GMM-on-embeddings study: incremental component counts with model-selection criteria (the
port's own copy of ``multimodal_tpu/research/gmm_fit.py``, numpy and scikit-learn only).

BIC / AIC / silhouette / Calinski-Harabasz / Davies-Bouldin over increasing K, and the
cross-modality statistics of image and text embeddings. Plot-free: returns structured results
the caller can render or dump to JSON. ``gmm_model_selection`` needs scikit-learn, imported
where it is used; where it is missing the ``ImportError`` names it."""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np

log = logging.getLogger(__name__)


def gmm_model_selection(
    embeddings: np.ndarray,
    component_range: Sequence[int] = tuple(range(1, 11)),
    covariance_type: str = "diag",
    seed: int = 0,
    max_iter: int = 200,
) -> dict:
    """Fit GaussianMixture for each K; report BIC/AIC and clustering scores (K >= 2).
    Returns {'results': [per-K dicts], 'best_bic_k', 'best_aic_k', 'best_silhouette_k'}."""
    try:
        from sklearn.metrics import (
            calinski_harabasz_score,
            davies_bouldin_score,
            silhouette_score,
        )
        from sklearn.mixture import GaussianMixture
    except ImportError as e:
        raise ImportError("gmm_model_selection needs scikit-learn ('sklearn'), which is not "
                          "installed") from e

    x = np.asarray(embeddings, np.float64)
    results = []
    for k in component_range:
        gmm = GaussianMixture(
            n_components=k, covariance_type=covariance_type, random_state=seed,
            max_iter=max_iter,
        ).fit(x)
        entry = {
            "n_components": int(k),
            "bic": float(gmm.bic(x)),
            "aic": float(gmm.aic(x)),
            "log_likelihood": float(gmm.score(x)),
            "converged": bool(gmm.converged_),
        }
        if k >= 2:
            labels = gmm.predict(x)
            if len(np.unique(labels)) >= 2:
                entry["silhouette"] = float(silhouette_score(x, labels))
                entry["calinski_harabasz"] = float(calinski_harabasz_score(x, labels))
                entry["davies_bouldin"] = float(davies_bouldin_score(x, labels))
        results.append(entry)
        log.info("GMM K=%d: bic=%.1f aic=%.1f", k, entry["bic"], entry["aic"])

    with_sil = [r for r in results if "silhouette" in r]
    return {
        "results": results,
        "best_bic_k": min(results, key=lambda r: r["bic"])["n_components"],
        "best_aic_k": min(results, key=lambda r: r["aic"])["n_components"],
        "best_silhouette_k": (
            max(with_sil, key=lambda r: r["silhouette"])["n_components"] if with_sil else None
        ),
    }


def modality_statistics(image_embeddings: np.ndarray, text_embeddings: np.ndarray) -> dict:
    """Image-vs-text distribution statistics (gmm_fit.py:358-425): per-modality norms,
    centroid distance (the modality gap), mean pairwise cosine within/between."""
    img = np.asarray(image_embeddings, np.float64)
    txt = np.asarray(text_embeddings, np.float64)

    def unit(x):
        return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)

    ui, ut = unit(img), unit(txt)
    ci, ct = ui.mean(axis=0), ut.mean(axis=0)
    return {
        "image_mean_norm": float(np.linalg.norm(img, axis=1).mean()),
        "text_mean_norm": float(np.linalg.norm(txt, axis=1).mean()),
        "centroid_cosine": float(
            ci @ ct / max(np.linalg.norm(ci) * np.linalg.norm(ct), 1e-12)
        ),
        "centroid_distance": float(np.linalg.norm(ci - ct)),
        "within_image_cosine": float((ui @ ui.T).mean()),
        "within_text_cosine": float((ut @ ut.T).mean()),
        "cross_modal_cosine": float((ui @ ut.T).mean()),
        "paired_cosine": float((ui * ut[: len(ui)][: len(ui)]).sum(axis=1).mean())
        if len(ui) == len(ut) else None,
    }
