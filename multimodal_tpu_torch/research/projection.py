"""Embedding projections for modality-gap visualization (the "cone effect" figures; the
port's own copy of ``multimodal_tpu/research/projection.py``, numpy only).

PCA / normalized-PCA / t-SNE / UMAP 2-D and 3-D projections of paired image/text embeddings,
with image-text pair segments. Plot-free: returns projected coordinates and pair indices;
rendering (matplotlib) is the caller's concern. UMAP needs umap-learn, imported where it is
used; where it is missing the ``ImportError`` names it."""

from __future__ import annotations

import numpy as np


def pca_projection(x: np.ndarray, n_components: int = 2, center: bool = True):
    """Plain PCA via SVD. Returns (projected [N,k], components [k,D], explained_var [k])."""
    x = np.asarray(x, np.float64)
    mean = x.mean(axis=0) if center else np.zeros(x.shape[1])
    xc = x - mean
    u, s, vt = np.linalg.svd(xc, full_matrices=False)
    comps = vt[:n_components]
    proj = xc @ comps.T
    explained = (s[:n_components] ** 2) / max(len(x) - 1, 1)
    return proj, comps, explained


def tsne_projection(
    x: np.ndarray,
    n_components: int = 2,
    perplexity: float = 30.0,
    iters: int = 500,
    learning_rate: float = 200.0,
    seed: int = 0,
) -> np.ndarray:
    """Exact t-SNE (van der Maaten & Hinton 2008), from scratch in numpy.

    The dependency-free nonlinear projection beside UMAP (which needs umap-learn): the
    same non-linear 2/3-D modality-gap visualization with numpy alone. Exact O(N^2)
    pairwise affinities, for the <= few-thousand-point figure regime the reference plots.
    Standard recipe: per-point sigma by binary search to the target perplexity,
    symmetrized P, early exaggeration (x12 for the first 100 iters), momentum GD
    on the Student-t Q."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    if n <= n_components + 1:
        return rng.standard_normal((n, n_components)) * 1e-4

    d2 = np.square(x[:, None, :] - x[None, :, :]).sum(-1)
    target = np.log(max(min(perplexity, (n - 1) / 3.0), 2.0))
    P = np.zeros((n, n))
    for i in range(n):
        lo, hi, beta = 1e-20, 1e20, 1.0
        di = np.delete(d2[i], i)
        for _ in range(50):
            p = np.exp(-di * beta)
            s = p.sum()
            if s <= 1e-300:
                beta, hi = (lo + beta) / 2.0, beta
                continue
            p /= s
            h = -(p * np.log(np.maximum(p, 1e-300))).sum()  # entropy = log(perp)
            if abs(h - target) < 1e-5:
                break
            if h > target:  # too flat -> sharpen
                lo, beta = beta, beta * 2.0 if hi >= 1e20 else (beta + hi) / 2.0
            else:
                hi, beta = beta, beta / 2.0 if lo <= 1e-20 else (beta + lo) / 2.0
        row = np.exp(-d2[i] * beta)
        row[i] = 0.0
        P[i] = row / max(row.sum(), 1e-300)
    P = (P + P.T) / (2.0 * n)
    P = np.maximum(P, 1e-12)

    y = rng.standard_normal((n, n_components)) * 1e-4
    update = np.zeros_like(y)
    for it in range(iters):
        exagg = 12.0 if it < 100 else 1.0
        momentum = 0.5 if it < 250 else 0.8
        yd2 = np.square(y[:, None, :] - y[None, :, :]).sum(-1)
        w = 1.0 / (1.0 + yd2)
        np.fill_diagonal(w, 0.0)
        Q = np.maximum(w / max(w.sum(), 1e-300), 1e-12)
        pq = (exagg * P - Q) * w  # [N,N]
        grad = 4.0 * ((np.diag(pq.sum(1)) - pq) @ y)
        update = momentum * update - learning_rate * grad
        y = y + update
        y = y - y.mean(axis=0)
    return y


def project_embeddings(
    image_embeddings: np.ndarray,
    text_embeddings: np.ndarray,
    method: str = "pca",
    n_components: int = 2,
    normalize: bool = False,
    seed: int = 0,
) -> dict:
    """Joint projection of both modalities (cardelph_projection.py methods dispatch):
    method in {'pca', 'pca-norm', 'tsne', 'umap'}. Returns {'image': [N,k],
    'text': [M,k], 'pairs': [(i, j)], 'method': ...} where pairs link index i of image
    to j of text (identity pairing up to min(N, M), matching the COCO/LAION paired
    sets). 'tsne' is the dependency-free nonlinear option (tsne_projection); 'umap'
    needs umap-learn and is gated."""
    img = np.asarray(image_embeddings, np.float64)
    txt = np.asarray(text_embeddings, np.float64)
    if normalize or method == "pca-norm":
        img = img / np.maximum(np.linalg.norm(img, axis=1, keepdims=True), 1e-12)
        txt = txt / np.maximum(np.linalg.norm(txt, axis=1, keepdims=True), 1e-12)
    both = np.concatenate([img, txt], axis=0)

    if method in ("pca", "pca-norm"):
        proj, _, _ = pca_projection(both, n_components)
    elif method == "tsne":
        proj = tsne_projection(both, n_components, seed=seed)
    elif method == "umap":
        try:
            import umap
        except ImportError as e:
            raise ImportError("method='umap' needs the 'umap-learn' package (module 'umap'), "
                              "which is not installed") from e
        proj = umap.UMAP(n_components=n_components, random_state=seed).fit_transform(both)
    else:
        raise ValueError(f"unknown projection method {method!r}")

    n = img.shape[0]
    return {
        "image": proj[:n],
        "text": proj[n:],
        "pairs": [(i, i) for i in range(min(n, txt.shape[0]))],
        "method": method,
    }
