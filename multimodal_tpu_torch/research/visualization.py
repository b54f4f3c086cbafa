"""Research figures: vMF mixture diagnostics and modality-gap ("cone effect") projections
(port of ``multimodal_tpu/research/visualization.py``).

Weight / concentration bars, the PCA mean-direction scatter, the component similarity matrix,
data assignments, entropies, the comprehensive panel and the EM convergence curve of a fitted
mixture; the paired-embedding scatter with image-text pair lines; the loss bench's training
panel. Every function writes a PNG and returns its path, through matplotlib's headless Agg
backend; matplotlib is imported where it is used, and where it is missing the
``ImportError`` names it."""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("the research figures need the 'matplotlib' package, which is not "
                          "installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_mixture_summary(em, out_path: str = "mixture_summary.png") -> str:
    """Weights + concentrations bars, mean-direction PCA scatter, component similarity
    matrix, convergence curve — the reference's 'comprehensive figure' (:452)."""
    plt = _plt()
    from multimodal_tpu_torch.research.projection import pca_projection

    k = len(em.weights)
    fig, axes = plt.subplots(2, 2, figsize=(11, 9))

    axes[0, 0].bar(range(k), em.weights)
    axes[0, 0].set_title("component weights")
    axes[0, 0].set_xlabel("component")

    axes[0, 1].bar(range(k), em.concentrations, color="tab:orange")
    axes[0, 1].set_title("concentrations (kappa)")
    axes[0, 1].set_xlabel("component")

    if em.mean_directions.shape[1] > 2 and k >= 2:
        proj, _, _ = pca_projection(em.mean_directions, 2, center=False)
    else:
        proj = em.mean_directions[:, :2]
    axes[1, 0].scatter(proj[:, 0], proj[:, 1], s=60, c=range(k), cmap="tab10")
    for i, (x, y) in enumerate(proj):
        axes[1, 0].annotate(str(i), (x, y))
    axes[1, 0].set_title("mean directions (PCA)")

    sim = em.mean_directions @ em.mean_directions.T
    im = axes[1, 1].imshow(sim, vmin=-1, vmax=1, cmap="coolwarm")
    axes[1, 1].set_title("component similarity")
    fig.colorbar(im, ax=axes[1, 1])

    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def _pca2(points, center=False):
    from multimodal_tpu_torch.research.projection import pca_projection

    if points.shape[1] > 2 and len(points) >= 2:
        proj, _, _ = pca_projection(points, 2, center=center)
        return proj
    return points[:, :2]


def plot_component_parameters(em, out_path: str = "component_parameters.png") -> str:
    """Weights bar + concentrations bar + weight-vs-concentration scatter with C{i}
    labels (visualization.py:32-67 plot_component_parameters)."""
    plt = _plt()
    k = len(em.weights)
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].bar(range(k), em.weights)
    axes[0].set_xlabel("component"); axes[0].set_ylabel("weight")
    axes[0].set_title("Component Weights"); axes[0].grid(True, alpha=0.3)
    axes[1].bar(range(k), em.concentrations)
    axes[1].set_xlabel("component"); axes[1].set_ylabel("concentration")
    axes[1].set_title("Component Concentrations"); axes[1].grid(True, alpha=0.3)
    axes[2].scatter(em.weights, em.concentrations, s=100, alpha=0.7)
    for i, (w, c) in enumerate(zip(em.weights, em.concentrations)):
        axes[2].annotate(f"C{i}", (w, c), xytext=(5, 5), textcoords="offset points")
    axes[2].set_xlabel("weight"); axes[2].set_ylabel("concentration")
    axes[2].set_title("Weight vs Concentration"); axes[2].grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_mean_directions_2d(em, data=None, out_path: str = "mean_directions_2d.png") -> str:
    """PCA scatter of mean directions (size ~ weight, alpha ~ concentration) over the data
    cloud (visualization.py:69-150 plot_mean_directions_2d)."""
    plt = _plt()
    k = len(em.weights)
    pts = em.mean_directions if data is None else np.vstack([em.mean_directions, data])
    proj = _pca2(pts)
    means2d, data2d = proj[:k], (proj[k:] if data is not None else None)
    fig, ax = plt.subplots(figsize=(9, 7))
    if data2d is not None:
        ax.scatter(data2d[:, 0], data2d[:, 1], alpha=0.3, s=20, c="lightblue",
                   label="data points")
    colors = plt.cm.tab10(np.linspace(0, 1, k))
    for i in range(k):
        ax.scatter(means2d[i, 0], means2d[i, 1], s=max(float(em.weights[i]) * 1000, 30),
                   c=[colors[i]], alpha=min(1.0, float(em.concentrations[i]) / 10.0 + 0.3),
                   edgecolors="black", linewidth=2,
                   label=f"component {i} (w={em.weights[i]:.3f}, "
                         f"k={em.concentrations[i]:.2f})")
    ax.set_xlabel("PC1"); ax.set_ylabel("PC2")
    ax.set_title("Mean Directions in 2D (PCA)")
    ax.legend(bbox_to_anchor=(1.05, 1), loc="upper left")
    ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_mean_directions_3d(em, data=None, out_path: str = "mean_directions_3d.png") -> str:
    """3-D scatter over the first three dimensions with a unit-sphere wireframe
    (visualization.py:151-203 plot_mean_directions_3d)."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 8))
    ax = fig.add_subplot(111, projection="3d")
    u, v = np.mgrid[0 : 2 * np.pi : 24j, 0 : np.pi : 12j]
    ax.plot_wireframe(np.cos(u) * np.sin(v), np.sin(u) * np.sin(v), np.cos(v),
                      alpha=0.1, color="gray")
    if data is not None:
        ax.scatter(data[:, 0], data[:, 1], data[:, 2], alpha=0.3, s=10, c="lightblue")
    k = len(em.weights)
    colors = plt.cm.tab10(np.linspace(0, 1, k))
    for i, m in enumerate(em.mean_directions):
        ax.quiver(0, 0, 0, m[0], m[1], m[2], color=colors[i], linewidth=2)
        ax.scatter([m[0]], [m[1]], [m[2]], s=max(float(em.weights[i]) * 500, 30),
                   c=[colors[i]], edgecolors="black")
    ax.set_xlabel("dim 1"); ax.set_ylabel("dim 2"); ax.set_zlabel("dim 3")
    ax.set_title("Mean Directions in 3D (First 3 Dimensions)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_component_similarity_matrix(em, out_path: str = "similarity_matrix.png") -> str:
    """Annotated mu_i . mu_j heatmap (visualization.py:204-243)."""
    plt = _plt()
    sim = em.mean_directions @ em.mean_directions.T
    k = sim.shape[0]
    fig, ax = plt.subplots(figsize=(8, 6))
    im = ax.imshow(sim, vmin=-1, vmax=1, cmap="coolwarm")
    for i in range(k):
        for j in range(k):
            ax.text(j, i, f"{sim[i, j]:.2f}", ha="center", va="center", fontsize=8)
    ax.set_xlabel("component"); ax.set_ylabel("component")
    ax.set_title("Component Mean Direction Similarities")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_data_assignment(em, data, out_path: str = "data_assignments.png") -> str:
    """Data scatter colored by most-likely component + assignment-count bars
    (visualization.py:244-312 plot_data_assignment)."""
    plt = _plt()
    assignments = np.asarray(em.predict(data))
    k = len(em.weights)
    proj = _pca2(np.vstack([em.mean_directions, data]))
    means2d, data2d = proj[:k], proj[k:]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(14, 6))
    colors = plt.cm.tab10(np.linspace(0, 1, k))
    for c in range(k):
        mask = assignments == c
        if mask.any():
            ax1.scatter(data2d[mask, 0], data2d[mask, 1], s=20, alpha=0.5,
                        c=[colors[c]], label=f"component {c}")
    ax1.scatter(means2d[:, 0], means2d[:, 1], s=200, c=colors[:k], marker="*",
                edgecolors="black", linewidth=1.5)
    ax1.set_xlabel("PC1"); ax1.set_ylabel("PC2")
    ax1.set_title("Data Points by Component Assignment")
    ax1.legend(); ax1.grid(True, alpha=0.3)
    counts = np.bincount(assignments, minlength=k)
    ax2.bar(range(k), counts)
    ax2.set_xlabel("component"); ax2.set_ylabel("number of assigned points")
    ax2.set_title("Component Assignment Distribution"); ax2.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def component_entropies(em) -> np.ndarray:
    """Per-component vMF differential entropy through ``distributions.VonMisesFisher``, on
    the CPU in float32."""
    import torch

    from multimodal_tpu_torch.distributions import VonMisesFisher

    d = VonMisesFisher(torch.as_tensor(np.asarray(em.mean_directions, np.float32)),
                       torch.as_tensor(np.asarray(em.concentrations, np.float32)))
    with torch.no_grad():
        return d.entropy().numpy()


def plot_component_entropy(em, out_path: str = "component_entropies.png") -> str:
    """Entropy bar chart with value labels (visualization.py:313-345)."""
    plt = _plt()
    ent = component_entropies(em)
    fig, ax = plt.subplots(figsize=(10, 6))
    bars = ax.bar(range(len(ent)), ent)
    for bar, e in zip(bars, ent):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height(), f"{e:.3f}",
                ha="center", va="bottom", fontsize=9)
    ax.set_xlabel("component"); ax.set_ylabel("entropy")
    ax.set_title("Component Entropies"); ax.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def visualize_mixture_model(em, data=None, output_dir: str = "visualizations") -> list:
    """Render the full reference figure suite from a fitted mixture
    (visualization.py:452-540 visualize_mixture_model): component parameters, PCA-2D,
    3-D (when dim >= 3), similarity matrix, assignments (when data given), entropies,
    comprehensive panel, EM convergence. Returns the written paths."""
    os.makedirs(output_dir, exist_ok=True)
    p = lambda name: os.path.join(output_dir, name)  # noqa: E731
    paths = [
        plot_component_parameters(em, p("component_parameters.png")),
        plot_mean_directions_2d(em, data, p("mean_directions_2d_pca.png")),
        plot_component_similarity_matrix(em, p("similarity_matrix.png")),
        plot_component_entropy(em, p("component_entropies.png")),
        plot_mixture_summary(em, p("comprehensive_visualization.png")),
    ]
    if em.mean_directions.shape[1] >= 3:
        paths.append(plot_mean_directions_3d(em, data, p("mean_directions_3d.png")))
    if data is not None:
        paths.append(plot_data_assignment(em, data, p("data_assignments.png")))
    if getattr(em, "log_likelihoods_", None):
        paths.append(plot_convergence(em.log_likelihoods_, p("convergence.png")))
    return paths


def plot_convergence(log_likelihoods: Sequence[float], out_path: str = "convergence.png") -> str:
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(log_likelihoods)
    ax.set_xlabel("EM iteration")
    ax.set_ylabel("mean log-likelihood")
    ax.set_title("EM convergence")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_modality_gap(
    image_embeddings: np.ndarray,
    text_embeddings: np.ndarray,
    method: str = "pca-norm",
    max_pair_lines: int = 200,
    out_path: str = "modality_gap.png",
    seed: int = 0,
) -> str:
    """Paired image/text scatter with pair segments — the cone-effect figure
    (cardelph_projection.py:155+, metrics.ipynb:cell 22)."""
    plt = _plt()
    from multimodal_tpu_torch.research.projection import project_embeddings

    proj = project_embeddings(image_embeddings, text_embeddings, method=method, seed=seed)
    img, txt = proj["image"], proj["text"]
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.scatter(img[:, 0], img[:, 1], s=8, alpha=0.6, label="image", color="tab:blue")
    ax.scatter(txt[:, 0], txt[:, 1], s=8, alpha=0.6, label="text", color="tab:red")
    for i, j in proj["pairs"][:max_pair_lines]:
        ax.plot([img[i, 0], txt[j, 0]], [img[i, 1], txt[j, 1]],
                color="gray", alpha=0.15, linewidth=0.5)
    ax.legend()
    ax.set_title(f"modality gap ({method})")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def plot_training_metrics(history: dict, out_path: str = "training_metrics.png") -> str:
    """Loss/arc/concentration/grad-norm panel from a loss-bench history
    (test_vclipLoss.py's training_metrics.png)."""
    plt = _plt()
    fig, axes = plt.subplots(2, 2, figsize=(11, 8))
    panels = [
        ("total", "total loss"),
        ("arc", "mean pair arc (deg)"),
        ("conc_a", "mean concentration"),
        ("grad_norm", "gradient norm"),
    ]
    for ax, (key, title) in zip(axes.ravel(), panels):
        if key in history:
            ax.plot(np.asarray(history[key]))
        ax.set_title(title)
        ax.set_xlabel("step")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path
