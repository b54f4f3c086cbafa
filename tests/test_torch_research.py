"""The port's research toolkit (``multimodal_tpu_torch/research``) against the JAX package's,
on the CPU: the concentration solve, one EM step, k-means++ with JAX's draws replayed
through ``ops.draws``, whole fits from JAX's initial means, the GMM study, the projections,
the entropies and figures, and ``fit_mixture --synthetic``'s JSON.

Tolerances: float32 EM quantities within 1e-4 relative (sum order; the Bessel ratio's
Newton steps are the port's own arithmetic); the numpy and scikit-learn modules, copied,
equal; the k-means++ centers the very rows JAX picks."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.research import fit_mixture as jfit
from multimodal_tpu.research import gmm_fit as jgmm
from multimodal_tpu.research import projection as jproj
from multimodal_tpu.research import visualization as jvis
from multimodal_tpu.research import vmf_mixture as jvmf
from multimodal_tpu_torch.ops import draws
from multimodal_tpu_torch.research import fit_mixture, gmm_fit, projection, visualization
from multimodal_tpu_torch.research import vmf_mixture as pvmf

torch.set_num_threads(2)


def clusters(n=240, d=16, k=3, seed=0, spread=0.3):
    rng = np.random.default_rng(seed)
    mus = rng.standard_normal((k, d))
    x = np.concatenate([m + spread * rng.standard_normal((n // k, d)) for m in mus])
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def close(a, b, rtol=1e-4, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("dim", [2, 3, 64, 512])
def test_solve_concentration(dim):
    rbar = np.float32([1e-7, 0.01, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99, 0.999, 1.0])
    want = np.asarray(jvmf.solve_concentration(jnp.asarray(rbar), dim))
    got = pvmf.solve_concentration(torch.from_numpy(rbar), dim).numpy()
    close(got, want, what=f"dim {dim}")


def test_one_em_step():
    x = clusters()
    rng = np.random.default_rng(1)
    mus = x[rng.choice(len(x), 3, replace=False)]
    w = np.float32([0.2, 0.5, 0.3])
    kap = np.float32([4.0, 12.0, 40.0])
    want = jvmf._em_step(jnp.asarray(x), jnp.asarray(w), jnp.asarray(mus), jnp.asarray(kap), 3)
    got = pvmf._em_step(*(torch.from_numpy(a) for a in (x, w, mus, kap)), 3)
    for name, g, j in zip(("weights", "mus", "kappas", "ll"), got, want):
        close(g.numpy(), np.asarray(j), atol=1e-6, what=name)


def jax_init(x, k, seed):
    return np.asarray(jvmf._kmeanspp_init(jax.random.PRNGKey(seed), jnp.asarray(x), k))


def test_kmeanspp_with_jaxs_draws(monkeypatch):
    """JAX's randint and its choice's uniform, on JAX's key schedule, through the port's
    draw helpers: the port picks the same rows."""
    x = clusters(n=300, d=8, k=5, seed=2)
    k, seed = 5, 7
    key = jax.random.PRNGKey(seed)
    k0, key = jax.random.split(key)
    ints = [int(jax.random.randint(k0, (), 0, len(x)))]
    uniforms = []
    for _ in range(1, k):
        key, sub = jax.random.split(key)
        uniforms.append(float(jax.random.uniform(sub, ())))
    monkeypatch.setattr(draws, "randint", lambda high, g, like: torch.tensor(ints.pop(0)))
    monkeypatch.setattr(draws, "uniform", lambda shape, g, like, low=0.0: torch.tensor(
        uniforms.pop(0), dtype=torch.float32))
    got = pvmf._kmeanspp_init(torch.Generator(), torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(got, jax_init(x, k, seed))
    assert not ints and not uniforms


def test_whole_fit_from_jaxs_initial_means():
    x = clusters(n=600, d=32, k=4, seed=3)
    kw = dict(n_components=4, max_iter=30, tol=1e-6, seed=5)
    want = jvmf.VMFMixtureEM(**kw).fit(x)
    got = pvmf.VMFMixtureEM(**kw, device="cpu").fit(x, init_means=jax_init(x, 4, 5))
    assert len(got.log_likelihoods_) == len(want.log_likelihoods_)
    assert got.converged_ == want.converged_
    close(got.log_likelihoods_, want.log_likelihoods_, what="log-likelihoods")
    close(got.weights, want.weights, atol=1e-6, what="weights")
    close(got.concentrations, want.concentrations, what="concentrations")
    close(got.mean_directions, want.mean_directions, atol=1e-5, what="mean directions")
    held = clusters(n=90, d=32, k=3, seed=4)
    close(got.log_likelihood(held), want.log_likelihood(held), what="held-out LL")
    # exp(-LL) of a 32-d density: compared as its log, the LL (1e-6 of 313 is 3e-4 of exp)
    close(np.log(got.perplexity(held)), np.log(want.perplexity(held)), what="perplexity")
    np.testing.assert_array_equal(got.predict(held), want.predict(held))
    assert json.loads(json.dumps(got.to_dict())).keys() == want.to_dict().keys()


def test_fit_with_its_own_seeding_recovers_the_clusters():
    x = clusters(n=300, d=16, k=3, seed=6, spread=0.15)
    em = pvmf.fit_von_mises_fisher_mixture(x, n_components=3, seed=0, device="cpu")
    assert sorted(np.round(em.weights * 3).astype(int).tolist()) == [1, 1, 1]
    assert np.all(em.concentrations > 10.0)


def test_em_lands_on_the_card_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pvmf.VMFMixtureEM(n_components=2).fit(clusters())


def test_gmm_and_modality_statistics_equal_jax():
    x = clusters(n=90, d=6, k=3, seed=8, spread=0.2)
    kw = dict(component_range=(1, 2, 3), seed=0, max_iter=50)
    assert gmm_fit.gmm_model_selection(x, **kw) == jgmm.gmm_model_selection(x, **kw)
    img, txt = clusters(n=40, d=6, seed=9), clusters(n=40, d=6, seed=10) * 2.0
    assert gmm_fit.modality_statistics(img, txt) == jgmm.modality_statistics(img, txt)


def test_projections_equal_jax():
    img, txt = clusters(n=30, d=8, seed=11), clusters(n=24, d=8, seed=12)
    for a, b in zip(projection.pca_projection(img, 3), jproj.pca_projection(img, 3)):
        np.testing.assert_array_equal(a, b)
    for method in ("pca", "pca-norm", "tsne"):
        got = projection.project_embeddings(img, txt, method=method, seed=1)
        want = jproj.project_embeddings(img, txt, method=method, seed=1)
        assert got["pairs"] == want["pairs"] and got["method"] == want["method"]
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["text"], want["text"])


def _hide(monkeypatch, *names):
    for name in names:
        monkeypatch.setitem(sys.modules, name, None)


def test_missing_optional_packages_are_named(monkeypatch):
    x = clusters(n=30, d=4)
    if "umap" not in sys.modules:
        _hide(monkeypatch, "umap")
    with pytest.raises(ImportError, match="umap-learn"):
        projection.project_embeddings(x, x, method="umap")
    _hide(monkeypatch, "sklearn", "sklearn.metrics", "sklearn.mixture")
    with pytest.raises(ImportError, match="scikit-learn"):
        gmm_fit.gmm_model_selection(x, component_range=(1,))
    _hide(monkeypatch, "matplotlib", "matplotlib.pyplot")
    with pytest.raises(ImportError, match="matplotlib"):
        visualization.plot_convergence([1.0, 2.0], "never.png")


class _Fitted:
    """A fitted mixture's attributes, the same numbers for both packages' figures."""

    def __init__(self, seed=0, k=3, d=5):
        rng = np.random.default_rng(seed)
        m = rng.standard_normal((k, d))
        self.mean_directions = (m / np.linalg.norm(m, axis=1, keepdims=True)).astype(np.float32)
        self.concentrations = np.float32([0.5, 8.0, 300.0])[:k]
        self.weights = np.float32([0.2, 0.3, 0.5])[:k]
        self.log_likelihoods_ = [-1.0, -0.5, -0.4]

    def predict(self, x):
        return np.argmax(np.asarray(x) @ self.mean_directions.T, axis=1)


def test_component_entropies_equal_jax():
    em = _Fitted()
    close(visualization.component_entropies(em), jvis.component_entropies(em), atol=1e-5)


def test_figures_are_pngs(tmp_path):
    em = _Fitted()
    data = clusters(n=30, d=5, seed=13)
    paths = visualization.visualize_mixture_model(em, data, str(tmp_path / "figs"))
    paths.append(visualization.plot_modality_gap(data, clusters(n=30, d=5, seed=14),
                                                 out_path=str(tmp_path / "gap.png")))
    paths.append(visualization.plot_training_metrics(
        {"total": [3.0, 2.0], "arc": [1.0, 0.5]}, str(tmp_path / "metrics.png")))
    assert len(paths) == 10  # 8 of the mixture (3-D and assignments included), 2 more
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
        assert os.path.getsize(p) > 1000


def test_fit_mixture_synthetic_json_equals_jax(tmp_path, monkeypatch):
    """The CLI on --synthetic data; the port's k-means++ seeding replaced by JAX's on the same
    train split, so both fits start from the same means."""
    def seeded_like_jax(generator, x, k):
        return torch.from_numpy(jax_init(x.numpy(), k, 0))

    monkeypatch.setattr(pvmf, "_kmeanspp_init", seeded_like_jax)
    argv = ["--synthetic", "300", "--dim", "16", "--components", "3", "--max-iter", "25"]
    assert jfit.main(argv + ["--output", str(tmp_path / "jax.json")]) == 0
    assert fit_mixture.main(argv + ["--output", str(tmp_path / "port.json"),
                                    "--device", "cpu"]) == 0
    want = json.loads((tmp_path / "jax.json").read_text())
    got = json.loads((tmp_path / "port.json").read_text())
    assert got.keys() == want.keys()
    for k in ("n_train", "n_test", "dim"):
        assert got[k] == want[k]
    assert got["model"]["converged"] == want["model"]["converged"]
    for k in ("train_log_likelihood", "test_log_likelihood"):
        close(got[k], want[k], what=k)
    close(np.log(got["test_perplexity"]), np.log(want["test_perplexity"]), what="perplexity")
    for k in ("weights", "concentrations", "log_likelihoods"):
        close(got["model"][k], want["model"][k], atol=1e-6, what=k)
    close(got["model"]["mean_directions"], want["model"]["mean_directions"], atol=1e-5)
