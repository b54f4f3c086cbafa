"""von Mises-Fisher mixture fitting by EM on the device (port of
``multimodal_tpu/research/vmf_mixture.py``).

One EM step is a handful of tensor operations on the device: the E-step's responsibilities
from the vMF log densities and a logsumexp, the M-step's weights and normalized
responsibility-weighted mean directions, and each concentration solved from its mean
resultant length by the Banerjee et al. (2005) closed form refined with a fixed count of
Newton steps on A_d(kappa) = I_{d/2}(kappa) / I_{d/2-1}(kappa) = rbar, with the exact
derivative A' = 1 - A^2 - (d - 1) / kappa * A (``ops.bessel.bessel_iv_ratio``). The host
reads the mean log-likelihood once an iteration, for the convergence test. Initial mean
directions come from k-means++ on cosine distance, its draws through ``ops.draws`` from a
seeded ``torch.Generator``, or from the caller (``fit(x, init_means=...)``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from multimodal_tpu_torch.ops import draws
from multimodal_tpu_torch.ops.bessel import bessel_iv_ratio, vmf_log_normalizer

_NEWTON_ITERS = 8
_MAX_KAPPA = 1e6


def solve_concentration(rbar: torch.Tensor, dim: int) -> torch.Tensor:
    """kappa such that A_d(kappa) = rbar: the Banerjee approximation, then Newton on A_d."""
    rbar = torch.clamp(rbar, 1e-6, 1.0 - 1e-6)
    d = float(dim)
    kappa = rbar * (d - rbar ** 2) / (1.0 - rbar ** 2)
    nu = d / 2.0 - 1.0
    for _ in range(_NEWTON_ITERS):
        a = bessel_iv_ratio(nu, kappa)
        da = 1.0 - a * a - (d - 1.0) / torch.clamp(kappa, min=1e-6) * a
        step = (a - rbar) / torch.where(da.abs() < 1e-12, torch.full_like(da, 1e-12), da)
        kappa = torch.clamp(kappa - step, 1e-4, _MAX_KAPPA)
    return kappa


def _vmf_log_prob(x: torch.Tensor, mu: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
    """[N, D] x [K, D] x [K] -> [N, K] log densities."""
    return vmf_log_normalizer(x.shape[-1], kappa)[None, :] + (x @ mu.T) * kappa[None, :]


@torch.no_grad()
def _em_step(x, weights, mus, kappas, n_components: int):
    """One EM iteration over unit vectors x [N, D]: (weights, mean directions,
    concentrations, the mean log-likelihood under the parameters it started from)."""
    log_w = torch.log(torch.clamp(weights, min=1e-12))
    log_p = _vmf_log_prob(x, mus, kappas) + log_w[None, :]  # [N, K]
    log_norm = torch.logsumexp(log_p, dim=1, keepdim=True)
    resp = torch.exp(log_p - log_norm)
    ll = log_norm.mean()
    nk = resp.sum(dim=0)
    new_weights = nk / x.shape[0]
    sums = resp.T @ x  # [K, D]
    norms = torch.linalg.vector_norm(sums, dim=1)
    new_mus = sums / torch.clamp(norms, min=1e-12)[:, None]
    rbar = norms / torch.clamp(nk, min=1e-12)
    return new_weights, new_mus, solve_concentration(rbar, x.shape[1]), ll


@torch.no_grad()
def _kmeanspp_init(generator: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding on cosine distance: the first center uniformly, each next one with
    probability proportional to 1 - (cosine to its nearest center), drawn by inverting the
    cumulative sum at total * (1 - u) (``jax.random.choice``'s rule)."""
    n = x.shape[0]
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[draws.randint(n, generator, x)]
    for i in range(1, k):
        best = (x @ centers[:i].T).max(dim=1).values
        dist = torch.clamp(1.0 - best, 0.0, 2.0)
        cum = torch.cumsum(dist / torch.clamp(dist.sum(), min=1e-12), dim=0)
        u = draws.uniform((), generator, x)
        choice = torch.searchsorted(cum, (cum[-1] * (1.0 - u))[None]).clamp(max=n - 1)
        centers[i] = x[choice[0]]
    return centers


def _unit_rows(x) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


@dataclass
class VMFMixtureEM:
    """EM fitter on ``device`` (the GPU unless the caller asks for ``"cpu"``). fit() returns
    self; the parameters in .weights / .mean_directions / .concentrations (numpy), the
    per-iteration mean log-likelihoods in .log_likelihoods_."""

    n_components: int = 2
    max_iter: int = 100
    tol: float = 1e-5
    seed: int = 0
    init_kappa: float = 10.0
    device: str = "cuda"
    weights: Optional[np.ndarray] = None
    mean_directions: Optional[np.ndarray] = None
    concentrations: Optional[np.ndarray] = None
    log_likelihoods_: list = field(default_factory=list)
    converged_: bool = False

    def _put(self, x) -> torch.Tensor:
        if torch.device(self.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("VMFMixtureEM(device='cuda'): no CUDA device is available; pass "
                               "device='cpu' to fit on the CPU")
        return torch.tensor(np.asarray(x, np.float32)).to(self.device)

    def fit(self, x: np.ndarray, init_means: Optional[np.ndarray] = None):
        """Fit to the rows of ``x`` (normalized here); ``init_means`` [K, D] replaces the
        k-means++ seeding."""
        xt = self._put(_unit_rows(x))
        if init_means is None:
            generator = torch.Generator(device=xt.device).manual_seed(self.seed)
            mus = _kmeanspp_init(generator, xt, self.n_components)
        else:
            mus = self._put(init_means)
        weights = torch.full((self.n_components,), 1.0 / self.n_components, device=xt.device)
        kappas = torch.full((self.n_components,), float(self.init_kappa), device=xt.device)

        self.log_likelihoods_ = []
        self.converged_ = False
        prev_ll = -np.inf
        for _ in range(self.max_iter):
            weights, mus, kappas, ll = _em_step(xt, weights, mus, kappas, self.n_components)
            ll = float(ll)
            self.log_likelihoods_.append(ll)
            if abs(ll - prev_ll) < self.tol:
                self.converged_ = True
                break
            prev_ll = ll

        self.weights = weights.cpu().numpy()
        self.mean_directions = mus.cpu().numpy()
        self.concentrations = kappas.cpu().numpy()
        return self

    @torch.no_grad()
    def _log_p(self, x) -> torch.Tensor:
        return (_vmf_log_prob(self._put(_unit_rows(x)), self._put(self.mean_directions),
                              self._put(self.concentrations))
                + torch.log(self._put(self.weights))[None, :])

    def log_likelihood(self, x: np.ndarray) -> float:
        return float(torch.logsumexp(self._log_p(x), dim=1).mean())

    def perplexity(self, x: np.ndarray) -> float:
        return float(np.exp(-self.log_likelihood(x)))

    def predict(self, x: np.ndarray) -> np.ndarray:
        return self._log_p(x).argmax(dim=1).cpu().numpy()

    def to_dict(self) -> dict:
        return {
            "weights": self.weights.tolist(),
            "mean_directions": self.mean_directions.tolist(),
            "concentrations": self.concentrations.tolist(),
            "log_likelihoods": self.log_likelihoods_,
            "converged": self.converged_,
        }


def fit_von_mises_fisher_mixture(x, n_components: int = 2, **kw) -> VMFMixtureEM:
    """Fit a ``VMFMixtureEM`` of ``n_components`` to ``x``; ``kw`` go to the fitter."""
    return VMFMixtureEM(n_components=n_components, **kw).fit(x)
