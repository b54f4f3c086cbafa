"""The Power Spherical distribution (De Cao & Aziz, 2020), exactly reparameterizable (port
of ``multimodal_tpu/distributions/power_spherical.py``). Density on S^{d-1}:

    p(x; mu, kappa) = N(kappa, d)^{-1} (1 + mu^T x)^kappa

with log N = (alpha + beta) log 2 + beta log pi + lgamma(alpha) - lgamma(alpha + beta),
alpha = (d-1)/2 + kappa, beta = (d-1)/2. A draw is t = 2 Z - 1 with Z ~ Beta(alpha, beta),
made from two gamma draws as ``jax.random.beta`` makes it, a uniform tangent direction on
S^{d-2}, and a Householder reflection onto mu, all differentiable in mu and kappa.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from multimodal_tpu_torch.ops import draws
from multimodal_tpu_torch.ops.sphere import (
    householder_rotation,
    log_sphere_surface_area,
    sample_uniform_sphere,
)


@dataclass
class PowerSpherical:
    loc: torch.Tensor  # [..., d] unit mean directions
    scale: torch.Tensor  # [...] concentration kappa >= 0

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def _alpha_beta(self):
        beta = (self.dim - 1.0) / 2.0
        alpha = beta + self.scale
        return alpha, torch.full_like(alpha, beta)

    def log_normalizer(self) -> torch.Tensor:
        """-log N(kappa, d); log_prob = log_normalizer + kappa * log1p(mu^T x)."""
        alpha, beta = self._alpha_beta()
        return -((alpha + beta) * math.log(2.0) + beta * math.log(math.pi)
                 + torch.lgamma(alpha) - torch.lgamma(alpha + beta))

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        dot = (self.loc * x).sum(dim=-1)
        return self.log_normalizer() + self.scale * torch.log1p(torch.clamp(dot, -1.0 + 1e-7, 1.0))

    def rsample(self, generator: torch.Generator, sample_shape=()) -> torch.Tensor:
        """Draws of ``sample_shape + loc.shape``: the Beta draw first, then the tangent
        direction. The sampling path clamps kappa at 1e8, beyond which the float32 Beta
        draw saturates, and keeps t inside (-1, 1), where sqrt(1 - t^2) has a finite
        derivative; log_prob, entropy and the KL stay exact."""
        shape = tuple(sample_shape) + tuple(self.scale.shape)
        beta_dim = (self.dim - 1.0) / 2.0
        alpha = (beta_dim + torch.clamp(self.scale, max=1e8)).expand(shape)
        z = draws.beta(alpha, torch.full_like(alpha, beta_dim), generator)
        t = torch.clamp(2.0 * z - 1.0, -1.0 + 1e-6, 1.0 - 1e-6)
        v = sample_uniform_sphere(shape + (self.dim - 1,), generator, self.loc)
        y = torch.cat([t[..., None], torch.sqrt(torch.clamp(1.0 - t * t, min=0.0))[..., None] * v],
                      dim=-1)
        return householder_rotation(y, self.loc.expand(shape + (self.dim,)))

    sample = rsample

    @property
    def mean(self) -> torch.Tensor:
        alpha, beta = self._alpha_beta()
        return self.loc * ((alpha - beta) / (alpha + beta))[..., None]

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    def marginal_t_mean(self) -> torch.Tensor:
        """E[mu^T x] = (alpha - beta) / (alpha + beta)."""
        alpha, beta = self._alpha_beta()
        return (alpha - beta) / (alpha + beta)

    def entropy(self) -> torch.Tensor:
        alpha, beta = self._alpha_beta()
        log_norm = -self.log_normalizer()
        return log_norm - self.scale * (math.log(2.0) + torch.digamma(alpha)
                                        - torch.digamma(alpha + beta))

    def kl_uniform(self) -> torch.Tensor:
        """KL(PowerSpherical || HypersphericalUniform) in closed form: -entropy + log
        area(S^{d-1})."""
        area = log_sphere_surface_area(self.dim, dtype=self.loc.dtype).to(self.loc.device)
        return -self.entropy() + area
