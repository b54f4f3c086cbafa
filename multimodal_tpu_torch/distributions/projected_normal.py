"""An isotropic Gaussian radially projected onto S^{d-1} (port of
``multimodal_tpu/distributions/projected_normal.py``). As in the reference, ``rsample`` is
exact, and ``log_prob`` and ``entropy`` are its approximations: a Gaussian-quadratic form in
mu^T x, and the entropy of the underlying normal."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from multimodal_tpu_torch.ops import draws
from multimodal_tpu_torch.ops.sphere import l2_normalize, log_sphere_surface_area


@dataclass
class ProjectedNormal:
    mu: torch.Tensor  # [..., d], not necessarily unit norm
    sigma: torch.Tensor  # [..., d] or broadcastable: the underlying normal's std

    @property
    def dim(self) -> int:
        return self.mu.shape[-1]

    @property
    def loc(self) -> torch.Tensor:
        return l2_normalize(self.mu)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    def rsample(self, generator: torch.Generator, sample_shape=()) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.mu.shape)
        return l2_normalize(self.mu + self.sigma * draws.standard_normal(shape, generator, self.mu))

    sample = rsample

    def log_prob(self, value: torch.Tensor) -> torch.Tensor:
        value = l2_normalize(value)
        sigma = self.sigma.expand(self.mu.shape)
        mu_norm_sq = self.mu.square().sum(dim=-1, keepdim=True)
        dot = (self.mu * value).sum(dim=-1, keepdim=True)
        inv_var = 1.0 / sigma.square()
        exponent = (-0.5 * (mu_norm_sq * inv_var).sum(dim=-1)
                    + 0.5 * (dot.square() * inv_var).sum(dim=-1))
        log_norm = -0.5 * self.dim * math.log(2.0 * math.pi) - torch.log(sigma).sum(dim=-1)
        return log_norm + exponent

    def entropy(self) -> torch.Tensor:
        sigma = self.sigma.expand(self.mu.shape)
        return 0.5 * self.dim * (1.0 + math.log(2.0 * math.pi)) + torch.log(sigma).sum(dim=-1)

    def kl_uniform(self) -> torch.Tensor:
        """The entropy-proxy KL to the uniform sphere, as for the spherical families."""
        area = log_sphere_surface_area(self.dim, dtype=self.mu.dtype).to(self.mu.device)
        return -self.entropy() + area
