"""The von Mises-Fisher distribution with a fixed-round rejection sampler (port of
``multimodal_tpu/distributions/von_mises_fisher.py``).

The log-normalizer is ``vmf_log_normalizer`` (log-Bessel with the derivative
-I_{d/2}/I_{d/2-1}). Wood's (1994) sampler runs a fixed 32 batched proposal rounds with
acceptance masking; a lane that never accepts keeps the envelope's mode. ``rsample`` is
reparameterized through the tangent direction only: the radial cosine is detached, as in
the reference.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from multimodal_tpu_torch.ops import draws
from multimodal_tpu_torch.ops.bessel import bessel_iv_ratio, vmf_log_normalizer
from multimodal_tpu_torch.ops.sphere import (
    householder_rotation,
    log_sphere_surface_area,
    sample_uniform_sphere,
)

_REJECTION_ROUNDS = 32


def wood_round_draws(shape, dm1: float, generator: torch.Generator, like: torch.Tensor):
    """One proposal round's raw draws: the Beta((d-1)/2, (d-1)/2) proposal, then the
    acceptance uniform on (1e-20, 1); both float32 of ``shape`` on ``like``'s device."""
    half = torch.full(shape, dm1 / 2.0, dtype=torch.float32, device=like.device)
    z = draws.beta(half, half, generator)
    return z, draws.uniform(shape, generator, like, low=1e-20)


@dataclass
class VonMisesFisher:
    loc: torch.Tensor  # [..., d] unit mean directions
    scale: torch.Tensor  # [...] concentration kappa > 0

    @property
    def dim(self) -> int:
        return self.loc.shape[-1]

    def log_normalizer(self) -> torch.Tensor:
        return vmf_log_normalizer(self.dim, self.scale)

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return self.log_normalizer() + self.scale * (self.loc * x).sum(dim=-1)

    @property
    def mode(self) -> torch.Tensor:
        return self.loc

    def mean_resultant_length(self) -> torch.Tensor:
        """A_d(kappa) = I_{d/2}(kappa) / I_{d/2-1}(kappa) = |E[x]|."""
        return bessel_iv_ratio(self.dim / 2.0 - 1.0, self.scale)

    @property
    def mean(self) -> torch.Tensor:
        return self.loc * self.mean_resultant_length()[..., None]

    def entropy(self) -> torch.Tensor:
        """H = -log C_d(kappa) - kappa A_d(kappa)."""
        return -self.log_normalizer() - self.scale * self.mean_resultant_length()

    def kl_uniform(self) -> torch.Tensor:
        area = log_sphere_surface_area(self.dim, dtype=self.loc.dtype).to(self.loc.device)
        return -self.entropy() + area

    @torch.no_grad()
    def _sample_w(self, generator: torch.Generator, shape) -> torch.Tensor:
        """Wood's rejection sampling of the cosine w = mu^T x, 32 masked rounds."""
        kappa = torch.clamp(self.scale.expand(shape).to(torch.float32), max=1e8)
        dm1 = self.dim - 1.0
        sq = torch.sqrt(4.0 * kappa * kappa + dm1 * dm1)
        b = dm1 / (sq + 2.0 * kappa)  # the stable form of (-2k + sqrt(4k^2 + (d-1)^2))/(d-1)
        x0 = (1.0 - b) / (1.0 + b)
        c = kappa * x0 + dm1 * torch.log(torch.clamp(1.0 - x0 * x0, min=1e-30))
        w = x0.clone()  # the fallback: the mode of the proposal envelope
        accepted = torch.zeros(shape, dtype=torch.bool, device=kappa.device)
        for _ in range(_REJECTION_ROUNDS):
            z, u = wood_round_draws(shape, dm1, generator, kappa)
            w_prop = (1.0 - (1.0 + b) * z) / (1.0 - (1.0 - b) * z)
            accept = (kappa * w_prop + dm1 * torch.log(torch.clamp(1.0 - x0 * w_prop, min=1e-30))
                      - c) >= torch.log(u)
            w = torch.where(accept & ~accepted, w_prop, w)
            accepted |= accept
        return torch.clamp(w, -1.0 + 1e-7, 1.0 - 1e-7)

    def rsample(self, generator: torch.Generator, sample_shape=()) -> torch.Tensor:
        """Draws of ``sample_shape + loc.shape``: the rounds' draws first, then the tangent
        direction."""
        shape = tuple(sample_shape) + tuple(self.scale.shape)
        w = self._sample_w(generator, shape).to(self.loc.dtype)
        v = sample_uniform_sphere(shape + (self.dim - 1,), generator, self.loc)
        y = torch.cat([w[..., None], torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))[..., None] * v],
                      dim=-1)
        return householder_rotation(y, self.loc.expand(shape + (self.dim,)))

    sample = rsample
