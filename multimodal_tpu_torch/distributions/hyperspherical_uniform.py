"""The uniform distribution on S^{dim-1}, ``dim`` the ambient dimension (port of
``multimodal_tpu/distributions/hyperspherical_uniform.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from multimodal_tpu_torch.ops.sphere import log_sphere_surface_area, sample_uniform_sphere


@dataclass
class HypersphericalUniform:
    dim: int

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        area = log_sphere_surface_area(self.dim, dtype=x.dtype).to(x.device)
        return (-area).expand(x.shape[:-1])

    def entropy(self) -> torch.Tensor:
        return log_sphere_surface_area(self.dim)

    def rsample(self, generator: torch.Generator, sample_shape=()) -> torch.Tensor:
        """float32 draws of ``sample_shape + (dim,)`` on the generator's device."""
        return sample_uniform_sphere(tuple(sample_shape) + (self.dim,), generator,
                                     torch.empty((), device=generator.device))

    sample = rsample
