"""The diagonal normal of the Gaussian mode of the variational CLIP loss (port of
``multimodal_tpu/distributions/normal.py``)."""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from multimodal_tpu_torch.ops import draws


@dataclass
class NormalDiag:
    loc: torch.Tensor  # [..., d]
    scale: torch.Tensor  # [..., d] standard deviations

    def rsample(self, generator: torch.Generator, sample_shape=()) -> torch.Tensor:
        shape = tuple(sample_shape) + tuple(self.loc.shape)
        return self.loc + self.scale * draws.standard_normal(shape, generator, self.loc)

    sample = rsample

    @property
    def mean(self) -> torch.Tensor:
        return self.loc

    mode = mean

    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        var = self.scale.square()
        return -0.5 * (math.log(2.0 * math.pi) + torch.log(var) + (x - self.loc).square() / var)

    def entropy(self) -> torch.Tensor:
        return 0.5 * (1.0 + math.log(2.0 * math.pi)) + torch.log(self.scale)

    def kl_standard_normal(self) -> torch.Tensor:
        """KL(N(mu, sigma^2) || N(0, 1)) per dimension."""
        var = self.scale.square()
        return 0.5 * (var + self.loc.square() - 1.0 - torch.log(var))
