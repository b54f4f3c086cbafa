"""Distributions on the unit sphere and the diagonal normal, for the variational CLIP loss
(port of ``multimodal_tpu/distributions``). Each is a plain class holding tensors; every
sampler takes an explicit ``torch.Generator``."""

from multimodal_tpu_torch.distributions.hyperspherical_uniform import HypersphericalUniform
from multimodal_tpu_torch.distributions.normal import NormalDiag
from multimodal_tpu_torch.distributions.power_spherical import PowerSpherical
from multimodal_tpu_torch.distributions.projected_normal import ProjectedNormal
from multimodal_tpu_torch.distributions.von_mises_fisher import VonMisesFisher

__all__ = ["HypersphericalUniform", "NormalDiag", "PowerSpherical", "ProjectedNormal",
           "VonMisesFisher"]
