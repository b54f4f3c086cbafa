"""Every raw random draw of the port's samplers, each in one small function.

The JAX package draws from ``jax.random`` keys; the port draws from an explicit
``torch.Generator`` and never from global state. Each draw happens on the generator's device
and moves to the device of the tensor it serves. Keeping the draws here, apart from the
arithmetic that consumes them, lets a test hand the samplers JAX's own draws and hold the
rest of each sampler to the reference value for value and gradient for gradient.
"""

from __future__ import annotations

import torch


def standard_normal(shape, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """N(0, 1) draws of ``shape`` in ``like``'s dtype, on ``like``'s device."""
    out = torch.randn(shape, generator=generator, device=generator.device, dtype=like.dtype)
    return out.to(like.device)


def uniform(shape, generator: torch.Generator, like: torch.Tensor,
            low: float = 0.0) -> torch.Tensor:
    """U(low, 1) draws of ``shape`` in float32, on ``like``'s device."""
    u = torch.rand(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (low + (1.0 - low) * u).to(like.device)


def standard_gamma(alpha: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Gamma(alpha, 1) draws of ``alpha``'s shape, differentiable in ``alpha`` by the
    reparameterized (implicit) gamma gradient, as ``jax.random.gamma``'s is."""
    return torch._standard_gamma(alpha.to(generator.device), generator=generator).to(alpha.device)


def beta(a: torch.Tensor, b: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Beta(a, b) draws as ``jax.random.beta`` makes them: two gamma draws, a first, and
    ga / (ga + gb), so the pathwise gradient runs through both gammas."""
    ga = standard_gamma(a, generator)
    gb = standard_gamma(b, generator)
    return ga / (ga + gb)
