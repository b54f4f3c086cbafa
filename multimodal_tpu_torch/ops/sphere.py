"""Unit-sphere geometry shared by the spherical distributions and the vCLIP loss (port of
``multimodal_tpu/ops/sphere.py``).

``riemannian_grad`` is the reference's ``jax.custom_vjp`` as a ``torch.autograd.Function``:
the identity forward, and a backward that projects the cotangent onto the tangent space of
the sphere at mu. ``householder_rotation`` and ``exponential_map`` keep the reference's
double-``where`` guards: ``torch.where``, like ``jnp.where``, passes a NaN from the branch it
does not select into the gradient, so the norm is taken over a vector that is nonzero on
every row.
"""

from __future__ import annotations

import math

import torch

from multimodal_tpu_torch.ops import draws


def log_sphere_surface_area(dim, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """log area(S^{dim-1}) = log(2 pi^{dim/2} / Gamma(dim/2)) for points in R^dim."""
    half = torch.as_tensor(dim, dtype=dtype) / 2.0
    return math.log(2.0) + half * math.log(math.pi) - torch.lgamma(half)


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=dim, keepdim=True), min=eps)


def sample_uniform_sphere(shape, generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    """Uniform samples on S^{shape[-1]-1} (normalized Gaussian draws), in ``like``'s dtype
    on its device."""
    return l2_normalize(draws.standard_normal(shape, generator, like))


def householder_rotation(x: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """Reflect samples drawn in a frame whose first axis is the mean direction onto ``mu``:
    H = I - 2 u u^T with u = normalize(e1 - mu), so H e1 = mu. Where mu == e1 the reflection
    is the identity. x [..., d]; mu [..., d] unit (broadcastable against x)."""
    e1 = torch.zeros_like(mu)
    e1[..., 0] = 1.0
    u = e1 - mu
    sq = u.square().sum(dim=-1, keepdim=True)
    safe = sq > 1e-12
    u_safe = torch.where(safe, u, e1)  # a nonzero stand-in on the degenerate rows
    norm = torch.linalg.vector_norm(u_safe, dim=-1, keepdim=True)
    u = torch.where(safe, u_safe / norm, torch.zeros_like(u))
    proj = (u * x).sum(dim=-1, keepdim=True)
    return x - 2.0 * proj * u


def tangent_project(grad: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    """``grad`` projected onto the tangent space of the sphere at ``mu``: g - (g . mu) mu."""
    radial = (grad * mu).sum(dim=-1, keepdim=True)
    return grad - radial * mu


class RiemannianGrad(torch.autograd.Function):
    """The identity on the (unit-norm) means whose backward keeps only the component of the
    cotangent tangent to the sphere at them."""

    @staticmethod
    def forward(ctx, mu):
        ctx.save_for_backward(mu)
        return mu.view_as(mu)

    @staticmethod
    def backward(ctx, g):
        (mu,) = ctx.saved_tensors
        return tangent_project(g, mu)


def riemannian_grad(mu: torch.Tensor) -> torch.Tensor:
    return RiemannianGrad.apply(mu)


def exponential_map(mu: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Walk from mu along the tangent vector v on the unit sphere; v == 0 gives mu."""
    sq = v.square().sum(dim=-1, keepdim=True)
    safe = sq > 1e-18
    v_safe = torch.where(safe, v, torch.ones_like(v))
    norm = torch.linalg.vector_norm(v_safe, dim=-1, keepdim=True)
    stepped = torch.cos(norm) * mu + torch.sin(norm) * v_safe / norm
    return torch.where(safe, stepped, mu)
