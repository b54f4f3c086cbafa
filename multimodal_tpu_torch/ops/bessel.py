"""log I_v(z), the Bessel ratio I_{v+1}/I_v and the von Mises-Fisher log-normalizer (port of
``multimodal_tpu/ops/bessel.py``), plain torch on any device.

``log_iv`` is evaluated by region, as in the reference: the uniform asymptotic expansion in
the order (DLMF 10.41.3) for v >= 4, the ascending series (DLMF 10.25.2) for small z, and the
Hankel large-argument expansion (DLMF 10.40.1) otherwise. Its derivative in z is the exact
identity d/dz log I_v(z) = v/z + I_{v+1}(z)/I_v(z): the reference's ``jax.custom_jvp``
becomes the ``torch.autograd.Function`` ``LogIv``. The ratio comes from the same seeded
downward recurrence with a fixed 64 steps.
"""

from __future__ import annotations

import math

import torch

from multimodal_tpu_torch.ops.sphere import log_sphere_surface_area

_SERIES_TERMS = 32
_CF_ITERS = 64


def _log_iv_uniform(v, z):
    """DLMF 10.41 uniform asymptotic expansion of log I_v(v*w) for large order v."""
    w = z / v
    s = torch.sqrt(1.0 + w * w)
    t = 1.0 / s
    eta = s + torch.log(w) - torch.log1p(s)
    t2 = t * t
    # u_k(t) polynomials, DLMF 10.41.10
    u1 = t * (3.0 - 5.0 * t2) / 24.0
    u2 = t2 * (81.0 - t2 * (462.0 - 385.0 * t2)) / 1152.0
    u3 = (t * t2 * (30375.0 - t2 * (369603.0 - t2 * (765765.0 - 425425.0 * t2)))
          / 414720.0)
    u4 = (t2 * t2
          * (4465125.0
             - t2 * (94121676.0 - t2 * (349922430.0 - t2 * (446185740.0 - 185910725.0 * t2))))
          / 39813120.0)
    series = 1.0 + u1 / v + u2 / (v * v) + u3 / (v ** 3) + u4 / (v ** 4)
    return (v * eta - 0.5 * torch.log(2.0 * math.pi * v) - 0.25 * torch.log1p(w * w)
            + torch.log(torch.clamp(series, min=1e-30)))


def _log_iv_series(v, z):
    """Ascending series: I_v(z) = (z/2)^v * sum_k (z^2/4)^k / (k! Gamma(v+k+1))."""
    half_z2 = z.square() / 4.0
    log_half_z2 = torch.log(torch.clamp(half_z2, min=1e-30))
    k = torch.arange(_SERIES_TERMS, dtype=z.dtype, device=z.device)
    vk = v[..., None] + k
    terms = k * log_half_z2[..., None] - torch.lgamma(k + 1.0) - torch.lgamma(vk + 1.0)
    return v * torch.log(torch.clamp(z, min=1e-30) / 2.0) + torch.logsumexp(terms, dim=-1)


def _log_iv_hankel(v, z):
    """Large-argument expansion: I_v(z) ~ e^z / sqrt(2 pi z) * (1 - (mu-1)/(8z) + ...)."""
    mu = 4.0 * v * v
    i8z = 1.0 / (8.0 * z)
    a1 = -(mu - 1.0) * i8z
    a2 = (mu - 1.0) * (mu - 9.0) * i8z * i8z / 2.0
    a3 = -(mu - 1.0) * (mu - 9.0) * (mu - 25.0) * i8z ** 3 / 6.0
    series = 1.0 + a1 + a2 + a3
    return z - 0.5 * torch.log(2.0 * math.pi * z) + torch.log(torch.clamp(series, min=1e-30))


def _operands(v, z):
    """v and z as tensors of one floating dtype (at least float32), broadcast together."""
    z = torch.as_tensor(z)
    dtype = torch.promote_types(z.dtype if z.is_floating_point() else torch.float32,
                                torch.float32)
    z = z.to(dtype)
    v = torch.as_tensor(v, dtype=dtype, device=z.device)
    return torch.broadcast_tensors(v, z)


def _log_iv_raw(v, z):
    v, z = _operands(v, z)
    zs = torch.clamp(z, min=1e-30)  # every branch NaN-free; z == 0 is handled at the end
    use_uniform = v >= 4.0
    use_series = ~use_uniform & (zs <= 12.0)
    out = torch.where(use_uniform, _log_iv_uniform(torch.clamp(v, min=1.0), zs),
                      torch.where(use_series, _log_iv_series(v, zs), _log_iv_hankel(v, zs)))
    # I_0(0) = 1, I_v(0) = 0 for v > 0
    at_zero = torch.where(v == 0.0, torch.zeros_like(out), torch.full_like(out, -math.inf))
    return torch.where(z <= 0.0, at_zero, out)


def bessel_iv_ratio(v, z) -> torch.Tensor:
    """I_{v+1}(z) / I_v(z) for v, z >= 0, in [0, 1).

    The ratio at the boosted order m = v + 64 is seeded from the derivative of the uniform
    asymptotic expansion, then recurs down 64 steps with R_{k-1} = z / (2k + z R_k), the
    stable direction for this minimal solution, which contracts the seed's error every step."""
    v, z = _operands(v, z)
    zs = torch.clamp(z, min=1e-30)
    m = v + _CF_ITERS
    w = zs / m
    s = torch.sqrt(1.0 + w * w)
    t = 1.0 / s
    t2 = t * t
    # R_m ~ w/(1+s) - w t^2 / (2m) - u1'(t) w t^3 / m^2,  u1'(t) = (3 - 15 t^2)/24
    r = w / (1.0 + s) - w * t2 / (2.0 * m) - (3.0 - 15.0 * t2) / 24.0 * w * t2 * t / (m * m)
    for i in range(_CF_ITERS):
        r = zs / (2.0 * (m - i) + zs * r)  # orders m, m-1, ..., v+1
    return torch.where(z <= 0.0, torch.zeros_like(r), torch.clamp(r, 0.0, 1.0))


class LogIv(torch.autograd.Function):
    """log I_v(z), differentiable in z; the order v is a constant."""

    @staticmethod
    def forward(ctx, v, z):
        ctx.save_for_backward(z)
        ctx.v = v
        return _log_iv_raw(v, z)

    @staticmethod
    def backward(ctx, g):
        (z,) = ctx.saved_tensors
        v, zb = _operands(ctx.v, z)
        dz = v / torch.clamp(zb, min=1e-30) + bessel_iv_ratio(v, zb)
        # summed back over what broadcasting against v added to z
        return None, (dz * g).sum_to_size(z.shape).to(z.dtype)


def log_iv(v, z) -> torch.Tensor:
    """log I_v(z); ``v`` a number or a tensor held constant, ``z`` a tensor."""
    return LogIv.apply(v, torch.as_tensor(z))


def vmf_log_normalizer(dim: int, kappa) -> torch.Tensor:
    """log C_d(kappa) of the von Mises-Fisher density on S^{d-1},
    C_d(k) = k^{d/2-1} / ((2 pi)^{d/2} I_{d/2-1}(k)); its gradient in kappa is
    -I_{d/2}(k)/I_{d/2-1}(k), through ``log_iv``'s backward. Below kappa = 1e-6 it is the
    uniform density's, -log area(S^{d-1})."""
    kappa = torch.as_tensor(kappa)
    kappa = kappa.to(torch.promote_types(
        kappa.dtype if kappa.is_floating_point() else torch.float32, torch.float32))
    half_dim = dim / 2.0
    nu = half_dim - 1.0
    small = kappa < 1e-6
    safe_kappa = torch.where(small, torch.ones_like(kappa), kappa)
    out = (nu * torch.log(safe_kappa) - half_dim * math.log(2.0 * math.pi)
           - log_iv(nu, safe_kappa))
    uniform = -log_sphere_surface_area(dim, dtype=kappa.dtype).to(kappa.device)
    return torch.where(small, uniform.expand(out.shape), out)
