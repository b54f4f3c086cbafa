"""JAX's raw random draws, replayed through the port's draw helpers (not a test module).

The JAX samplers draw from keys, the port's from a ``torch.Generator`` through
``multimodal_tpu_torch.ops.draws`` and ``distributions.von_mises_fisher.wood_round_draws``.
``Replay`` walks a JAX key down the reference's own split schedule, queues the draws JAX makes
there, and hands them to the port in the order the port asks for them, so that a port
sampler and its JAX counterpart see the same numbers. A gamma draw carries JAX's derivative
in alpha with it (``jax.jvp`` of ``jax.random.loggamma``), so the pathwise gradient through
it is JAX's too; everything downstream of the draws is the port's own arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodal_tpu_torch.distributions import von_mises_fisher
from multimodal_tpu_torch.ops import draws


class _Replayed(torch.autograd.Function):
    """``value`` in the forward; ``dvalue`` times the cotangent for ``alpha`` in the backward."""

    @staticmethod
    def forward(ctx, alpha, value, dvalue):
        ctx.save_for_backward(dvalue)
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        (dvalue,) = ctx.saved_tensors
        return g * dvalue, None, None


def jax_gamma(key, alpha: np.ndarray):
    """(sample, d sample / d alpha) of ``jax.random.loggamma`` exponentiated, elementwise."""
    alpha = jnp.asarray(alpha, jnp.float32)
    f = lambda a: jnp.exp(jax.random.loggamma(key, a, alpha.shape))  # noqa: E731
    value, dvalue = jax.jvp(f, (alpha,), (jnp.ones_like(alpha),))
    return np.asarray(value), np.asarray(dvalue)


class Replay:
    """Queues of JAX draws, consumed in order by the patched port helpers."""

    def __init__(self):
        self.normals, self.gammas, self.rounds = [], [], []

    # --- queueing, each on the reference's split schedule -------------------------------
    def normal(self, key, shape):
        self.normals.append(np.asarray(jax.random.normal(key, shape, jnp.float32)))

    def beta(self, key, a: np.ndarray, b: np.ndarray):
        """jax.random.beta's draws: its key splits into the two gammas' keys, a first."""
        key_a, key_b = jax.random.split(key)
        self.gammas.append(jax_gamma(key_a, a))
        self.gammas.append(jax_gamma(key_b, b))

    def power_spherical(self, key, alpha: np.ndarray, beta_dim: float, dim: int):
        """PowerSpherical.rsample(key): k_beta, k_dir = split(key)."""
        k_beta, k_dir = jax.random.split(key)
        self.beta(k_beta, alpha, np.full_like(alpha, beta_dim))
        self.normal(k_dir, alpha.shape + (dim - 1,))

    def von_mises_fisher(self, key, shape, dim: int, rounds: int = 32):
        """VonMisesFisher.sample(key): k_w, k_dir = split(key); round i splits the running
        key into (key, k_beta, k_u)."""
        k_w, k_dir = jax.random.split(key)
        half = (dim - 1.0) / 2.0
        key = k_w
        for _ in range(rounds):
            key, k_beta, k_u = jax.random.split(key, 3)
            z = jax.random.beta(k_beta, half, half, shape=shape)
            u = jax.random.uniform(k_u, shape, minval=1e-20, maxval=1.0)
            self.rounds.append((np.asarray(z), np.asarray(u)))
        self.normal(k_dir, tuple(shape) + (dim - 1,))

    # --- the port's helpers -------------------------------------------------------------
    def _standard_normal(self, shape, generator, like):
        value = self.normals.pop(0)
        assert value.shape == tuple(shape), (value.shape, shape)
        return torch.from_numpy(value).to(like.device, like.dtype)

    def _standard_gamma(self, alpha, generator):
        value, dvalue = self.gammas.pop(0)
        assert value.shape == tuple(alpha.shape), (value.shape, alpha.shape)
        return _Replayed.apply(alpha, torch.from_numpy(value).to(alpha.device),
                               torch.from_numpy(dvalue).to(alpha.device))

    def _wood_round_draws(self, shape, dm1, generator, like):
        z, u = self.rounds.pop(0)
        assert z.shape == tuple(shape), (z.shape, shape)
        return torch.from_numpy(z).to(like.device), torch.from_numpy(u).to(like.device)

    def install(self, monkeypatch):
        monkeypatch.setattr(draws, "standard_normal", self._standard_normal)
        monkeypatch.setattr(draws, "standard_gamma", self._standard_gamma)
        monkeypatch.setattr(von_mises_fisher, "wood_round_draws", self._wood_round_draws)
        return self

    def assert_consumed(self):
        assert not (self.normals or self.gammas or self.rounds), "draws left unconsumed"
