"""The port's sphere and Bessel ops against the JAX package's (``multimodal_tpu/ops/sphere.py``
and ``ops/bessel.py``), on the same numpy inputs.

Tolerances are ``tests/test_bessel.py``'s: ``log_iv`` values and gradients 2e-4 (rtol and
atol), ``bessel_iv_ratio`` rtol 1e-5 / atol 1e-6, and the vMF log-normalizer's gradient
1e-4 / 1e-5; the geometry holds 1e-6, ``riemannian_grad``'s forward bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import bessel as jbessel
from multimodal_tpu.ops import sphere as jsphere
from multimodal_tpu_torch.ops import bessel, draws, sphere

torch.set_num_threads(1)

ORDERS = [0.0, 0.5, 1.0, 4.0, 24.0, 63.0, 255.0]
ARGS = [1e-3, 0.1, 1.0, 5.0, 20.0, 100.0, 1e3, 1e4]


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


@pytest.mark.parametrize("v", ORDERS)
def test_log_iv_and_its_gradient_match_jax(v):
    z = np.array(ARGS, np.float32)
    want = np.asarray(jbessel.log_iv(jnp.float32(v), jnp.asarray(z)))
    want_grad = np.asarray(jax.vmap(jax.grad(lambda zz: jbessel.log_iv(jnp.float32(v), zz)))(
        jnp.asarray(z)))
    zt = _t(z, grad=True)
    got = bessel.log_iv(v, zt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(zt.grad.numpy(), want_grad, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("v", ORDERS)
def test_bessel_ratio_matches_jax(v):
    z = np.array(ARGS + [0.0], np.float32)
    want = np.asarray(jbessel.bessel_iv_ratio(jnp.float32(v), jnp.asarray(z)))
    got = bessel.bessel_iv_ratio(v, _t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert got[-1] == 0.0 and np.all(got >= 0.0) and np.all(got < 1.0)


def test_log_iv_branches_and_zero_argument_match_jax():
    """Every branch of the choice (uniform for v >= 4, the series for z <= 12, Hankel
    otherwise) and z = 0, where log I_0 = 0 and log I_v = -inf."""
    v = np.array([0.0, 0.5, 3.9, 3.9, 4.0, 2.0, 0.0, 7.0], np.float32)
    z = np.array([0.0, 0.0, 11.9, 12.1, 0.3, 50.0, 3.0, 0.0], np.float32)
    want = np.asarray(jbessel._log_iv_raw(jnp.asarray(v), jnp.asarray(z)))
    got = bessel.log_iv(_t(v), _t(z)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert got[0] == 0.0 and got[-1] == -np.inf


@pytest.mark.parametrize("d", [3, 10, 128, 512])
def test_vmf_log_normalizer_and_gradient_match_jax(d):
    kappa = np.array([0.0, 1e-7, 0.5, 5.0, 50.0, 500.0, 1e4, 1e12], np.float32)
    want = np.asarray(jbessel.vmf_log_normalizer(d, jnp.asarray(kappa)))
    want_grad = np.asarray(jax.vmap(jax.grad(lambda k: jbessel.vmf_log_normalizer(d, k)))(
        jnp.asarray(kappa)))
    kt = _t(kappa, grad=True)
    got = bessel.vmf_log_normalizer(d, kt)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(kt.grad.numpy(), want_grad, rtol=1e-4, atol=1e-5)
    # below kappa = 1e-6 the uniform density's, with no gradient
    area = float(jsphere.log_sphere_surface_area(d))
    np.testing.assert_allclose(got[:2].detach().numpy(), -area, rtol=1e-6)
    assert np.all(kt.grad.numpy()[:2] == 0.0) and np.all(np.isfinite(kt.grad.numpy()))


def test_log_iv_gradient_broadcasts_back_to_z():
    zt = _t([[2.0], [30.0]], grad=True)
    out = bessel.log_iv(_t([1.0, 10.0, 100.0]), zt)
    out.sum().backward()
    assert out.shape == (2, 3) and zt.grad.shape == (2, 1)
    want = jax.grad(lambda zz: jbessel.log_iv(jnp.array([1.0, 10.0, 100.0]), zz).sum())(
        jnp.array([[2.0], [30.0]]))
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dim", [2, 3, 64, 512])
def test_log_sphere_surface_area_matches_jax(dim):
    np.testing.assert_allclose(float(sphere.log_sphere_surface_area(dim)),
                               float(jsphere.log_sphere_surface_area(dim)), rtol=1e-6)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_riemannian_grad_is_the_identity_with_a_tangent_backward():
    rng = np.random.default_rng(0)
    mu = _unit_rows(rng, 5, 16)
    g = rng.standard_normal((5, 16)).astype(np.float32)
    mt = _t(mu, grad=True)
    out = sphere.riemannian_grad(mt)
    assert torch.equal(out, _t(mu))  # bit for bit
    out.backward(_t(g))
    _, vjp = jax.vjp(jsphere.riemannian_grad, jnp.asarray(mu))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(mt.grad.numpy(), want, atol=1e-6)
    # the projected cotangent is tangent at mu
    np.testing.assert_allclose((mt.grad.numpy() * mu).sum(-1), 0.0, atol=1e-6)


def _value_and_grads(jfn, tfn, *arrays, cot):
    """(port value, JAX value, port grads, JAX grads) of fn(*arrays) with cotangent cot."""
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    want_grads = vjp(jnp.asarray(cot))
    leaves = [_t(a, grad=True) for a in arrays]
    got = tfn(*leaves)
    got.backward(_t(cot))
    return (got.detach().numpy(), np.asarray(want), [x.grad.numpy() for x in leaves],
            [np.asarray(w) for w in want_grads])


def test_householder_rotation_matches_jax_at_degenerate_means():
    """mu == e1 is the identity; its gradient stays finite through the double where."""
    rng = np.random.default_rng(1)
    d = 8
    mu = _unit_rows(rng, 4, d)
    mu[1] = np.eye(d, dtype=np.float32)[0]  # degenerate
    x = _unit_rows(rng, 4, d)
    cot = rng.standard_normal((4, d)).astype(np.float32)
    got, want, grads, want_grads = _value_and_grads(jsphere.householder_rotation,
                                                    sphere.householder_rotation, x, mu, cot=cot)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[1], x[1], atol=1e-7)
    for g, w in zip(grads, want_grads):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, atol=1e-6)
    # e1 maps onto mu
    e1 = np.tile(np.eye(d, dtype=np.float32)[:1], (4, 1))
    np.testing.assert_allclose(sphere.householder_rotation(_t(e1), _t(mu)).numpy(), mu,
                               atol=1e-6)


def test_exponential_map_and_tangent_project_match_jax():
    rng = np.random.default_rng(2)
    mu = _unit_rows(rng, 4, 8)
    v = sphere.tangent_project(_t(rng.standard_normal((4, 8))), _t(mu)).numpy() * 0.3
    np.testing.assert_allclose(
        v, np.asarray(jsphere.tangent_project(jnp.asarray(v / 0.3), jnp.asarray(mu))) * 0.3,
        atol=1e-6)
    v[2] = 0.0  # the v == 0 guard
    cot = rng.standard_normal((4, 8)).astype(np.float32)
    got, want, grads, want_grads = _value_and_grads(jsphere.exponential_map,
                                                    sphere.exponential_map, mu, v, cot=cot)
    np.testing.assert_allclose(got, want, atol=1e-6)
    np.testing.assert_allclose(got[2], mu[2], atol=0)
    for g, w in zip(grads, want_grads):
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, atol=1e-6)


def test_l2_normalize_and_uniform_sphere_match_jax(monkeypatch):
    """With JAX's normal draws replayed through the draw helper, the uniform directions are
    JAX's."""
    key = jax.random.PRNGKey(3)
    want = np.asarray(jsphere.sample_uniform_sphere(key, (6, 5)))
    normals = np.asarray(jax.random.normal(key, (6, 5)))
    monkeypatch.setattr(draws, "standard_normal",
                        lambda shape, generator, like: _t(normals).to(like.dtype))
    got = sphere.sample_uniform_sphere((6, 5), torch.Generator(), torch.zeros(()))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    x = np.array([[3.0, 4.0], [0.0, 0.0]], np.float32)
    np.testing.assert_allclose(sphere.l2_normalize(_t(x)).numpy(),
                               np.asarray(jsphere.l2_normalize(jnp.asarray(x))), atol=0)


def test_draws_come_from_the_generator_alone():
    """The same seed gives the same draws, whatever the global generator's state."""
    def run():
        g = torch.Generator().manual_seed(7)
        like = torch.zeros((), dtype=torch.float32)
        torch.manual_seed(np.random.randint(1 << 30))
        alpha = torch.full((3,), 4.0)
        return (draws.standard_normal((4,), g, like), draws.uniform((4,), g, like, low=1e-20),
                draws.beta(alpha, alpha, g))
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
