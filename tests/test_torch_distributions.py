"""The port's distributions (``multimodal_tpu_torch/distributions``) against the JAX
package's, on the same numpy inputs.

Closed forms (log_prob, entropy, kl_uniform, mean, mode, the log-normalizer, the marginal
mean, the normal's KL) hold 1e-5 relative, with their gradients in the concentration, in
float64; float32 holds 1e-5 of the scale of the terms it rounds (see the test). The
samplers hold 1e-5 in value and in gradient with respect to loc and scale, with JAX's draws
replayed through the port's draw helpers (``torch_jax_replay``): the same split keys,
``k_beta`` then ``k_dir``, and ``loggamma`` for each gamma. The port's own gamma gradient
(torch's reparameterized one) is held to JAX's separately, at 2e-4 relative: the two are
different approximations of the same implicit derivative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.distributions import HypersphericalUniform as JUniform
from multimodal_tpu.distributions import PowerSpherical as JPowerSpherical
from multimodal_tpu.distributions import ProjectedNormal as JProjectedNormal
from multimodal_tpu.distributions import VonMisesFisher as JVonMisesFisher
from multimodal_tpu.distributions.normal import NormalDiag as JNormalDiag
from multimodal_tpu_torch.distributions import (
    HypersphericalUniform,
    NormalDiag,
    PowerSpherical,
    ProjectedNormal,
    VonMisesFisher,
)
from multimodal_tpu_torch.ops import draws
from torch_jax_replay import Replay, jax_gamma

torch.set_num_threads(1)

REL = dict(rtol=1e-5, atol=1e-6)
KAPPAS = np.array([0.5, 20.0, 500.0, 1e4], np.float32)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a, np.float32), requires_grad=grad)


def _unit_rows(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


CLOSED_FORMS = ["log_normalizer", "entropy", "kl_uniform", "log_prob", "mean", "mode"]


def _closed_forms(kind, mu, kappa, x, dtype):
    """{name: (port value, JAX value, port d/dkappa, JAX d/dkappa)} in ``dtype``; the
    gradients are vector-Jacobian products with one fixed cotangent."""
    jcls, tcls = {"power_spherical": (JPowerSpherical, PowerSpherical),
                  "vmf": (JVonMisesFisher, VonMisesFisher)}[kind]
    extra = ["marginal_t_mean"] if kind == "power_spherical" else ["mean_resultant_length"]
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    mu, kappa, x = (np.asarray(a, np_dt) for a in (mu, kappa, x))
    out = {}
    for name in CLOSED_FORMS + extra:
        def call(dist, xx, name=name):
            attr = getattr(dist, name)
            return attr(xx) if name == "log_prob" else attr() if callable(attr) else attr

        kt = torch.tensor(kappa, dtype=dtype, requires_grad=True)
        got = call(tcls(torch.tensor(mu, dtype=dtype), kt), torch.tensor(x, dtype=dtype))
        want, vjp = jax.vjp(lambda k: call(jcls(jnp.asarray(mu, jdt), k), jnp.asarray(x, jdt)),
                            jnp.asarray(kappa, jdt))
        cot = np.random.default_rng(len(name)).standard_normal(want.shape).astype(np_dt)
        if name == "mode":  # loc itself: no concentration in it
            out[name] = (got.detach().numpy(), np.asarray(want), None, None)
            continue
        got.backward(torch.tensor(cot, dtype=dtype))
        out[name] = (got.detach().numpy(), np.asarray(want), kt.grad.numpy(),
                     np.asarray(vjp(jnp.asarray(cot, jdt))[0]))
    return out


@pytest.mark.parametrize("d", [3, 10, 64, 512])
@pytest.mark.parametrize("kind", ["power_spherical", "vmf"])
def test_closed_forms_and_their_concentration_gradients_match_jax(kind, d):
    """In float64 every closed form and its gradient in kappa holds 1e-5 relative. In
    float32 both sides round lgamma, digamma and log I_v of terms up to ~1e4 (for
    d = 512 the log-normalizer's terms are ~900 even at kappa 0.5) and the KL subtracts
    such terms to near 0, so float32 is held at 1e-5 of the terms' scale, |log_normalizer|
    + kappa + 1, the same relative limit on the quantities that are rounded."""
    rng = np.random.default_rng(d)
    mu, x = _unit_rows(rng, len(KAPPAS), d), _unit_rows(rng, len(KAPPAS), d)
    with jax.enable_x64(True):
        wide = _closed_forms(kind, mu, KAPPAS, x, torch.float64)
    for name, (got, want, dgot, dwant) in wide.items():
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-12, err_msg=name)
        if dgot is not None:
            np.testing.assert_allclose(dgot, dwant, rtol=1e-5, atol=1e-12, err_msg=f"d{name}")
    narrow = _closed_forms(kind, mu, KAPPAS, x, torch.float32)
    terms = np.abs(narrow["log_normalizer"][1]) + KAPPAS + 1.0
    for name, (got, want, dgot, dwant) in narrow.items():
        scale = terms[:, None] if got.ndim == 2 else terms
        assert np.all(np.abs(got - want) <= 1e-5 * scale), name
        if dgot is not None:
            np.testing.assert_allclose(dgot, dwant, rtol=1e-4, atol=1e-5, err_msg=f"d{name}")


def test_normal_diag_closed_forms_match_jax():
    rng = np.random.default_rng(0)
    loc = rng.standard_normal((4, 6)).astype(np.float32)
    scale = np.exp(rng.standard_normal((4, 6))).astype(np.float32)
    x = rng.standard_normal((4, 6)).astype(np.float32)
    jd, td = JNormalDiag(jnp.asarray(loc), jnp.asarray(scale)), NormalDiag(_t(loc), _t(scale))
    np.testing.assert_allclose(td.log_prob(_t(x)).numpy(), np.asarray(jd.log_prob(x)), **REL)
    np.testing.assert_allclose(td.entropy().numpy(), np.asarray(jd.entropy()), **REL)
    np.testing.assert_allclose(td.kl_standard_normal().numpy(),
                               np.asarray(jd.kl_standard_normal()), **REL)
    assert td.mean is td.loc and td.mode is td.loc


def test_projected_normal_and_uniform_closed_forms_match_jax():
    rng = np.random.default_rng(1)
    mu = 3.0 * rng.standard_normal((4, 10)).astype(np.float32)
    sigma = np.full((4, 10), 0.5, np.float32)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    jd = JProjectedNormal(jnp.asarray(mu), jnp.asarray(sigma))
    td = ProjectedNormal(_t(mu), _t(sigma))
    for name in ("entropy", "kl_uniform"):
        np.testing.assert_allclose(getattr(td, name)().numpy(), np.asarray(getattr(jd, name)()),
                                   err_msg=name, **REL)
    np.testing.assert_allclose(td.log_prob(_t(x)).numpy(), np.asarray(jd.log_prob(x)), **REL)
    np.testing.assert_allclose(td.mean.numpy(), np.asarray(jd.mean), **REL)
    ju, tu = JUniform(10), HypersphericalUniform(10)
    np.testing.assert_allclose(tu.log_prob(_t(x)).numpy(), np.asarray(ju.log_prob(x)), **REL)
    np.testing.assert_allclose(float(tu.entropy()), float(ju.entropy()), rtol=1e-6)


def _rsample_grads(td, generator, sample_shape, cot, leaves):
    out = td.rsample(generator, sample_shape)
    out.backward(_t(cot))
    return out.detach().numpy(), [None if t.grad is None else t.grad.numpy() for t in leaves]


@pytest.mark.parametrize("d,kappa", [(3, 2.0), (16, 20.0), (64, 200.0), (512, 1e8 * 10)])
def test_power_spherical_rsample_and_its_gradients_match_jax(monkeypatch, d, kappa):
    """Values and the gradients in loc and scale; at kappa above 1e8 the sampling path's
    clamp holds both sides (no scale gradient through the draw there)."""
    rng = np.random.default_rng(d)
    mu = _unit_rows(rng, 3, d)
    scale = np.array([kappa, kappa / 2, kappa * 1.5], np.float32)
    key = jax.random.PRNGKey(d)
    jfn = lambda m, k: JPowerSpherical(m, k).rsample(key, (5,))  # noqa: E731
    want, vjp = jax.vjp(jfn, jnp.asarray(mu), jnp.asarray(scale))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    replay = Replay().install(monkeypatch)
    alpha = np.broadcast_to((d - 1) / 2 + np.minimum(scale, 1e8), (5, 3)).astype(np.float32)
    replay.power_spherical(key, alpha, (d - 1) / 2, d)
    loc, kt = _t(mu, grad=True), _t(scale, grad=True)
    got, grads = _rsample_grads(PowerSpherical(loc, kt), torch.Generator(), (5,), cot, [loc, kt])
    replay.assert_consumed()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    for name, g, w in zip(("loc", "scale"), grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("d,kappa", [(3, 2.0), (64, 50.0), (512, 5000.0)])
def test_von_mises_fisher_rsample_matches_jax(monkeypatch, d, kappa):
    """Values and the gradient in loc; the radial cosine is detached on both sides, so the
    scale gets none."""
    rng = np.random.default_rng(d)
    mu = _unit_rows(rng, 3, d)
    scale = np.array([kappa, kappa / 2, kappa * 1.5], np.float32)
    key = jax.random.PRNGKey(d + 1)
    jfn = lambda m, k: JVonMisesFisher(m, k).rsample(key, (4,))  # noqa: E731
    want, vjp = jax.vjp(jfn, jnp.asarray(mu), jnp.asarray(scale))
    cot = rng.standard_normal(want.shape).astype(np.float32)
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(cot))]
    replay = Replay().install(monkeypatch)
    replay.von_mises_fisher(key, (4, 3), d)
    loc, kt = _t(mu, grad=True), _t(scale, grad=True)
    got, grads = _rsample_grads(VonMisesFisher(loc, kt), torch.Generator(), (4,), cot,
                                [loc, kt])
    replay.assert_consumed()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(grads[0], want_grads[0], rtol=1e-5, atol=1e-5)
    assert grads[1] is None and np.all(want_grads[1] == 0.0)


def test_normal_and_projected_normal_and_uniform_rsample_match_jax(monkeypatch):
    rng = np.random.default_rng(5)
    loc = rng.standard_normal((3, 6)).astype(np.float32)
    scale = np.exp(rng.standard_normal((3, 6))).astype(np.float32)
    key = jax.random.PRNGKey(5)
    cases = [
        (lambda m, s: JNormalDiag(m, s).rsample(key, (4,)), NormalDiag, (4, 3, 6)),
        (lambda m, s: JProjectedNormal(m, s).rsample(key, (4,)), ProjectedNormal, (4, 3, 6)),
    ]
    for jfn, tcls, shape in cases:
        want, vjp = jax.vjp(jfn, jnp.asarray(loc), jnp.asarray(scale))
        cot = rng.standard_normal(want.shape).astype(np.float32)
        replay = Replay().install(monkeypatch)
        replay.normal(key, shape)
        lt, st = _t(loc, grad=True), _t(scale, grad=True)
        got, grads = _rsample_grads(tcls(lt, st), torch.Generator(), (4,), cot, [lt, st])
        replay.assert_consumed()
        np.testing.assert_allclose(got, np.asarray(want), **REL)
        for g, w in zip(grads, vjp(jnp.asarray(cot))):
            np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5)
    replay = Replay().install(monkeypatch)
    replay.normal(key, (7, 6))
    got = HypersphericalUniform(6).rsample(torch.Generator(), (7,))
    np.testing.assert_allclose(got.numpy(), np.asarray(JUniform(6).sample(key, (7,))), atol=1e-6)


def test_the_ports_gamma_gradient_is_jaxs_within_2e_4():
    """torch's reparameterized gamma gradient and JAX's are two approximations of
    -(dF/dalpha)/(dF/dx); over the alphas the samplers meet ((d-1)/2 + kappa with kappa >= 10)
    they agree to 2e-4 relative at the same draws."""
    for i, a in enumerate([15.5, 31.5, 231.5, 455.5, 1255.5]):
        alpha = np.full((64,), a, np.float32)
        value, dvalue = jax_gamma(jax.random.PRNGKey(i), alpha)
        got = torch._standard_gamma_grad(_t(alpha), _t(value)).numpy()
        np.testing.assert_allclose(got, dvalue, rtol=2e-4, err_msg=f"alpha={a}")


def test_draws_follow_the_generator_on_its_device_and_differentiate_in_alpha():
    g = torch.Generator().manual_seed(0)
    alpha = _t(np.full((1000,), 30.0), grad=True)
    z = draws.beta(alpha, torch.full((1000,), 30.0), g)
    assert z.shape == (1000,) and float(z.detach().mean()) == pytest.approx(0.5, abs=0.01)
    z.sum().backward()
    assert torch.isfinite(alpha.grad).all() and float(alpha.grad.mean()) > 0  # more alpha, larger z
    s = PowerSpherical(_t(np.eye(4)[:2]), _t([5.0, 50.0])).rsample(g, (3,))
    assert s.shape == (3, 2, 4)
    np.testing.assert_allclose(s.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_high_concentration_samples_sit_near_the_mode():
    g = torch.Generator().manual_seed(1)
    mu = _t(_unit_rows(np.random.default_rng(0), 4, 64))
    for cls in (PowerSpherical, VonMisesFisher):
        s = cls(mu, torch.full((4,), 5000.0)).rsample(g, (128,))
        assert float((s * mu).sum(-1).mean()) > 0.95, cls.__name__
