"""The port's loss-dynamics bench (``multimodal_tpu_torch/research/loss_bench.py``) against the
JAX package's, on the CPU: a few steps of each distribution with JAX's draws replayed through
the port's draw helpers on the reference's key schedule (the initial points, then per step the
image samples and the text samples). The gamma draws of the power spherical depend on the
step's concentrations, so they are made when the port asks for them, from JAX's key for that
draw and the port's alpha (JAX's derivative in alpha rides along, as in
``torch_jax_replay``).

Tolerance: every history entry within 1e-4 relative (float32 sum order, compounded over the
steps), the mean arc beside that within 0.02 degrees: the arccos of a float32 cosine near 1 is
only good to sqrt(2 * 6e-8) rad (0.02 degrees) for a pair that has nearly met."""

import jax
import numpy as np
import pytest
import torch

from multimodal_tpu.research import loss_bench as jbench
from multimodal_tpu_torch.distributions import von_mises_fisher
from multimodal_tpu_torch.ops import draws
from multimodal_tpu_torch.research import loss_bench
from torch_jax_replay import _Replayed, jax_gamma

torch.set_num_threads(2)
STEPS = 6


class LazyReplay:
    """JAX keys queued on the reference's schedule; each draw made from its key when the port
    asks, at the shape (and gamma alpha) it asks for."""

    def __init__(self):
        self.queue = []

    def sampler(self, name, key, rounds=32):
        if name == "power_spherical":
            k_beta, k_dir = jax.random.split(key)
            key_a, key_b = jax.random.split(k_beta)
            self.queue += [("gamma", key_a), ("gamma", key_b), ("normal", k_dir)]
        elif name == "vmf":
            k_w, k_dir = jax.random.split(key)
            key = k_w
            for _ in range(rounds):
                key, k_beta, k_u = jax.random.split(key, 3)
                self.queue.append(("round", (k_beta, k_u)))
            self.queue.append(("normal", k_dir))
        else:
            self.queue.append(("normal", key))

    def _pop(self, kind):
        got, key = self.queue.pop(0)
        assert got == kind, (got, kind)
        return key

    def standard_normal(self, shape, generator, like):
        value = np.asarray(jax.random.normal(self._pop("normal"), tuple(shape), np.float32))
        return torch.from_numpy(value.copy()).to(like.device, like.dtype)

    def standard_gamma(self, alpha, generator):
        value, dvalue = jax_gamma(self._pop("gamma"), alpha.detach().cpu().numpy())
        return _Replayed.apply(alpha, torch.from_numpy(value.copy()),
                               torch.from_numpy(dvalue.copy()))

    def wood_round_draws(self, shape, dm1, generator, like):
        k_beta, k_u = self._pop("round")
        half = (dm1) / 2.0
        z = jax.random.beta(k_beta, half, half, shape=tuple(shape))
        u = jax.random.uniform(k_u, tuple(shape), minval=1e-20, maxval=1.0)
        return torch.from_numpy(np.array(z)), torch.from_numpy(np.array(u))


@pytest.mark.parametrize("dist", loss_bench.DISTRIBUTIONS)
def test_loss_bench_steps_equal_jax_with_its_draws(dist, monkeypatch):
    kw = dict(steps=STEPS, seed=3, mc_samples=4, n_points=6)
    want = jbench.run_loss_bench(dist, keep_history=True, **kw)
    replay = LazyReplay()
    key = jax.random.PRNGKey(3)
    k1, k2, k_loss = jax.random.split(key, 3)
    replay.queue += [("normal", k1), ("normal", k2)]
    for step_key in jax.random.split(k_loss, STEPS):
        k_img, k_txt = jax.random.split(step_key)
        replay.sampler(dist, k_img)
        replay.sampler(dist, k_txt)
    monkeypatch.setattr(draws, "standard_normal", replay.standard_normal)
    monkeypatch.setattr(draws, "standard_gamma", replay.standard_gamma)
    monkeypatch.setattr(von_mises_fisher, "wood_round_draws", replay.wood_round_draws)
    got = loss_bench.run_loss_bench(dist, keep_history=True, device="cpu", **kw)
    assert not replay.queue, "draws left unconsumed"
    for k, v in want.history.items():
        np.testing.assert_allclose(got.history[k], v, rtol=1e-4,
                                   atol=0.02 if k == "arc" else 1e-6, err_msg=k)
    for field in ("final_total_loss", "final_concentration_a", "grad_norm_first"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-4,
                                   err_msg=field)
    for field in ("final_arc_deg", "initial_arc_deg"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), atol=0.02,
                                   err_msg=field)
    assert got.summary_text().splitlines()[0] == f"Distribution: {dist}"


def test_loss_bench_main_writes_the_summaries(tmp_path):
    assert loss_bench.main(["--out-dir", str(tmp_path), "--steps", "3", "--device", "cpu",
                            "--distributions", "vmf", "projected_normal"]) == 0
    for dist in ("vmf", "projected_normal"):
        text = (tmp_path / dist / "summary_statistics.txt").read_text()
        assert text.startswith(f"Distribution: {dist}") and "Gradient norms" in text


def test_riemannian_helpers_equal_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 3)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    g = rng.standard_normal((5, 3)).astype(np.float32)
    v = np.array(jbench.riemannian_project(g, x))
    np.testing.assert_allclose(
        loss_bench.riemannian_project(torch.from_numpy(g), torch.from_numpy(x)).numpy(), v,
        atol=1e-6)
    v[0] = 0.0  # the exponential map's zero-length branch
    np.testing.assert_allclose(
        loss_bench.exponential_map(torch.from_numpy(x), torch.from_numpy(v)).numpy(),
        np.asarray(jbench.exponential_map(x, v)), atol=1e-6)
    y = np.roll(x, 1, axis=0)
    np.testing.assert_allclose(
        loss_bench.arc_length(torch.from_numpy(x), torch.from_numpy(y)).numpy(),
        np.asarray(jbench.arc_length(x, y)), atol=1e-4)


def test_float32_rounding_grows_over_the_run(monkeypatch):
    """Why the card's 1000-step run is not held to the CPU's: on the CPU alone, a 1e-7
    relative nudge of the initial points moves the gradient norm by more than 1e-4 within 150
    steps (the points separate, and so do two runs of them). Each step is held instead
    (``chip_smoke.py`` phase 16 (f): one card step from the CPU's state and draws)."""
    real = draws.standard_normal

    def run(nudge):
        calls = []

        def nudged(shape, generator, like):
            out = real(shape, generator, like)
            calls.append(1)
            return out * (1 + nudge) if len(calls) == 1 else out

        monkeypatch.setattr(draws, "standard_normal", nudged)
        return loss_bench.run_loss_bench("power_spherical", steps=150, keep_history=True,
                                         device="cpu", generator=torch.Generator().manual_seed(0))

    a, b = run(0.0), run(1e-7)
    rel = np.abs(a.history["grad_norm"] - b.history["grad_norm"]) / a.history["grad_norm"]
    assert rel[:5].max() < 1e-4 < rel.max()


def test_a_step_from_a_saved_state_repeats_the_run():
    """``bench_step`` from a state and the generator's state saved mid-run gives the run's own
    next step bit for bit (what phase 16 (f) replays on the card)."""
    gen = torch.Generator().manual_seed(4)
    state = loss_bench.initial_state(6, 2, 0.1, gen, "cpu")
    for _ in range(3):
        state, _ = loss_bench.bench_step("vmf", state, gen)
    saved, gstate = tuple(t.clone() for t in state), gen.get_state()
    want_state, want = loss_bench.bench_step("vmf", state, gen)
    g = torch.Generator()
    g.set_state(gstate)
    got_state, got = loss_bench.bench_step("vmf", saved, g)
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))
    assert all(torch.equal(got[k], want[k]) for k in loss_bench.HISTORY_KEYS)
