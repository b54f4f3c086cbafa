"""The port's linear probe against the JAX package's: ``probe_accuracy`` equal on the same
(w, b), with and without ``mean_per_class``; AdamW steps from the same init on the same
indices equal to ``optax.adamw``'s under the same cosine schedule at 1e-6 (float32 on the
CPU); and a separable set fitted to accuracy 1.0 by both."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multimodal_tpu.eval import linear_probe as jax_lp
from multimodal_tpu.train.schedules import cosine_lr as jax_cosine_lr
from multimodal_tpu_torch.eval import linear_probe as lp
from multimodal_tpu_torch.train.schedules import cosine_lr

torch.set_num_threads(1)


def _data(n=64, d=12, c=5, seed=0, spread=0.5):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((c, d)).astype(np.float32) * 3
    y = rng.integers(0, c, n).astype(np.int32)
    x = centers[y] + spread * rng.standard_normal((n, d)).astype(np.float32)
    return x, y


@pytest.mark.parametrize("mean_per_class", [False, True])
def test_probe_accuracy_equals_jax(mean_per_class):
    x, y = _data(spread=3.0)
    rng = np.random.default_rng(1)
    w = rng.standard_normal((12, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    want = jax_lp.probe_accuracy({"w": jnp.asarray(w), "b": jnp.asarray(b)}, x, y,
                                 mean_per_class=mean_per_class)
    got = lp.probe_accuracy({"w": torch.from_numpy(w), "b": torch.from_numpy(b)}, x, y,
                            mean_per_class=mean_per_class)
    assert got == pytest.approx(want, rel=1e-6)
    assert 0.0 < got < 1.0


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_steps_match_optax(weight_decay):
    x, y = _data()
    total, lr = 40, 1e-2
    rng = np.random.default_rng(2)
    w0 = (rng.standard_normal((12, 5)) * 0.01).astype(np.float32)
    idx = [rng.integers(0, 64, 16) for _ in range(4)]

    tx = optax.adamw(jax_cosine_lr(lr, max(total // 20, 1), total), weight_decay=weight_decay)
    jp = {"w": jnp.asarray(w0), "b": jnp.zeros(5)}
    state = tx.init(jp)

    def loss_fn(p, xb, yb):
        logits = xb @ p["w"] + p["b"]
        return jnp.mean(-jax.nn.log_softmax(logits)[jnp.arange(xb.shape[0]), yb])

    schedule = cosine_lr(lr, max(total // 20, 1), total)
    tp = {"w": torch.from_numpy(w0.copy()), "b": torch.zeros(5)}
    tstate = lp.probe_state(tp)
    for step, i in enumerate(idx):
        g = jax.grad(loss_fn)(jp, jnp.asarray(x[i]), jnp.asarray(y[i]))
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        tp, tstate = lp.probe_step(tp, tstate, torch.from_numpy(x[i]),
                                   torch.from_numpy(y[i]).long(), float(schedule(step)),
                                   weight_decay)
        for k in ("w", "b"):
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=0,
                                       err_msg=f"step {step} {k}")
    assert not np.allclose(np.asarray(jp["w"]), w0)


def test_separable_set_is_fitted_by_both():
    x, y = _data(n=80, spread=0.3, seed=3)
    xt, yt = _data(n=40, spread=0.3, seed=3)
    want = jax_lp.linear_probe_metrics(x, y, xt, yt, 5, epochs=60, lr=1e-2, batch_size=32)
    got = lp.linear_probe_metrics(x, y, xt, yt, 5, epochs=60, lr=1e-2, batch_size=32,
                                  device="cpu")
    assert want == {"linear_probe_accuracy": 1.0, "linear_probe_mean_per_class": 1.0}
    assert got == want


def test_probe_init_and_draws_follow_the_seed():
    x, y = _data()
    a = lp.train_linear_probe(x, y, 5, epochs=3, batch_size=16, seed=4, device="cpu")
    b = lp.train_linear_probe(x, y, 5, epochs=3, batch_size=16, seed=4, device="cpu")
    c = lp.train_linear_probe(x, y, 5, epochs=3, batch_size=16, seed=5, device="cpu")
    assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])
    assert a["w"].shape == (12, 5) and a["b"].shape == (5,)
