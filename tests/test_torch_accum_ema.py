"""The port's gradient accumulation (plain and feature-cached), parameter EMA and the train
steps of the cloob, align and chunked losses against the JAX package's ``train/engine.py``
on ``tiny-test`` (seeded numpy weights through ``load_jax_params``, a seeded numpy batch).

* plain accumulation against ``_accum_grads``: every gradient leaf and the loss;
* feature-cached accumulation against ``_feature_cached_grads`` on every leaf but the logit
  scale. There the reference sums the whole-bank loss's dependence once per micro-batch, k
  times the full-batch gradient (ROADMAP Queue 3): the test asserts JAX's value is k times the
  port's, and that the port's equals the full-batch gradient (the port's own and JAX's);
* the EMA after 3 steps against JAX's ``ema_params``;
* two steps each of cloob, align (with and without semantic features) and the chunked CLIP
  loss against JAX's ``make_loss_fn`` gradients.

Tolerances, ``tests/test_torch_train_step.py``'s (float32 on the CPU, summation order
only): losses and grad norms rtol 1e-5; every gradient leaf atol 1e-4 x max(1, max|leaf|)
and rtol 1e-3; parameters and the EMA after the steps atol 2e-5, rtol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu_torch.models import create_model, load_jax_params
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.train import TrainState, make_optimizer, make_schedule, make_train_step
from torch_jax_models import (
    OPT,
    assert_grads_close,
    assert_params_close,
    batch,
    jax_steps,
    port_steps,
    random_params,
)

torch.set_num_threads(1)

N, K = 16, 4  # batch and micro-batches


@functools.lru_cache(maxsize=None)
def _setup():
    jm = jax_create_model("tiny-test")
    return jm, random_params(jm)


def _port_model():
    jm, params = _setup()
    return load_jax_params(create_model("tiny-test", device="cpu"), params)


def _jax_batch(cfg, n=N):
    images, tokens = batch(cfg, n)
    return {"image": jnp.asarray(images), "text": jnp.asarray(tokens)}


def _port_batch(cfg, n=N):
    images, tokens = batch(cfg, n)
    return {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}


def _port_grads(model, **step_kw) -> tuple[dict, dict]:
    """One port step with an SGD-free optimizer (lr 0): the step's metrics and the
    gradients it left in ``.grad``."""
    opt = make_optimizer(model.named_parameters(), 0.0)
    step = make_train_step(model, opt, **step_kw)
    m = step(TrainState.create(model, opt), _port_batch(model.cfg), torch.Generator())
    return ({k: float(v) for k, v in m.items()},
            {n: p.grad.detach().numpy().copy() for n, p in model.named_parameters()})


def test_plain_accumulation_matches_jax():
    from multimodal_tpu.train.engine import _accum_grads, make_loss_fn

    jm, params = _setup()
    want_g, want_m = _accum_grads(make_loss_fn(jm, "clip"), jax.tree_util.tree_map(
        jnp.asarray, params), _jax_batch(jm.cfg), jax.random.PRNGKey(0), K, None)
    got_m, got_g = _port_grads(_port_model(), accum_steps=K)
    np.testing.assert_allclose(got_m["loss"], float(want_m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(got_m["logit_scale"], float(want_m["logit_scale"]), rtol=1e-6)
    assert_grads_close(got_g, jax_params_to_port(jax.device_get(want_g)))


@functools.lru_cache(maxsize=None)
def _feature_cached():
    from multimodal_tpu.train.engine import _feature_cached_grads, make_loss_fn

    jm, params = _setup()
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jbatch = _jax_batch(jm.cfg)
    want_g, want_m = _feature_cached_grads(jm, jparams, jbatch, jax.random.PRNGKey(0), None,
                                           K, None)
    loss_fn = make_loss_fn(jm, "clip")
    dense_g = jax.grad(lambda p: loss_fn(p, jbatch, jax.random.PRNGKey(0))[0])(jparams)
    got_m, got_g = _port_grads(_port_model(), accum_steps=K, feature_cached_accum=True)
    full_m, full_g = _port_grads(_port_model())
    return (want_m, jax_params_to_port(jax.device_get(want_g)),
            jax_params_to_port(jax.device_get(dense_g)), got_m, got_g, full_m, full_g)


def test_feature_cached_matches_jax_on_every_leaf_but_the_logit_scale():
    want_m, want_g, _, got_m, got_g, _, _ = _feature_cached()
    np.testing.assert_allclose(got_m["loss"], float(want_m["loss"]), rtol=1e-5)
    assert_grads_close({k: v for k, v in got_g.items() if k != "logit_scale"},
                       {k: v for k, v in want_g.items() if k != "logit_scale"})


def test_feature_cached_logit_scale_is_the_full_batch_gradient_jax_has_k_times_it():
    want_m, want_g, dense_g, got_m, got_g, full_m, full_g = _feature_cached()
    got, jax_value = float(got_g["logit_scale"]), float(want_g["logit_scale"])
    assert abs(got) > 1e-3
    np.testing.assert_allclose(jax_value, K * got, rtol=1e-5)  # the reference's fault
    np.testing.assert_allclose(got, float(full_g["logit_scale"]), rtol=1e-5)
    np.testing.assert_allclose(got, float(dense_g["logit_scale"]), rtol=1e-5)
    np.testing.assert_allclose(got_m["loss"], full_m["loss"], rtol=1e-5)
    assert_grads_close(got_g, full_g)  # the full batch's gradient on every leaf


def test_feature_cached_replays_each_micro_batchs_patch_dropout():
    """With patch dropout, the feature-cached gradient is that of the whole-batch loss over
    the micro-batches' features as one pass in order draws them from the generator (each
    micro-batch's second forward replays its first one's noise), logit scale included; the
    step leaves the generator where that pass leaves it."""
    from multimodal_tpu_torch.inference import model_mode
    from multimodal_tpu_torch.losses import clip_loss
    from multimodal_tpu_torch.train.engine import batch_images

    model = create_model("tiny-test", device="cpu", patch_dropout=0.5, seed=1)
    data = _port_batch(model.cfg)
    gen = torch.Generator().manual_seed(7)
    opt = make_optimizer(model.named_parameters(), 0.0)
    step = make_train_step(model, opt, accum_steps=K, feature_cached_accum=True)
    metrics = step(TrainState.create(model, opt), data, gen)
    got = {n: p.grad.clone() for n, p in model.named_parameters()}

    replay = torch.Generator().manual_seed(7)
    model.zero_grad()
    with model_mode(model, True):
        outs = [model(batch_images(mb, model), mb["text"], generator=replay)
                for mb in ({k: v[i * (N // K):(i + 1) * (N // K)] for k, v in data.items()}
                           for i in range(K))]
        loss = clip_loss(torch.cat([o["image_features"] for o in outs]),
                         torch.cat([o["text_features"] for o in outs]), model.logit_scale,
                         normalize=False)
        loss.backward()
    np.testing.assert_allclose(float(metrics["loss"]), loss.item(), rtol=1e-5)
    assert_grads_close({n: g.numpy() for n, g in got.items()},
                       {n: p.grad.numpy() for n, p in model.named_parameters()})
    assert torch.equal(gen.get_state(), replay.get_state())


def test_feature_cached_refuses_other_losses_and_forms():
    model = create_model("tiny-test", device="cpu")
    opt = make_optimizer(model.named_parameters(), 1e-3)
    for kw in ({"loss_kwargs": {"contrastive_impl": "chunked"}},
               {"loss_kwargs": {"local_loss": True}}, {"loss_type": "cloob"}):
        with pytest.raises(ValueError, match="feature-cached"):
            make_train_step(model, opt, accum_steps=K, feature_cached_accum=True, **kw)


def test_accumulation_needs_a_batch_that_splits():
    model = create_model("tiny-test", device="cpu")
    opt = make_optimizer(model.named_parameters(), 1e-3)
    step = make_train_step(model, opt, accum_steps=3)
    with pytest.raises(ValueError, match="micro-batches"):
        step(TrainState.create(model, opt), _port_batch(model.cfg))


def test_ema_after_three_steps_matches_jax():
    from multimodal_tpu.train import TrainState as JaxState
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule
    from multimodal_tpu.train import make_train_step as jax_train_step

    jm, params = _setup()
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    jstep = jax_train_step(jm, tx, loss_type="clip", ema_decay=0.9, donate=False)
    jstate = JaxState.create(jax.tree_util.tree_map(jnp.asarray, params), tx, ema=True)
    model = _port_model()
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    step = make_train_step(model, opt, ema_decay=0.9)
    state = TrainState.create(model, opt, ema=True)
    for _ in range(3):
        jstate, _ = jstep(jstate, _jax_batch(jm.cfg), jax.random.PRNGKey(0))
        step(state, _port_batch(model.cfg))
    want = jax_params_to_port(jax.device_get(jstate.ema_params))
    assert set(state.ema) == set(want)
    for k, v in state.ema.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), want[k], atol=2e-5, rtol=1e-5, err_msg=k)
    assert_params_close(model, jax_params_to_port(jax.device_get(jstate.params)))
    assert any(not np.allclose(state.ema[k].numpy(), p.detach().numpy())
               for k, p in model.named_parameters())


def _semantic(n=8, d=32):
    s = np.random.default_rng(11).standard_normal((n, d)).astype(np.float32)
    return s / np.linalg.norm(s, axis=1, keepdims=True)


LOSS_CASES = {
    "cloob": ("cloob", {"inv_tau": 30.0, "scale_hopfield": 8.0}, None),
    "align": ("align", {"alpha": 1.0, "beta": 0.5, "separate_text": True,
                        "separate_image": True}, None),
    "align-semantic": ("align", {"alpha": 1.0, "beta": 0.5, "separate_text": True,
                                 "separate_image": False}, {"semantic": _semantic()}),
    "chunked": ("clip", {"contrastive_impl": "chunked", "chunk_size": 3,
                         "label_smoothing": 0.1}, None),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_family_steps_match_jax(case):
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule

    loss_type, kw, extra = LOSS_CASES[case]
    jm, params = _setup()
    tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
    want, want_grads, want_params = jax_steps(jm, params, tx, loss_type=loss_type,
                                              loss_kwargs=kw, extra=extra)
    model = _port_model()
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    got, got_grads = port_steps(model, opt, loss_type=loss_type, loss_kwargs=kw, extra=extra)
    for w, g in zip(want, got):
        assert set(w) == set(g), (sorted(w), sorted(g))
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for w, g in zip(want_grads, got_grads):
        want_g = jax_params_to_port(jax.device_get(w))
        if loss_type == "cloob":  # the loss does not read the logit scale
            want_g = {k: v for k, v in want_g.items() if k != "logit_scale"}
        assert_grads_close(g, want_g)
    assert_params_close(model, jax_params_to_port(jax.device_get(want_params)))
