"""The port's modular optimizers (``ChainOptimizer``: the AdamW chain of ``fused=False``, LAMB
and LARS) against the optax chains that the JAX package's ``make_optimizer`` builds, on the
same numpy parameters and gradients: four updates with the global-norm clip active and the
second step's gradient non-finite (skipped exactly on both sides), and runs without the skip
and without the clip.

Tolerances, float32 on the CPU: parameters atol 1e-6 and rtol 1e-5, as the JAX package's
fused-vs-optax test (``tests/test_fused_optimizer.py``); the moments and the trace rtol 1e-5
(atol 1e-7); the grad norm rtol 1e-6; the step and non-finite counts exactly.
"""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.train.optimizer import (
    ChainOptimizer,
    clip_and_skip_by_global_norm,
    extract_grad_norm,
    make_optimizer,
    skip_if_nonfinite,
)
from multimodal_tpu_torch.train.schedules import make_schedule

torch.set_num_threads(1)

OPTS = [("adamw", False), ("lamb", True), ("lars", True)]  # (opt, fused) of make_optimizer


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense.kernel": rng.standard_normal((16, 32), dtype=np.float32),
            "dense.bias": rng.standard_normal(32, dtype=np.float32) * 0.1,
            "logit_scale": np.float32(2.6),
            "emb": rng.standard_normal((64, 16), dtype=np.float32) * 0.1,
            "zero.kernel": np.zeros((8, 4), np.float32)}  # a zero norm: trust ratio 1


def _grads(step, poison=1):
    rng = np.random.default_rng(100 + step)
    g = {k: rng.standard_normal(np.shape(v), dtype=np.float32).reshape(np.shape(v))
         for k, v in _leaves().items()}
    if step == poison:
        g["emb"][3, 2] = np.nan
    return g


def _jax_states(tree, cls_name: str) -> list:
    """Every node of class ``cls_name`` inside an optax state tree."""
    found = []

    def visit(node):
        if type(node).__name__ == cls_name:
            found.append(node)
        if isinstance(node, tuple):
            for child in node:
                visit(child)

    visit(tree)
    return found


def _run(opt, fused, kw, steps, poison=1):
    import jax.numpy as jnp
    import optax

    from multimodal_tpu.train.optimizer import make_optimizer as jax_make_optimizer
    from multimodal_tpu.train.schedules import make_schedule as jax_schedule

    tx = jax_make_optimizer(jax_schedule("cosine", 1e-2, 2, 20), opt=opt, fused=fused, **kw)
    jp = {k: jnp.asarray(v) for k, v in _leaves().items()}
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _leaves().items()}
    port = make_optimizer(params.items(), make_schedule("cosine", 1e-2, 2, 20), opt=opt,
                          fused=fused, **kw)
    assert isinstance(port, ChainOptimizer)
    for step in range(steps):
        g = _grads(step, poison)
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        port.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                       rtol=1e-5, err_msg=f"{opt} step {step} {k}")
        want_norm = float(_jax_states(js, "ClipAndSkipState")[0].grad_norm)
        if np.isfinite(want_norm):
            np.testing.assert_allclose(float(extract_grad_norm(port)), want_norm, rtol=1e-6)
        else:
            assert not np.isfinite(float(extract_grad_norm(port)))
        count = int(_jax_states(js, "ScaleByScheduleState")[0].count)
        assert int(port.count) == count, (step, int(port.count), count)
        skip = _jax_states(js, "SkipIfNonfiniteState")
        if skip:
            assert int(port.notfinite_count) == int(skip[0].notfinite_count)
    return port, js


@pytest.mark.parametrize("opt,fused", OPTS)
def test_chain_matches_jax_with_clip_and_a_skipped_step(opt, fused):
    port, js = _run(opt, fused, dict(weight_decay=0.1, grad_clip_norm=0.5), steps=4)
    assert int(port.count) == 3 and int(port.notfinite_count) == 0
    slots = {"trace": "TraceState"} if opt == "lars" else {"mu": "ScaleByAdamState",
                                                            "nu": "ScaleByAdamState"}
    for slot, cls in slots.items():
        want = getattr(_jax_states(js, cls)[0], slot)
        for k, v in port.state_dict()[slot].items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=1e-7, rtol=1e-5,
                                       err_msg=f"{slot} {k}")


@pytest.mark.parametrize("opt,fused", OPTS)
def test_chain_matches_jax_without_skip_or_clip(opt, fused):
    port, _ = _run(opt, fused, dict(weight_decay=0.05, grad_clip_norm=None,
                                     skip_nonfinite=False), steps=3, poison=-1)
    assert int(port.count) == 3


@pytest.mark.parametrize("opt,fused", OPTS)
def test_chain_nonfinite_first_step_freezes_everything(opt, fused):
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _leaves().items()}
    before = {k: p.detach().clone() for k, p in params.items()}
    port = make_optimizer(params.items(), 1e-3, opt=opt, fused=fused, grad_clip_norm=1.0)
    for p in params.values():
        p.grad = torch.full_like(p, float("nan"))
    port.step()
    for k, p in params.items():
        assert torch.equal(p, before[k]), k
    for slot in port.SLOTS:
        assert not any(t.any() for t in port.state_dict()[slot].values())
    assert int(port.count) == 0 and int(port.notfinite_count) == 1


def test_state_dtype_is_refused_off_the_fused_adamw():
    params = [("w", torch.nn.Parameter(torch.zeros(2, 2)))]
    for kw in ({"opt": "lamb"}, {"opt": "lars"}, {"fused": False}):
        with pytest.raises(ValueError, match="only honored by the fused adamw"):
            make_optimizer(params, 1e-3, state_dtype=torch.bfloat16, **kw)


def test_clip_and_skip_stage_matches_jax():
    import jax.numpy as jnp

    from multimodal_tpu.train.optimizer import clip_and_skip_by_global_norm as jax_stage

    for step, clip in ((0, 0.5), (2, None), (1, 0.5)):
        g = _grads(step)
        tx = jax_stage(clip, True)
        want, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, tx.init(None))
        got, norm = clip_and_skip_by_global_norm([torch.tensor(v) for v in g.values()], clip,
                                                 True)
        np.testing.assert_allclose(float(norm), float(st.grad_norm), rtol=1e-6)
        for t, k in zip(got, g):  # nan where the reference has nan (the skipped step)
            np.testing.assert_allclose(t.numpy(), np.asarray(want[k]), atol=1e-7, rtol=1e-6)


def test_skip_if_nonfinite_keeps_or_takes_the_state():
    old = [torch.ones(3), torch.full((2,), 2.0)]
    new = [torch.zeros(3), torch.full((2,), 5.0)]
    count = torch.zeros((), dtype=torch.int32)
    skip_if_nonfinite(torch.tensor(False), old, new, count)
    assert torch.equal(old[0], torch.ones(3)) and int(count) == 1
    skip_if_nonfinite(torch.tensor(False), old, new, count)
    assert int(count) == 2
    skip_if_nonfinite(torch.tensor(True), old, new, count)
    assert torch.equal(old[1], new[1]) and int(count) == 0
