"""The port's LR schedules, weight-decay mask and fused AdamW against the JAX package's
(``multimodal_tpu.train.schedules`` and ``optimizer``) on the same numpy parameters and
gradients. Tolerances: schedules rtol 1e-6 and atol 1e-9 of a 1e-3 base LR (both compute
in float32; the two cos implementations differ in the last bit near the end of the decay,
where the LR is ~1e-6); AdamW parameters
atol 1e-6 and rtol 1e-5, as the JAX package's fused-vs-optax test
(tests/test_fused_optimizer.py). With bfloat16 state a moment's float32 value can differ in
its last bit (XLA fuses the moment update into FMAs, torch does not), which can flip its
bf16 rounding: parameters then hold atol 1e-4 (the 1e-2 step size times bf16's 2^-7), and
the moments are compared at one bf16 rounding (rtol 1e-2)."""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.train.optimizer import (
    FusedAdamW,
    extract_grad_norm,
    make_optimizer,
    wd_mask,
)
from multimodal_tpu_torch.train.schedules import make_schedule

torch.set_num_threads(1)

SCHEDULES = [("cosine", {}), ("const", {}),
             ("const-cooldown", dict(cooldown_steps=20, cooldown_power=2.0,
                                     cooldown_end_lr=1e-5))]


@pytest.mark.parametrize("name,kw", SCHEDULES)
def test_schedules_match_jax(name, kw):
    from multimodal_tpu.train.schedules import make_schedule as jax_schedule

    jax_fn, fn = jax_schedule(name, 1e-3, 10, 100, **kw), make_schedule(name, 1e-3, 10, 100, **kw)
    steps = np.arange(0, 110)
    want = np.array([float(jax_fn(int(s))) for s in steps])
    np.testing.assert_allclose([fn(int(s)).item() for s in steps], want, rtol=1e-6, atol=1e-9)
    got = fn(torch.tensor(steps, dtype=torch.int32))  # a step tensor, as the optimizer passes
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_schedule("linear", 1e-3, 1, 10)


def test_wd_mask_matches_jax():
    """Decay on ndim >= 2 except logit_scale, leaf for leaf through the weight bridge."""
    import jax

    from multimodal_tpu.models import create_model as jax_create_model
    from multimodal_tpu.models import init_params
    from multimodal_tpu.models.checkpoint_interop import export_torch_state_dict
    from multimodal_tpu.train.optimizer import wd_mask as jax_wd_mask
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.models.checkpoint_interop import _openai_to_port

    jm = jax_create_model("tiny-test")
    shapes = jax.eval_shape(lambda: init_params(jm, jax.random.PRNGKey(0)))
    as_arrays = jax.tree_util.tree_map(lambda m, s: np.full(s.shape, m, np.float32),
                                       jax_wd_mask(shapes), shapes)
    model = create_model("tiny-test", device="cpu")
    want = _openai_to_port(export_torch_state_dict(as_arrays, jm.cfg), model)
    got = wd_mask(model.named_parameters())
    assert set(got) == set(want)
    for name, decayed in got.items():
        assert np.all(want[name] == float(decayed)), name
    assert not got["logit_scale"] and got["visual_projection"]


def _leaves(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense.kernel": rng.standard_normal((16, 32), dtype=np.float32),
            "dense.bias": np.zeros(32, np.float32),
            "logit_scale": np.float32(2.6),
            "emb": rng.standard_normal((64, 16), dtype=np.float32) * 0.1}


def _grads(step):
    rng = np.random.default_rng(100 + step)
    g = {k: rng.standard_normal(np.shape(v), dtype=np.float32).reshape(np.shape(v))
         for k, v in _leaves().items()}
    if step == 1:  # a poisoned step, skipped exactly on both sides
        g["emb"][3, 2] = np.nan
    return g


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_fused_adamw_matches_jax(state_dtype):
    """3 steps with the clip active and a non-finite step skipped (4 updates, 3 counted)."""
    import jax.numpy as jnp
    import optax

    from multimodal_tpu.train.optimizer import fused_adamw as jax_fused_adamw
    from multimodal_tpu.train.schedules import make_schedule as jax_schedule

    kw = dict(weight_decay=0.1, beta1=0.9, beta2=0.98, eps=1e-6, grad_clip_norm=0.5)
    tx = jax_fused_adamw(jax_schedule("cosine", 1e-2, 2, 20), **kw,
                         state_dtype=jnp.dtype(state_dtype))
    jp = {k: jnp.asarray(v) for k, v in _leaves().items()}
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _leaves().items()}
    opt = FusedAdamW(params.items(), make_schedule("cosine", 1e-2, 2, 20), **kw,
                     state_dtype=getattr(torch, state_dtype))
    atol = 1e-6 if state_dtype == "float32" else 1e-4
    for step in range(4):
        g = _grads(step)
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        opt.step()
        for k, p in params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=atol,
                                       rtol=1e-5, err_msg=f"step {step} {k}")
        assert int(opt.count) == int(js.count)
        assert int(opt.notfinite_count) == int(js.notfinite_count)
        if step == 1:
            assert not np.isfinite(float(extract_grad_norm(opt)))
        else:
            np.testing.assert_allclose(float(extract_grad_norm(opt)), float(js.grad_norm),
                                       rtol=1e-6)
    assert int(opt.count) == 3 and opt.mu["emb"].dtype == getattr(torch, state_dtype)
    rtol = 1e-5 if state_dtype == "float32" else 1e-2
    for k in params:
        np.testing.assert_allclose(opt.mu[k].float().numpy(),
                                   np.asarray(js.mu[k].astype(jnp.float32)), atol=1e-7, rtol=rtol)
        np.testing.assert_allclose(opt.nu[k].float().numpy(),
                                   np.asarray(js.nu[k].astype(jnp.float32)), atol=1e-7, rtol=rtol)


def test_nonfinite_step_freezes_everything():
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _leaves().items()}
    opt = make_optimizer(params.items(), 1e-3, weight_decay=0.1, grad_clip_norm=1.0)
    for k, p in params.items():
        p.grad = torch.ones_like(p)
    opt.step()
    before = {k: p.detach().clone() for k, p in params.items()}
    mu = {k: v.clone() for k, v in opt.mu.items()}
    params["emb"].grad[0, 0] = float("inf")
    opt.step()
    for k, p in params.items():
        assert torch.equal(p, before[k]) and torch.equal(opt.mu[k], mu[k]), k
    assert int(opt.count) == 1 and int(opt.notfinite_count) == 1


def test_nonfinite_first_step_is_skipped():
    """A bad first step: count stays 0, so the bias correction would divide by zero; the
    parameters and moments must still come out unchanged."""
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _leaves().items()}
    before = {k: p.detach().clone() for k, p in params.items()}
    opt = make_optimizer(params.items(), 1e-3, weight_decay=0.1, grad_clip_norm=1.0)
    for k, p in params.items():
        p.grad = torch.full_like(p, float("nan"))
    opt.step()
    for k, p in params.items():
        assert torch.equal(p, before[k]) and not opt.mu[k].any() and not opt.nu[k].any(), k
    assert int(opt.count) == 0 and int(opt.notfinite_count) == 1


def test_fused_adamw_without_skip_matches_jax():
    import jax.numpy as jnp
    import optax

    from multimodal_tpu.train.optimizer import fused_adamw as jax_fused_adamw

    kw = dict(weight_decay=0.1, grad_clip_norm=None, skip_nonfinite=False)
    tx = jax_fused_adamw(1e-2, **kw)
    jp = {k: jnp.asarray(v) for k, v in _leaves().items()}
    js = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _leaves().items()}
    opt = FusedAdamW(params.items(), 1e-2, **kw)
    for step in (0, 2, 3):
        g = _grads(step)
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        for k, p in params.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-5)
    assert int(opt.count) == 3


@pytest.mark.cuda
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_fused_adamw_on_cuda_matches_cpu(state_dtype):
    """The multi-tensor update on the card (schedule, clip, skipped step and all) against the
    same optimizer on the CPU: only the norm's summation order differs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    runs = {}
    for device in ("cpu", "cuda"):
        params = {k: torch.nn.Parameter(torch.tensor(v, device=device))
                  for k, v in _leaves().items()}
        opt = make_optimizer(params.items(), make_schedule("cosine", 1e-2, 2, 20),
                             weight_decay=0.1, grad_clip_norm=0.5, state_dtype=state_dtype)
        for step in range(4):
            for k, p in params.items():
                p.grad = torch.tensor(_grads(step)[k], device=device)
            opt.step()
        runs[device] = (params, opt)
    (cpu_p, cpu_opt), (gpu_p, gpu_opt) = runs["cpu"], runs["cuda"]
    assert int(gpu_opt.count) == 3 and int(gpu_opt.notfinite_count) == 0
    atol = 1e-6 if state_dtype == torch.float32 else 1e-4
    for k in cpu_p:
        np.testing.assert_allclose(gpu_p[k].detach().cpu().numpy(), cpu_p[k].detach().numpy(),
                                   atol=atol, rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("kwargs", [{"opt": "lamb"}, {"opt": "lars"}, {"fused": False}])
def test_left_out_optimizers_raise(kwargs):
    """Refused until ROADMAP Queue 1 item 8 was ported; now the three build the modular
    chain, and what they still refuse is the reference's refusal: moments in bfloat16, which
    only the fused AdamW stores."""
    from multimodal_tpu_torch.train.optimizer import ChainOptimizer

    params = [("w", torch.nn.Parameter(torch.zeros(2, 2)))]
    assert isinstance(make_optimizer(params, 1e-3, **kwargs), ChainOptimizer)
    with pytest.raises(ValueError, match="only honored by the fused adamw"):
        make_optimizer(params, 1e-3, state_dtype=torch.bfloat16, **kwargs)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(params, 1e-3, opt="sgd")


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip_nonfinite", [True, False])
def test_update_in_chunks_moves_no_bit(state_dtype, skip_nonfinite, monkeypatch):
    """The update runs over runs of leaves (``_chunks``) to bound its float32 temporaries: one
    leaf a chunk, or a chunk splitting the leaves 3 + 1, gives the bits of one chunk over all
    of them, in parameters and moments, over 4 steps (the poisoned one included)."""
    from multimodal_tpu_torch.train import optimizer

    def run(chunk):
        monkeypatch.setattr(optimizer, "UPDATE_CHUNK", chunk)
        params = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in _leaves().items()}
        opt = FusedAdamW(params.items(), make_schedule("cosine", 1e-2, 2, 20), weight_decay=0.1,
                         grad_clip_norm=0.5, state_dtype=getattr(torch, state_dtype),
                         skip_nonfinite=skip_nonfinite)
        for step in range(4 if skip_nonfinite else 3):
            g = _grads(step if skip_nonfinite else 2 * step)
            for k, p in params.items():
                p.grad = torch.tensor(g[k])
            opt.step()
        return params, opt

    sizes = [np.size(v) for v in _leaves().values()]
    assert optimizer._chunks([torch.empty(n) for n in sizes]) == [[0, 1, 2, 3]]
    want_p, want_opt = run(1 << 28)
    for chunk, runs in ((1, [[0], [1], [2], [3]]), (sum(sizes[:3]), [[0, 1, 2], [3]])):
        monkeypatch.setattr(optimizer, "UPDATE_CHUNK", chunk)
        assert optimizer._chunks([torch.empty(n) for n in sizes]) == runs
        got_p, got_opt = run(chunk)
        for k in want_p:
            assert torch.equal(got_p[k], want_p[k]), (chunk, k)
            assert torch.equal(got_opt.mu[k], want_opt.mu[k]), (chunk, k)
            assert torch.equal(got_opt.nu[k], want_opt.nu[k]), (chunk, k)
        assert int(got_opt.count) == int(want_opt.count)
        assert int(got_opt.notfinite_count) == int(want_opt.notfinite_count)
