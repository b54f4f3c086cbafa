"""The port's MoE MLP (``models/moe.py``) against the JAX package's ``MoEMLP``, mirroring
``tests/test_moe.py``: the routing algebra (one expert is the dense MLP, capacity drops
overflow, top-2 gates renormalized, uniform load balance is 1), ``MoEMLP``'s output, aux
term and gradients against JAX at top-k 1 and 2 and capacity factors 1.25 and 2.0, and a
``tiny-test-moe`` train step against JAX's (the aux loss collected into the clip loss).

Weights and inputs come from seeded numpy generators (the JAX module's init for ``MoEMLP``,
its tree for the model, through ``load_jax_params``). Tolerances: the module's output and
aux rtol 1e-5 / atol 1e-6, its gradients atol 1e-5; the train step
``tests/test_torch_train_step.py``'s (loss, aux and grad norm rtol 1e-5, parameters after
two steps atol 2e-5, rtol 1e-5).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models.moe import MoEMLP as JaxMoEMLP
from multimodal_tpu_torch.models import create_model, load_jax_params
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.models.layers import MLP, quick_gelu
from multimodal_tpu_torch.models.moe import (
    MoEMLP,
    collect_moe_losses,
    load_balance_loss,
    top_k_rounds,
)
from multimodal_tpu_torch.train import make_optimizer, make_schedule
from torch_jax_models import (
    OPT,
    assert_grads_close,
    assert_params_close,
    jax_steps,
    port_steps,
    random_params,
)

torch.set_num_threads(1)


def _moe(w, e, expansion=1.0, top_k=1, cf=1.25, seed=0):
    moe = MoEMLP(w, e, expansion, act=quick_gelu, top_k=top_k, capacity_factor=cf)
    moe.init_weights(torch.Generator().manual_seed(seed))
    moe.router.init_weights(torch.Generator().manual_seed(seed + 1))
    return moe


def _x(b, s, w, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, s, w),
                                                                         dtype=np.float32))


def test_single_expert_equals_dense_mlp():
    """E=1 sends every token to the one expert with gate 1: the dense MLP's output."""
    moe = _moe(16, 1, expansion=2.0, cf=2.0)
    dense = MLP(16, 2.0, act=quick_gelu)
    with torch.no_grad():
        dense.c_fc.kernel.copy_(moe.w1[0])
        dense.c_fc.bias.copy_(moe.b1[0])
        dense.c_proj.kernel.copy_(moe.w2[0])
        dense.c_proj.bias.copy_(moe.b2[0])
    x = _x(4, 6, 16)
    torch.testing.assert_close(moe(x), dense(x), rtol=1e-5, atol=1e-6)


def test_capacity_drop_zeroes_overflow():
    """One slot per expert: at most E tokens come back nonzero, the rest exactly zero."""
    moe = _moe(8, 2, cf=1e-9)
    assert moe.capacity(16) == 1
    y = moe(_x(1, 16, 8, seed=1))[0]
    assert int((y != 0).any(dim=-1).sum()) <= 2


def test_top2_gates_renormalized():
    """Top-2 with room for every token: each output row is the two chosen experts' outputs
    weighted by their router probabilities over the pair's sum; every gradient finite."""
    moe = _moe(8, 4, top_k=2, cf=4.0)
    x = _x(2, 8, 8, seed=2).requires_grad_()
    y = moe(x)
    probs = moe.router_probs(x).detach()
    first, second = top_k_rounds(probs, 2)
    with torch.no_grad():
        def expert(e, row):
            return quick_gelu(row @ moe.w1[e] + moe.b1[e]) @ moe.w2[e] + moe.b2[e]

        for g in range(2):
            for s in range(8):
                e1, e2 = int(first[g, s]), int(second[g, s])
                p1, p2 = probs[g, s, e1], probs[g, s, e2]
                want = (p1 * expert(e1, x[g, s]) + p2 * expert(e2, x[g, s])) / (p1 + p2)
                torch.testing.assert_close(y[g, s], want, rtol=1e-5, atol=1e-6)
    y.square().sum().backward()
    for name, p in moe.named_parameters():
        assert torch.isfinite(p.grad).all(), name
    assert torch.isfinite(x.grad).all()


def test_load_balance_loss_uniform_is_one():
    t, e = 64, 8
    probs = torch.full((t, e), 1.0 / e)
    mask = torch.eye(e)[torch.arange(t) % e]
    torch.testing.assert_close(load_balance_loss(probs, mask), torch.tensor(1.0))


def _jax_moe(w, e, top_k, cf, x):
    moe = JaxMoEMLP(w, num_experts=e, expansion=2.0, top_k=top_k, capacity_factor=cf)
    params = jax.device_get(moe.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    return moe, params


@pytest.mark.parametrize("top_k,cf", [(1, 1.25), (1, 2.0), (2, 1.25), (2, 2.0)])
def test_moe_mlp_output_aux_and_grads_match_jax(top_k, cf):
    """S=10, E=4: capacity 3 at top-1 cf 1.25 (tokens dropped), 10 at top-2 cf 2.0."""
    b, s, w, e = 3, 10, 16, 4
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    cot = rng.standard_normal((b, s, w)).astype(np.float32)
    jmoe, params = _jax_moe(w, e, top_k, cf, x)

    def jax_fn(p, xx):
        y, mut = jmoe.apply({"params": p}, xx, mutable=["moe_losses"])
        aux = jax.tree_util.tree_leaves(mut["moe_losses"])[0]
        return jnp.sum(y * cot) + 0.5 * aux.sum(), (y, aux.sum())

    (_, (want_y, want_aux)), (g_params, g_x) = jax.value_and_grad(
        jax_fn, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    moe = MoEMLP(w, e, 2.0, top_k=top_k, capacity_factor=cf)
    with torch.no_grad():
        for name, p in moe.named_parameters():
            p.copy_(torch.from_numpy(jax_params_to_port(params)[name].copy()))
    xt = torch.from_numpy(x).requires_grad_()
    y = moe(xt)
    ((y * torch.from_numpy(cot)).sum() + 0.5 * moe.last_aux).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(moe.last_aux.item(), float(want_aux), rtol=1e-5)
    want_g = jax_params_to_port(jax.device_get(g_params))
    for name, p in moe.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name], atol=1e-5, rtol=1e-4,
                                   err_msg=name)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(g_x), atol=1e-5, rtol=1e-4)


@functools.lru_cache(maxsize=None)
def _runs():
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule

    jm = jax_create_model("tiny-test-moe")
    params = random_params(jm)
    want = jax_steps(jm, params, jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT))
    model = load_jax_params(create_model("tiny-test-moe", device="cpu"), params)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50), **OPT)
    got = port_steps(model, opt)
    return want, got, model


def test_tiny_test_moe_step_matches_jax():
    """Two clip-loss steps with the aux term (weight 0.01): loss, moe_aux_loss and grad norm
    per step, every gradient leaf of each step, then every parameter."""
    (want, want_grads, want_params), (got, got_grads), model = _runs()
    for w, g in zip(want, got):
        for k in ("loss", "moe_aux_loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        assert 1.0 <= g["moe_aux_loss"] <= 4.0  # one MoE layer of 4 experts
    for w, g in zip(want_grads, got_grads):
        assert_grads_close(g, jax_params_to_port(jax.device_get(w)))
    assert_params_close(model, jax_params_to_port(jax.device_get(want_params)))


def test_remat_gives_the_same_aux_and_gradients():
    """The checkpointed block runs its MoE layer again inside the backward; the aux term is
    assigned there, not added, so the loss, the aux and every gradient repeat."""
    out = []
    for remat in (False, True):
        model = create_model("tiny-test-moe", remat=remat, device="cpu", seed=2)
        opt = make_optimizer(model.named_parameters(), 1e-3, **OPT)
        metrics, grads = port_steps(model, opt, steps=1)
        out.append((metrics[0], grads[0], collect_moe_losses(model).item()))
    (m0, g0, aux0), (m1, g1, aux1) = out
    assert m0["moe_aux_loss"] == m1["moe_aux_loss"] and aux0 == aux1
    np.testing.assert_allclose(m1["loss"], m0["loss"], rtol=1e-6)
    for k in g0:
        np.testing.assert_allclose(g1[k], g0[k], rtol=1e-5, atol=1e-7, err_msg=k)
