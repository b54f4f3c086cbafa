"""SwitchBack int8 training in the port (``MLP(int8_fwd=True)`` over
``ops.quant.int8_dense_train``; ``create_model(..., int8_forward=True)``) against the JAX
package's ``MLP.int8_fwd`` and its jitted train step, on seeded numpy weights and batches.

An int8 code is a rounding of a value to one of 255 steps, so a difference of an ulp upstream
(a LayerNorm or softmax sum in another order, a LoRA merge rounded elsewhere) that moves a
value across a step's midpoint changes that code by one: a flip. A flip moves its element by
one step, 1/127 of its row's largest magnitude, so the next layer's inputs move by ~1e-3 and
flip in turn: one flip in the first block of a 2-block text pass grew to 6,754 of 477,184
codes over the step (the shared trunk). ``CodeRecorder`` counts the codes that differ between
the two sides' quantize calls (f = flips / codes) and every test prints it. The limits are
the float paths' own (``tests/test_torch_train_step.py``: loss and grad norm rtol 1e-5, every
gradient leaf atol 1e-4 x max(1, max|leaf|), rtol 1e-3) widened by the flip share: loss and
grad norm rtol 1e-5 + f, every leaf atol (1e-4 + 4 f) x max(1, max|leaf|). The factor 4 is
read off these cases (worst leaf error / f: 0.4 shared trunk, 0.5 variational, 3.3 LoRA, whose
merged weights flip from the first product). The float32 MLP alone is held at the float
limits; it flips no code at these seeds, but an ulp in a row's largest LayerNorm output moves
that row's scale and so every output of the row by an ulp. In bfloat16 XLA keeps some fused
intermediates in float32 (it may drop a bfloat16 rounding inside a fusion: 3% of the codes
flip), so the bfloat16 MLP is held at 2e-2 x max|output| and its gradients at 5e-2 x
max|leaf|.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models.layers import MLP as JaxMLP
from multimodal_tpu.models.layers import quick_gelu as jax_quick_gelu
from multimodal_tpu.train import make_optimizer as jax_optimizer
from multimodal_tpu.train import make_schedule as jax_schedule
from multimodal_tpu_torch.models import create_model, load_jax_params
from multimodal_tpu_torch.models import layers
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.models.moe import MoEMLP
from multimodal_tpu_torch.train import make_optimizer, make_schedule
from torch_jax_models import OPT, CodeRecorder, jax_steps, port_steps, random_params

torch.set_num_threads(1)

W, T = 64, 40  # width, tokens
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ACTS = {"quick_gelu": (jax_quick_gelu, layers.quick_gelu), "gelu": (nn.gelu, layers.gelu)}


def _mlp_inputs(seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, s=1.0: (rng.standard_normal(shape) * s).astype(np.float32)  # noqa: E731
    params = {"c_fc": {"kernel": f32(W, 4 * W, s=W ** -0.5), "bias": f32(4 * W, s=0.02)},
              "c_proj": {"kernel": f32(4 * W, W, s=(4 * W) ** -0.5), "bias": f32(W, s=0.02)}}
    return params, f32(2, T // 2, W), 1 + f32(W, s=0.1), f32(W, s=0.1), f32(2, T // 2, W)


@pytest.mark.parametrize("act", list(ACTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_int8_mlp_matches_jax(monkeypatch, dtype, act):
    """The block's MLP half (the ln_2 hand-off, the residual): output and the gradients of
    x, ln_2's scale and bias and both dense layers' kernels and biases."""
    jdtype, tdtype = DTYPES[dtype]
    params, x, ln_s, ln_b, gy = _mlp_inputs()
    rec = CodeRecorder(monkeypatch)
    jm = JaxMLP(W, dtype=jdtype, depth=2, act=ACTS[act][0], int8_fwd=True)

    def jax_loss(p, x, s, b):
        y = jm.apply({"params": p}, x, ln_params=(s, b), residual=True)
        return jnp.sum(y.astype(jnp.float32) * gy), y

    (_, want_y), want_g = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1, 2, 3),
                                                     has_aux=True))(
        params, jnp.asarray(x).astype(jdtype), ln_s, ln_b)
    mlp = layers.MLP(W, act=ACTS[act][1], dtype=tdtype, depth=2, int8_fwd=True)
    with torch.no_grad():
        for name in ("c_fc", "c_proj"):
            getattr(mlp, name).kernel.copy_(torch.from_numpy(params[name]["kernel"]))
            getattr(mlp, name).bias.copy_(torch.from_numpy(params[name]["bias"]))
    xt = torch.from_numpy(x).to(tdtype).requires_grad_()
    st, bt = torch.from_numpy(ln_s).requires_grad_(), torch.from_numpy(ln_b).requires_grad_()
    y = mlp(xt, ln_params=(st, bt), residual=True)
    (y.float() * torch.from_numpy(gy)).sum().backward()
    flips, codes = rec.flips()
    print(f"int8 MLP {dtype} {act}: {flips} of {codes} codes flipped")
    got = {"y": y.detach(), "x": xt.grad, "ln_s": st.grad, "ln_b": bt.grad,
           **{f"{n}.{k}": getattr(getattr(mlp, n), k).grad for n in ("c_fc", "c_proj")
              for k in ("kernel", "bias")}}
    got = {k: v.float().numpy() for k, v in got.items()}
    want = {"y": want_y, "x": want_g[1], "ln_s": want_g[2], "ln_b": want_g[3],
            **{f"{n}.{k}": want_g[0][n][k] for n in ("c_fc", "c_proj") for k in ("kernel", "bias")}}
    want = {k: np.asarray(jnp.asarray(v).astype(jnp.float32)) for k, v in want.items()}
    assert got["y"].dtype == np.float32 and y.dtype == tdtype
    assert mlp.c_fc.kernel.grad.dtype == torch.float32
    for k, w in want.items():
        scale = float(np.abs(w).max())
        if dtype == "float32":
            np.testing.assert_allclose(got[k], w, atol=1e-4 * max(1.0, scale), rtol=1e-3,
                                       err_msg=k)
        else:
            limit = (2e-2 if k == "y" else 5e-2) * scale
            assert np.abs(got[k] - w).max() <= limit, (k, np.abs(got[k] - w).max(), limit)


def test_block_mlp_is_bypassed_under_int8(monkeypatch):
    """``block_mlp=True`` asks for the fused operator; under int8 the MLP takes the int8
    GEMMs and never calls it, as the reference's ``use_kernel`` excludes int8."""
    params, x, ln_s, ln_b, _ = _mlp_inputs(1)
    out = []
    for block_mlp in (False, True):
        mlp = layers.MLP(W, depth=2, block_mlp=block_mlp, int8_fwd=True)
        with torch.no_grad():
            for name in ("c_fc", "c_proj"):
                getattr(mlp, name).kernel.copy_(torch.from_numpy(params[name]["kernel"]))
                getattr(mlp, name).bias.copy_(torch.from_numpy(params[name]["bias"]))
        monkeypatch.setattr(layers, "block_mlp", lambda *a, **k: pytest.fail("fused operator"))
        out.append(mlp(torch.from_numpy(x), ln_params=(torch.from_numpy(ln_s),
                                                       torch.from_numpy(ln_b)), residual=True))
    assert torch.equal(out[0], out[1])


STEP_CASES = {  # name -> (registry name, create_model options, loss type, loss kwargs)
    "two-tower block attention": ("tiny", {}, "clip", None),
    "two-tower plain attention": ("tiny-test", {}, "clip", None),
    "shared trunk": ("tiny-test-shared", {}, "clip", None),
    "variational": ("tiny-test", {"variational": True}, "vclip", {"kl_weight": 0.0}),
    "lora": ("tiny-test", {"lora_rank": 4, "lora_alpha": 8.0}, "clip", None),
    "moe": ("tiny-test-moe", {}, "clip", None),
}


@functools.lru_cache(maxsize=None)
def _step(case):
    """One train step on each side from the same seeded weights, with both sides' codes
    recorded: (JAX metrics, JAX gradients by port name, port metrics, port gradients, the
    port model, flips, codes)."""
    name, kw, loss_type, loss_kwargs = STEP_CASES[case]
    with pytest.MonkeyPatch.context() as mp:
        rec = CodeRecorder(mp)
        jm = jax_create_model(name, int8_forward=True, **kw)
        params = random_params(jm)
        tx = jax_optimizer(jax_schedule("cosine", 1e-3, 2, 50), **OPT)
        want, want_grads, _ = jax_steps(jm, params, tx, loss_type, steps=1,
                                        loss_kwargs=loss_kwargs)
        model = load_jax_params(create_model(name, device="cpu", int8_forward=True, **kw),
                                params)
        opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-3, 2, 50),
                             **OPT)
        got, got_grads = port_steps(model, opt, loss_type, steps=1, loss_kwargs=loss_kwargs)
        flips, codes = rec.flips()
    return (want[0], jax_params_to_port(jax.device_get(want_grads[0])), got[0], got_grads[0],
            model, flips, codes)


def flip_limits(flips: int, codes: int) -> tuple[float, float]:
    """(loss and grad-norm rtol, gradient-leaf atol factor) after ``flips`` of ``codes`` int8
    codes differ between the sides: the float limits 1e-5 and 1e-4 plus f and 4 f."""
    share = flips / codes
    return 1e-5 + share, 1e-4 + 4 * share


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_int8_train_step_matches_jax(case):
    """Loss, grad norm and every gradient leaf of one float32 step, at ``flip_limits`` of the
    step's flip count."""
    want, want_grads, got, got_grads, model, flips, codes = _step(case)
    rtol, atol = flip_limits(flips, codes)
    print(f"int8 step {case}: {flips} of {codes} codes flipped; loss {got['loss']} vs "
          f"{want['loss']}; limits rtol {rtol:.3e}, leaf atol {atol:.3e} x max(1, max|leaf|)")
    assert codes > 0
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    assert set(got_grads) == set(want_grads)
    for k, w in want_grads.items():
        np.testing.assert_allclose(got_grads[k], w, atol=atol * max(1.0, float(np.abs(w).max())),
                                   rtol=1e-3, err_msg=k)


def test_flip_limits_are_the_float_limits_without_flips():
    assert flip_limits(0, 1000) == (1e-5, 1e-4)
    rtol, atol = flip_limits(10, 1000)
    assert rtol == pytest.approx(1e-5 + 1e-2) and atol == pytest.approx(1e-4 + 4e-2)


def test_int8_reaches_every_dense_mlp_and_no_moe_block():
    """Every dense MLP of a two-tower MoE model takes the int8 GEMMs (two quantized inputs
    and two quantized weights a forward), the MoE block's experts stay float; a LoRA model's
    adapters get gradients through the int8 path."""
    model = create_model("tiny-test-moe", device="cpu", int8_forward=True)
    mlps = [m for m in model.modules() if isinstance(m, layers.MLP)]
    moes = [m for m in model.modules() if isinstance(m, MoEMLP)]
    assert len(mlps) == 3 and len(moes) == 1 and all(m.int8_fwd for m in mlps)
    *_, lora, _, _ = _step("lora")
    adapters = {n: p.grad for n, p in lora.named_parameters() if "lora_" in n}
    assert len(adapters) == 48 and all(g is not None and torch.isfinite(g).all()
                                       for g in adapters.values())
    assert any(g.abs().max() > 0 for n, g in adapters.items() if n.endswith("lora_a"))


def test_int8_training_learns_on_the_cpu():
    """A few steps of ``create_model("tiny-test", int8_forward=True)`` on a fixed batch: the
    loss stays finite and falls, as the reference's ``test_int8_forward_training_step_learns``
    asks of its own."""
    model = create_model("tiny-test", device="cpu", int8_forward=True, seed=3)
    opt = make_optimizer(model.named_parameters(), 1e-3, weight_decay=0.0, grad_clip_norm=1.0)
    metrics, _ = port_steps(model, opt, steps=8)
    losses = [m["loss"] for m in metrics]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
