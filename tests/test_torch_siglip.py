"""The port's SigLIP loss (``losses/siglip_loss.py``) and its train step against the JAX
package's: the dense loss's value and gradients with ``normalize`` and ``scale_is_log`` both
ways, and two SigLIP steps of a ``siglip=True`` model (the logit bias trained, the logit
scale left unclamped). Inputs and weights come from seeded numpy generators (weights through
``load_jax_params``). Tolerances: the loss 1e-5 (rtol; atol 1e-5 on gradients), the train
step ``tests/test_torch_train_step.py``'s.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.losses.siglip_loss import siglip_loss as jax_siglip_loss
from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu_torch.losses import siglip_loss
from multimodal_tpu_torch.models import create_model, load_jax_params
from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
from multimodal_tpu_torch.train import make_optimizer, make_schedule, make_train_step
from torch_jax_models import (
    OPT,
    assert_grads_close,
    assert_params_close,
    jax_steps,
    port_steps,
    random_params,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("scale_is_log", [True, False])
def test_siglip_loss_value_and_grads_match_jax(normalize, scale_is_log):
    rng = np.random.default_rng(0)
    fi, ft = (rng.standard_normal((6, 8)).astype(np.float32) for _ in range(2))
    if not normalize:
        fi, ft = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (fi, ft))
    scale = np.float32(np.log(10.0) if scale_is_log else 10.0)
    bias = np.float32(-10.0)
    kw = dict(normalize=normalize, scale_is_log=scale_is_log)
    want, grads = jax.value_and_grad(
        lambda *a: jax_siglip_loss(*a, **kw), argnums=(0, 1, 2, 3))(
        jnp.asarray(fi), jnp.asarray(ft), jnp.float32(scale), jnp.float32(bias))
    leaves = [torch.tensor(v, requires_grad=True) for v in (fi, ft, scale, bias)]
    got = siglip_loss(*leaves, **kw)
    got.backward()
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    for leaf, w in zip(leaves, grads):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_siglip_loss_refuses_the_mesh_form():
    x = torch.zeros(2, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 9"):
        siglip_loss(x, x, torch.tensor(0.0), torch.tensor(0.0), axis_name="data")


def test_siglip_step_needs_the_logit_bias():
    model = create_model("tiny-test", device="cpu")
    opt = make_optimizer(model.named_parameters(), 1e-3)
    with pytest.raises(ValueError, match="logit_bias"):
        make_train_step(model, opt, loss_type="siglip")


@functools.lru_cache(maxsize=None)
def _runs():
    from multimodal_tpu.train import make_optimizer as jax_optimizer
    from multimodal_tpu.train import make_schedule as jax_schedule

    jm = jax_create_model("tiny-test", siglip=True)
    params = random_params(jm)
    params["params"]["logit_scale"] = np.float32(5.0)  # above ln(100): a clip step clamps it
    tx = jax_optimizer(jax_schedule("cosine", 1e-2, 2, 50), **OPT)
    want = jax_steps(jm, params, tx, loss_type="siglip")
    model = load_jax_params(create_model("tiny-test", siglip=True, device="cpu"), params)
    opt = make_optimizer(model.named_parameters(), make_schedule("cosine", 1e-2, 2, 50), **OPT)
    got = port_steps(model, opt, loss_type="siglip")
    return want, got, model


def test_siglip_step_matches_jax():
    """Loss, logit scale and bias, grad norm, every gradient leaf of both steps and every
    parameter after them. The logit scale starts at 5.0, above ln(100): a SigLIP step leaves
    it unclamped, as JAX's does."""
    (want, want_grads, want_params), (got, got_grads), model = _runs()
    for w, g in zip(want, got):
        for k in ("loss", "logit_scale", "logit_bias", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for w, g in zip(want_grads, got_grads):
        assert_grads_close(g, jax_params_to_port(jax.device_get(w)))
    assert_params_close(model, jax_params_to_port(jax.device_get(want_params)))
    assert model.logit_bias.item() != -10.0
    assert model.logit_scale.item() > 4.6052  # above the clip loss's clamp
