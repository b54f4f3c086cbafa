"""The port's CLIP InfoNCE loss against ``multimodal_tpu.losses.clip_loss`` on the same numpy
features: values and gradients, float32, atol 1e-6 and rtol 1e-5 (the two differ only in
summation order)."""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.losses import clip_loss, contrastive_logits, cross_entropy
from multimodal_tpu_torch.losses.clip_loss import LOGIT_CLAMP

torch.set_num_threads(1)

TOL = dict(atol=1e-6, rtol=1e-5)


def _features(b=6, e=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, e), dtype=np.float32),
            rng.standard_normal((b, e), dtype=np.float32))


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
def test_cross_entropy_matches_jax(label_smoothing):
    import jax.numpy as jnp

    from multimodal_tpu.losses.clip_loss import cross_entropy as jax_ce

    rng = np.random.default_rng(1)
    logits = rng.standard_normal((5, 7), dtype=np.float32) * 3
    labels = rng.integers(0, 7, 5)
    want = np.asarray(jax_ce(jnp.asarray(logits), jnp.asarray(labels), label_smoothing))
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels), label_smoothing)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got.dtype == torch.float32


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("logit_scale", [2.6592, 5.0])
def test_clip_loss_value_and_grads_match_jax(normalize, label_smoothing, logit_scale):
    """5.0 is above the ln(100) clamp, where the scale's gradient is zero."""
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.losses.clip_loss import clip_loss as jax_clip_loss

    fi, ft = _features()
    if not normalize:
        fi, ft = fi / np.linalg.norm(fi, axis=-1, keepdims=True), ft / np.linalg.norm(
            ft, axis=-1, keepdims=True)
    kw = dict(label_smoothing=label_smoothing, normalize=normalize)
    want, want_g = jax.value_and_grad(
        lambda a, b, s: jax_clip_loss(a, b, s, **kw), argnums=(0, 1, 2))(
        jnp.asarray(fi), jnp.asarray(ft), jnp.float32(logit_scale))
    args = [torch.from_numpy(fi).requires_grad_(), torch.from_numpy(ft).requires_grad_(),
            torch.tensor(logit_scale, dtype=torch.float32, requires_grad=True)]
    got = clip_loss(*args, **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), **TOL)
    for t, g in zip(args, want_g):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL)
    if logit_scale > LOGIT_CLAMP:
        assert args[2].grad.item() == 0.0


def test_contrastive_logits_single_device():
    fi, ft = (torch.from_numpy(a) for a in _features(b=4))
    li, lt, labels = contrastive_logits(fi, ft, 2.0)
    torch.testing.assert_close(li, 2.0 * fi @ ft.T)
    torch.testing.assert_close(lt, li.T)
    assert labels.tolist() == [0, 1, 2, 3]


def test_left_out_forms_raise():
    fi, ft = (torch.from_numpy(a) for a in _features(b=4))
    with pytest.raises(NotImplementedError, match="item 9"):
        clip_loss(fi, ft, torch.tensor(1.0), axis_name="data")
    with pytest.raises(NotImplementedError, match="item 9"):
        contrastive_logits(fi, ft, 2.0, axis_name="data")
