"""The port's CLOOB, AlignCLIP and chunked InfoNCE losses against the JAX package's
(``multimodal_tpu.losses``: ``cloob_loss``, ``align_loss``, ``global_contrastive``) on the same
numpy features, and the chunked loss against the port's dense ``clip_loss``.

Tolerances, the JAX package's own loss tests' (``tests/test_global_contrastive.py``), float32
on the CPU, where the two sides differ only in summation order: values rtol 1e-6; gradients
atol 1e-6 and rtol 1e-5.
"""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.losses import (
    align_clip_loss,
    chunked_clip_loss,
    clip_loss,
    cloob_loss,
    hopfield_retrieval,
    infoloob_loss,
    ring_clip_loss,
)

torch.set_num_threads(1)

VALUE = dict(rtol=1e-6)
GRAD = dict(atol=1e-6, rtol=1e-5)


def _features(b=12, e=16, seed=0, unit=True):
    rng = np.random.default_rng(seed)
    fi = rng.standard_normal((b, e), dtype=np.float32)
    ft = rng.standard_normal((b, e), dtype=np.float32)
    if unit:
        fi /= np.linalg.norm(fi, axis=-1, keepdims=True)
        ft /= np.linalg.norm(ft, axis=-1, keepdims=True)
    return fi, ft


def _port_value_and_grads(fn, *arrays):
    """fn(*tensors) and the gradient of its value with respect to each input."""
    args = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*args)
    out.backward()
    return out.item(), [a.grad.numpy() for a in args]


def _jax_value_and_grads(fn, *arrays):
    import jax
    import jax.numpy as jnp

    value, grads = jax.value_and_grad(fn, argnums=tuple(range(len(arrays))))(
        *[jnp.asarray(a) for a in arrays])
    return float(value), [np.asarray(g) for g in grads]


def _assert_match(got, want):
    np.testing.assert_allclose(got[0], want[0], **VALUE)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, **GRAD)


def test_hopfield_retrieval_matches_jax():
    import jax.numpy as jnp

    from multimodal_tpu.losses.cloob_loss import hopfield_retrieval as jax_retrieval

    state, stored = _features(b=9, seed=1)
    want = np.asarray(jax_retrieval(jnp.asarray(state), jnp.asarray(stored), 8.0))
    got = hopfield_retrieval(torch.from_numpy(state), torch.from_numpy(stored), 8.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("inv_tau", [30.0, 4.0])
def test_infoloob_matches_jax_and_masks_with_the_reference_value(inv_tau):
    from multimodal_tpu.losses.cloob_loss import infoloob_loss as jax_infoloob

    x, y = _features(seed=2)
    _assert_match(_port_value_and_grads(lambda a, b: infoloob_loss(a, b, inv_tau), x, y),
                  _jax_value_and_grads(lambda a, b: jax_infoloob(a, b, inv_tau), x, y))
    from multimodal_tpu_torch.losses.cloob_loss import _LARGE_NEG

    assert _LARGE_NEG == -10000.0


@pytest.mark.parametrize("inv_tau,scale_hopfield", [(30.0, 8.0), (10.0, 14.3)])
def test_cloob_value_and_grads_match_jax(inv_tau, scale_hopfield):
    from multimodal_tpu.losses.cloob_loss import cloob_loss as jax_cloob

    fi, ft = _features(seed=3)
    _assert_match(
        _port_value_and_grads(lambda a, b: cloob_loss(a, b, inv_tau, scale_hopfield), fi, ft),
        _jax_value_and_grads(lambda a, b: jax_cloob(a, b, inv_tau, scale_hopfield), fi, ft))


def _semantic(b=12, d=24, seed=4):
    s = np.random.default_rng(seed).standard_normal((b, d), dtype=np.float32)
    return s / np.linalg.norm(s, axis=-1, keepdims=True)


ALIGN_CASES = [
    # (with semantic features, separate_text, separate_image)
    (False, True, False), (False, False, True), (False, True, True), (False, False, False),
    (True, True, False), (True, False, True), (True, True, True), (True, False, False),
]


@pytest.mark.parametrize("semantic,separate_text,separate_image", ALIGN_CASES)
@pytest.mark.parametrize("normalize", [True, False])
def test_align_value_terms_and_grads_match_jax(semantic, separate_text, separate_image,
                                                normalize):
    """Every flag combination with and without semantic features; without them the flags
    change nothing (the reference's unweighted branch)."""
    from multimodal_tpu.losses.align_loss import align_clip_loss as jax_align

    fi, ft = _features(seed=5, unit=not normalize)
    sem = _semantic() if semantic else None
    kw = dict(alpha=1.0, beta=0.5, separate_text=separate_text, separate_image=separate_image,
              normalize=normalize)
    import jax.numpy as jnp

    jsem = None if sem is None else jnp.asarray(sem)
    tsem = None if sem is None else torch.from_numpy(sem)
    want_terms = jax_align(jnp.asarray(fi), jnp.asarray(ft), jnp.float32(2.6592),
                           semantic_features=jsem, **kw)
    got_terms = align_clip_loss(torch.from_numpy(fi), torch.from_numpy(ft),
                                torch.tensor(2.6592), semantic_features=tsem, **kw)
    assert set(got_terms) == {"total_loss", "clip_loss", "inModality_loss"}
    for k in got_terms:
        np.testing.assert_allclose(got_terms[k].item(), float(want_terms[k]), **VALUE, err_msg=k)
    _assert_match(
        _port_value_and_grads(lambda a, b, s: align_clip_loss(
            a, b, s, semantic_features=tsem, **kw)["total_loss"], fi, ft, np.float32(2.6592)),
        _jax_value_and_grads(lambda a, b, s: jax_align(
            a, b, s, semantic_features=jsem, **kw)["total_loss"], fi, ft, np.float32(2.6592)))


def test_align_without_semantics_ignores_the_separate_flags():
    fi, ft = _features(seed=6)
    args = (torch.from_numpy(fi), torch.from_numpy(ft), torch.tensor(2.0))
    values = {align_clip_loss(*args, separate_text=t, separate_image=i)["total_loss"].item()
              for t in (True, False) for i in (True, False)}
    assert len(values) == 1


def test_align_refuses_a_mesh():
    """The mesh form is ported: on a group of one rank, either form, it is the
    single-device loss, value and gradients (the world-2 and world-4 forms against the JAX
    package: ``tests/test_torch_dist_dp.py``)."""
    from torch_dist_workers import world_of_one

    fi, ft = _features()
    sem = np.random.default_rng(8).standard_normal((fi.shape[0], 5)).astype(np.float32)

    def run(**kw):
        leaves = [torch.tensor(a, requires_grad=True) for a in (fi, ft)]
        out = align_clip_loss(*leaves, torch.tensor(2.0),
                              semantic_features=torch.from_numpy(sem), **kw)["total_loss"]
        out.backward()
        return out.detach(), [t.grad for t in leaves]

    want, want_g = run()
    with world_of_one() as group:
        for local in (True, False):
            got, got_g = run(axis_name=group, local_loss=local)
            np.testing.assert_allclose(got.numpy(), want.numpy(), **VALUE)
            for a, b in zip(got_g, want_g):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)


CHUNK_CASES = [  # (batch, chunk_size, label_smoothing): 12 % 5 -> chunk 4; 12 % 7 -> chunk 6
    (12, 4, 0.0), (12, 5, 0.0), (12, 7, 0.1), (12, 12, 0.1), (12, 1024, 0.0), (12, 3, 0.2),
]


@pytest.mark.parametrize("b,chunk,label_smoothing", CHUNK_CASES)
@pytest.mark.parametrize("logit_scale", [2.6592, 5.0])
def test_chunked_value_and_grads_match_jax_chunked(b, chunk, label_smoothing, logit_scale):
    """5.0 is above the ln(100) clamp, where the scale's gradient is zero."""
    from multimodal_tpu.losses.global_contrastive import chunked_clip_loss as jax_chunked

    fi, ft = _features(b=b, seed=7, unit=False)
    kw = dict(chunk_size=chunk, label_smoothing=label_smoothing)
    _assert_match(
        _port_value_and_grads(lambda a, c, s: chunked_clip_loss(a, c, s, **kw), fi, ft,
                              np.float32(logit_scale)),
        _jax_value_and_grads(lambda a, c, s: jax_chunked(a, c, s, **kw), fi, ft,
                             np.float32(logit_scale)))


@pytest.mark.parametrize("b,chunk,label_smoothing", CHUNK_CASES)
@pytest.mark.parametrize("normalize", [True, False])
def test_chunked_matches_the_ports_dense_loss(b, chunk, label_smoothing, normalize):
    fi, ft = _features(b=b, seed=8, unit=not normalize)
    kw = dict(label_smoothing=label_smoothing, normalize=normalize)
    _assert_match(
        _port_value_and_grads(lambda a, c, s: chunked_clip_loss(a, c, s, chunk_size=chunk,
                                                                **kw), fi, ft,
                              np.float32(2.6592)),
        _port_value_and_grads(lambda a, c, s: clip_loss(a, c, s, **kw), fi, ft,
                              np.float32(2.6592)))


def test_chunked_holds_one_block_of_logits_in_the_backward(monkeypatch):
    """Each chunk body runs under a non-reentrant checkpoint: the backward recomputes every
    body once (the forward ran each once), so no [B, chunk] block outlives its body."""
    from multimodal_tpu_torch.losses import global_contrastive as gc

    calls = []
    body = gc._chunk_body

    def counted(*args):
        calls.append(torch.is_grad_enabled())
        return body(*args)

    monkeypatch.setattr(gc, "_chunk_body", counted)
    fi, ft = _features(b=12, seed=9)
    args = [torch.tensor(a, requires_grad=True) for a in (fi, ft)]
    loss = gc.chunked_clip_loss(*args, torch.tensor(2.6592), chunk_size=4)
    assert len(calls) == 6  # 3 chunks per direction
    loss.backward()
    assert len(calls) == 12  # each body recomputed once in the backward


def test_ring_refuses_naming_its_roadmap_item():
    """The ring and the chunked mesh forms are ported: on a group of one rank (no hop) they
    are the dense loss, value and gradients, label smoothing included (world 2 and 4:
    ``tests/test_torch_dist_dp.py``)."""
    from torch_dist_workers import world_of_one

    fi, ft = _features(b=8, seed=10)

    def run(fn):
        leaves = [torch.tensor(a, requires_grad=True) for a in (fi, ft)]
        scale = torch.tensor(2.6592, requires_grad=True)
        out = fn(*leaves, scale)
        out.backward()
        return out.detach(), [t.grad for t in leaves] + [scale.grad]

    want = run(lambda a, b, s: clip_loss(a, b, s, label_smoothing=0.1))
    with world_of_one() as group:
        for fn in (lambda a, b, s: ring_clip_loss(a, b, s, group, label_smoothing=0.1),
                   lambda a, b, s: chunked_clip_loss(a, b, s, chunk_size=4, axis_name=group,
                                                     label_smoothing=0.1)):
            got = run(fn)
            np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **VALUE)
            for a, b in zip(got[1], want[1]):
                np.testing.assert_allclose(a.numpy(), b.numpy(), **GRAD)
