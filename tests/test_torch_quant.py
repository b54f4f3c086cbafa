"""The port's int8 primitives (``multimodal_tpu_torch/ops/quant.py``, their plain versions on
the CPU) against the JAX package's ``multimodal_tpu/ops/quant.py``, run jitted as the train
step and the serving encodes run it, on seeded numpy inputs.

Limits: the codes, the scales, ``int8_dense_train``'s forward and dx, its bias's place in the
sum, and ``int8_matmul`` bit for bit; dw in float32 within 1e-6 x max|dw| (float32 sums in
another order). A bfloat16 bias gradient is the exact column sum rounded once (within 2^-8 of
it); the reference's bfloat16 reduction accumulates in bfloat16 and lands up to 2% of max|db|
off at 60 rows, so the two are held within 5e-2 x max|db|. The eager reference, as
``quantize_clip_params`` runs at load time, divides by 127 where the jitted one multiplies by
float32(1/127): the port names the form.
"""

import fractions

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import quant as jq
from multimodal_tpu_torch.ops import quant as tq

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if a.dtype == jnp.bfloat16 \
        else np.asarray(a)


def _t(a, dtype=None) -> torch.Tensor:
    t = torch.from_numpy(np.array(_np(a)))
    return t if dtype is None else t.to(dtype)


def _rows(shape, jdtype, seed):
    """Random rows with a zero row and a row of exact .5 ties (amax 127, so both scale forms
    give 1.0 and x / scale lands on k + 0.5)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    flat = x.reshape(-1, shape[-1])
    flat[0] = 0.0
    flat[1] = np.resize(np.float32([127.0, 0.5, 1.5, 2.5, -2.5, 3.5, -0.5, 126.5]), shape[-1])
    return jnp.asarray(x).astype(jdtype)


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
@pytest.mark.parametrize("shape", [(40, 64), (3, 17, 96), (6, 13)])
def test_quantize_rows_is_jitted_jax_bit_for_bit(jdtype, tdtype, shape):
    x = _rows(shape, jdtype, sum(shape))
    want_q, want_s = jax.jit(jq.quantize_rows)(x)
    got_q, got_s = tq.quantize_rows(_t(x, tdtype), "reciprocal")
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert np.array_equal(got_q.numpy(), np.asarray(want_q))
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    flat = got_q.reshape(-1, shape[-1])
    assert not flat[0].any() and flat[1, :8].tolist()[:shape[-1]] == [
        127, 0, 2, 2, -2, 4, 0, 126][:shape[-1]]


@pytest.mark.parametrize("shape", [(64, 256), (96, 40)])
def test_quantize_weight_forms_are_the_jitted_and_the_eager_reference(shape):
    w = jnp.asarray(np.random.default_rng(shape[1]).standard_normal(shape).astype(np.float32)
                    * 0.05)
    for form, run in (("reciprocal", jax.jit(jq.quantize_weight)), ("divide", jq.quantize_weight)):
        want_q, want_s = run(w)
        got_q, got_s = tq.quantize_weight(_t(w), form)
        assert got_q.shape == (shape[1], shape[0])  # [out, in]: the reference's transposed
        assert np.array_equal(got_q.numpy(), np.asarray(want_q).T), form
        assert np.array_equal(got_s.numpy(), np.asarray(want_s)), form


def test_eager_and_jitted_reference_scales_differ_and_the_port_names_each():
    """Under jit XLA turns / 127 into * float32(1/127): the two differ by an ulp at some
    columns. The port's load-time weight quantize ("divide") is the eager one, its train and
    activation quantize ("reciprocal") the jitted one."""
    w = jnp.asarray(np.random.default_rng(0).standard_normal((128, 512)).astype(np.float32))
    eager_q, eager_s = jq.quantize_weight(w)
    jit_q, jit_s = jax.jit(jq.quantize_weight)(w)
    assert not np.array_equal(np.asarray(eager_s), np.asarray(jit_s))
    assert np.abs(np.asarray(eager_s) - np.asarray(jit_s)).max() <= np.spacing(
        np.asarray(eager_s)).max()
    div_q, div_s = tq.quantize_weight(_t(w), "divide")
    rec_q, rec_s = tq.quantize_weight(_t(w), "reciprocal")
    assert np.array_equal(div_s.numpy(), np.asarray(eager_s))
    assert np.array_equal(rec_s.numpy(), np.asarray(jit_s))
    assert np.array_equal(div_q.numpy(), np.asarray(eager_q).T)
    assert np.array_equal(rec_q.numpy(), np.asarray(jit_q).T)
    with pytest.raises(ValueError, match="scale form"):
        tq.quantize_rows(_t(w), "round")


def test_int8_product_is_the_exact_int32_product():
    rng = np.random.default_rng(1)
    a = rng.integers(-127, 128, (5, 24)).astype(np.int8)
    b = rng.integers(-127, 128, (7, 24)).astype(np.int8)
    got = tq.int8_product(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def _dense_train_vjp(jdtype, with_bias):
    def f(x, w, b):
        y = jq.int8_dense_train(x, w)
        return y + b.astype(x.dtype) if with_bias else y
    return jax.jit(lambda x, w, b, g: (f(x, w, b), jax.vjp(f, x, w, b)[1](g)))


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_dense_train_is_jitted_jax(jdtype, tdtype, with_bias):
    """Forward and dx bit for bit (dx on the int8 path), dw float32 within 1e-6 x max|dw|;
    in float32 XLA contracts the bias add into the rescale's last multiply, and the port's
    float32 bias is that one fused multiply-add."""
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 30, 64)).astype(np.float32)).astype(jdtype)
    w = jnp.asarray(rng.standard_normal((64, 256)).astype(np.float32) * 0.1)
    b = jnp.asarray(rng.standard_normal(256).astype(np.float32) * 0.1)
    g = jnp.asarray(rng.standard_normal((2, 30, 256)).astype(np.float32)).astype(jdtype)
    y, (dx, dw, db) = _dense_train_vjp(jdtype, with_bias)(x, w, b, g)
    xt, wt, bt = _t(x, tdtype).requires_grad_(), _t(w).requires_grad_(), _t(b).requires_grad_()
    yt = tq.int8_dense_train(xt, wt, bt if with_bias else None)
    yt.backward(_t(g, tdtype))
    assert yt.dtype == tdtype and xt.grad.dtype == tdtype and wt.grad.dtype == torch.float32
    assert np.array_equal(yt.detach().float().numpy(), _np(y))
    assert np.array_equal(xt.grad.float().numpy(), _np(dx))
    dw = np.asarray(dw)
    assert np.abs(wt.grad.numpy() - dw).max() <= 1e-6 * np.abs(dw).max()
    if with_bias:
        db, got_db = np.asarray(db), bt.grad.numpy()
        if tdtype == torch.float32:
            assert np.abs(got_db - db).max() <= 1e-6 * np.abs(db).max()
        else:  # the exact column sum rounded once; the reference accumulates in bfloat16
            exact = _np(g).astype(np.float64).reshape(-1, 256).sum(axis=0)
            assert np.all(np.abs(got_db - exact) <= 2.0 ** -8 * np.abs(exact) + 1e-6)
            assert np.abs(got_db - db).max() <= 5e-2 * np.abs(db).max()
    else:
        assert bt.grad is None


@pytest.mark.parametrize("jdtype,tdtype", DTYPES)
@pytest.mark.parametrize("out", [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_int8_matmul_is_jitted_jax(jdtype, tdtype, out, with_bias):
    """The serving product: the weight quantized eagerly at load (the port's "divide"), the
    activations inside the jitted encode; bias in float32 by one fused multiply-add, one
    rounding to out_dtype."""
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.standard_normal((3, 20, 64)).astype(np.float32)).astype(jdtype)
    w = jnp.asarray(rng.standard_normal((64, 192)).astype(np.float32) * 0.1)
    b = jnp.asarray(rng.standard_normal(192).astype(np.float32))
    wq, ws = jq.quantize_weight(w)
    want = jax.jit(lambda x, wq, ws, b: jq.int8_matmul(x, wq, ws, bias=b if with_bias else None,
                                                        out_dtype=out[0]))(x, wq, ws, b)
    wqt, wst = tq.quantize_weight(_t(w), "divide")
    got = tq.int8_matmul(_t(x, tdtype), wqt, wst, _t(b) if with_bias else None,
                         out_dtype=out[1])
    assert got.dtype == out[1] and got.shape == (3, 20, 192)
    assert np.array_equal(got.float().numpy(), _np(want))


def _round_f32(value: fractions.Fraction) -> np.float32:
    """The float32 nearest to an exact rational, ties to even."""
    near = np.float32(float(value))
    cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
    dist = [abs(fractions.Fraction(float(c)) - value) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(np.float32(c).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """The plain version's fused multiply-add is the exact a * b + c rounded once to float32,
    including cancellations and sums an ulp from a tie."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (-(a.astype(np.float64) * b) + rng.standard_normal(400) * 1e-6).astype(np.float32)
    c[:200] = rng.standard_normal(200).astype(np.float32)
    got = tq.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = [_round_f32(fractions.Fraction(float(x)) * fractions.Fraction(float(y))
                       + fractions.Fraction(float(z))) for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.float32(want))


def test_ops_run_on_cpu_or_cuda_tensors_only():
    x = torch.zeros(4, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tq.quantize_rows(x)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tq.rescale(torch.zeros(4, 8, dtype=torch.int32, device="meta"), x[:, 0], x[0],
                   out_dtype=torch.float32)
