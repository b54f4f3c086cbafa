"""The plain versions of the card's int8 kernels against the JAX package, jitted as the train
step and the serving encodes run it, on seeded numpy inputs: ``int8_gemm_reference`` (the
product with the rescale in each of the kernel's three store forms) against
``multimodal_tpu/ops/quant.py``'s ``_int8_product`` and ``int8_dense_train``, and
``quantize_weight_reference`` (the column form of the quantize) against its
``quantize_weight``; then the shapes ``int8_gemm`` refuses on either device.

Limits: bit for bit everywhere. M runs 1, 17 and 100 (no multiple of a 128-row tile), K
includes 200 (8 mod 16, the kernel's plain-load path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.ops import quant as jq
from multimodal_tpu_torch.ops import quant as tq

OUT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (store form, out dtypes): the product scaled; the bias in one fused multiply-add; the bias
# added after the rounding (the bfloat16 train path's y + b.astype(x.dtype))
FORMS = [("scale", "float32"), ("scale", "bfloat16"), ("fma", "float32"), ("fma", "bfloat16"),
         ("round-add", "bfloat16")]


def _np(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _inputs(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32) * 2
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    b = rng.standard_normal(n).astype(np.float32) * 0.1
    return x, w, b


def _jax_out(form, out, x, w, b):
    jdtype = OUT[out][0]
    if form == "scale":
        run = jax.jit(lambda x, w: jq._int8_product(x, w).astype(jdtype))
        return run(x, w)
    if form == "fma":
        run = jax.jit(lambda x, w, b: (jq._int8_product(x, w) + b).astype(jdtype))
        return run(x, w, b)
    run = jax.jit(lambda x, w, b: jq.int8_dense_train(x, w) + b.astype(jnp.bfloat16))
    return run(jnp.asarray(x).astype(jnp.bfloat16), w, b)


@pytest.mark.parametrize("form,out", FORMS)
@pytest.mark.parametrize("k,n", [(64, 96), (200, 48)])
@pytest.mark.parametrize("m", [1, 17, 100])
def test_int8_gemm_reference_is_jitted_jax(m, k, n, form, out):
    x, w, b = _inputs(m, k, n, m * 1000 + k + n)
    want = _jax_out(form, out, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    xt = torch.from_numpy(x)
    if form == "round-add":  # the train path quantizes the bfloat16 activations
        xt = xt.to(torch.bfloat16)
    xq, sx = tq.quantize_rows(xt, "reciprocal")
    wq, sw = tq.quantize_weight_reference(torch.from_numpy(w), "reciprocal")
    bias = None if form == "scale" else torch.from_numpy(b)
    got = tq.int8_gemm_reference(xq, wq, sx, sw, bias, out_dtype=OUT[out][1],
                                 round_before_bias=form == "round-add")
    assert got.dtype == OUT[out][1] and got.shape == (m, n)
    assert np.array_equal(got.float().numpy(), _np(want))
    # the wrapper runs the same plain version on the CPU
    again = tq.int8_gemm(xq, wq, sx, sw, bias, out_dtype=OUT[out][1],
                         round_before_bias=form == "round-add")
    assert torch.equal(again, got)


@pytest.mark.parametrize("form", tq.FORMS)
@pytest.mark.parametrize("shape", [(64, 96), (200, 48), (37, 13)])
def test_quantize_weight_reference_is_the_jax_quantize_weight(shape, form):
    """The column form's plain version on an untransposed [in, out] weight: the jitted
    reference ("reciprocal") and the eager one ("divide"); codes [out, in], the reference's
    transposed; a zero column and a column of exact ties."""
    w = np.random.default_rng(shape[0]).standard_normal(shape).astype(np.float32) * 0.05
    w[:, 0] = 0.0
    w[:, 1] = np.resize(np.float32([127.0, 0.5, 1.5, 2.5, -2.5, 3.5, -0.5, 126.5]), shape[0])
    run = jax.jit(jq.quantize_weight) if form == "reciprocal" else jq.quantize_weight
    want_q, want_s = run(jnp.asarray(w))
    got_q, got_s = tq.quantize_weight_reference(torch.from_numpy(w), form)
    assert got_q.shape == (shape[1], shape[0]) and got_q.dtype == torch.int8
    assert np.array_equal(got_q.numpy(), np.asarray(want_q).T)
    assert np.array_equal(got_s.numpy(), np.asarray(want_s))
    assert not got_q[0].any()
    assert got_q[1, :8].tolist()[:shape[0]] == [127, 0, 2, 2, -2, 4, 0, 126][:shape[0]]
    assert torch.equal(tq.quantize_weight(torch.from_numpy(w), form)[0], got_q)


def _operands(m=16, k=64, n=32):
    g = torch.Generator().manual_seed(0)
    return (torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8),
            torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8),
            torch.rand(m, generator=g), torch.rand(n, generator=g))


@pytest.mark.parametrize("case,match", [
    ("k12", "multiples of 8"),
    ("n20", "multiples of 8"),
    ("int32", "int8"),
    ("k-mismatch", "int8"),
    ("sx-shape", "sx must be"),
    ("sw-float64", "float32"),
    ("bias-shape", "bias must be"),
    ("after-without-bias", "needs a bias"),
    ("meta", "cuda or cpu"),
])
def test_int8_gemm_refuses_what_the_kernel_does_not_take(case, match):
    """K and N multiples of 8, int8 [M, K] and [N, K] operands, float32 scales of M and N,
    a bias of N; on either device (the plain version refuses what the kernel refuses)."""
    aq, bq, sx, sw = _operands()
    kw, bias = {"out_dtype": torch.float32}, None
    if case == "k12":
        aq, bq = aq[:, :12].contiguous(), bq[:, :12].contiguous()
    elif case == "n20":
        bq, sw = bq[:20].contiguous(), sw[:20].contiguous()
    elif case == "int32":
        aq = aq.to(torch.int32)
    elif case == "k-mismatch":
        bq = bq[:, :56].contiguous()
    elif case == "sx-shape":
        sx = sx[:8]
    elif case == "sw-float64":
        sw = sw.double()
    elif case == "bias-shape":
        bias = torch.zeros(31)
    elif case == "after-without-bias":
        kw.update(out_dtype=torch.bfloat16, round_before_bias=True)
    elif case == "meta":
        aq, bq, sx, sw = (t.to("meta") for t in (aq, bq, sx, sw))
    with pytest.raises(ValueError, match=match):
        tq.int8_gemm(aq, bq, sx, sw, bias, **kw)


def test_rescale_is_the_plain_version_on_the_cpu():
    aq, bq, sx, sw = _operands()
    acc = tq.int8_product(aq, bq)
    bias = torch.randn(32, generator=torch.Generator().manual_seed(1))
    for b in (None, bias):
        got = tq.rescale(acc, sx, sw, b, out_dtype=torch.bfloat16)
        assert torch.equal(got, tq.rescale_reference(acc, sx, sw, b, out_dtype=torch.bfloat16))
        assert torch.equal(got, tq.int8_gemm(aq, bq, sx, sw, b, out_dtype=torch.bfloat16))
