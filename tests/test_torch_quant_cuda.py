"""The int8 kernels against their plain PyTorch versions on the card, bit for bit: the row
quantize and its column form (``ops/csrc/quant.cu``: codes and scales in both scale forms,
float32 and bfloat16, a zero row and rows of exact .5 ties) and ``int8_gemm``
(``ops/csrc/int8_gemm.cu``: the wgmma product with its rescale, at ViT-B/32's MLP shapes and at
M = 1, 17 and 12800, K = 8 mod 16 included, every store form, float32 and bfloat16 out); a
second launch gives the same bits; small M with unit scales is the exact int32 product; and
the two int8 entry points, ``int8_dense_train`` (forward, dx bit for bit; dw in float32 within
1e-6 x max|dw|) and ``int8_matmul``, on the card against the same call on the CPU. Every test
needs a CUDA device and skips without one; nothing here imports JAX.

    python -m pytest tests/test_torch_quant_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import launches
from multimodal_tpu_torch.ops import quant as q


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rows(shape, dtype, seed, device):
    """Random rows with row 0 all zeros and row 1 of exact .5 ties (amax 127, so the scale is
    1.0 in both forms and x / scale lands on k + 0.5)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(*shape, generator=g) * 3
    x[0] = 0.0
    ties = torch.tensor([127.0, 0.5, 1.5, 2.5, -2.5, 3.5, -0.5, 126.5])
    x[1] = ties.repeat(shape[1] // 8 + 1)[: shape[1]]
    return x.to(dtype).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", q.FORMS)
@pytest.mark.parametrize("shape", [(300, 768), (64, 3072), (37, 13), (50, 2048), (40, 5000),
                                   (8, 20000)])
def test_cuda_quantize_rows_is_the_plain_version(cuda_device, dtype, form, shape):
    x = _rows(shape, dtype, shape[0], cuda_device)
    launches.reset_launch_counts()
    codes, scale = q.quantize_rows(x, form)
    again = q.quantize_rows(x, form)
    torch.cuda.synchronize()
    assert launches.launch_counts()["quantize_rows"] == 2
    want_codes, want_scale = q.quantize_rows_reference(x, form)
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    assert torch.equal(again[0], codes) and torch.equal(again[1], scale)
    assert not codes[0].any() and scale[0].item() == pytest.approx(1e-12 / 127, rel=1e-6)
    if shape[1] >= 8:
        assert codes[1, :8].tolist() == [127, 0, 2, 2, -2, 4, 0, 126]  # ties to even


@pytest.mark.cuda
@pytest.mark.parametrize("form", q.FORMS)
@pytest.mark.parametrize("shape", [(768, 3072), (3072, 768), (512, 2048), (2048, 512), (100, 44),
                                   (37, 13)])
def test_cuda_quantize_weight_is_the_plain_version(cuda_device, form, shape):
    """The column form: an [in, out] weight read as it lies (column 0 zero, column 1 ties),
    codes written [out, in]; in multiples of 16 rows the 16-byte stores, else the byte stores;
    a column count off a multiple of 4 the scalar loads."""
    w = _rows(shape[::-1], torch.float32, shape[1], cuda_device).t().contiguous()
    launches.reset_launch_counts()
    codes, scale = q.quantize_weight(w, form)
    again = q.quantize_weight(w, form)
    torch.cuda.synchronize()
    assert launches.launch_counts()["quantize_rows"] == 2
    want_codes, want_scale = q.quantize_weight_reference(w, form)
    assert codes.shape == (shape[1], shape[0]) and codes.is_contiguous()
    assert torch.equal(codes, want_codes) and torch.equal(scale, want_scale)
    assert torch.equal(again[0], codes) and torch.equal(again[1], scale)


GEMM_SHAPES = [(k, n) for k, n in ((768, 3072), (3072, 768), (512, 2048), (2048, 512))]
STORES = [(None, False), ("bias", False), ("bias", True)]  # the kernel's three store forms


def _gemm_operands(m, k, n, seed, device):
    g = torch.Generator().manual_seed(seed)
    aq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8)
    bq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    sx = torch.rand(m, generator=g) * 0.05
    sw = torch.rand(n, generator=g) * 1e-3
    bias = torch.randn(n, generator=g) * 0.02
    return [t.to(device) for t in (aq, bq, sx, sw, bias)]


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("m", [1, 17, 12800])
@pytest.mark.parametrize("k,n", GEMM_SHAPES + [(200, 48)])
def test_cuda_int8_gemm_is_the_plain_version(cuda_device, out_dtype, store, m, k, n):
    """Bit for bit at every model shape and tail, a second launch the same bits; K = 200 (8 mod
    16) takes the kernel's plain-load path."""
    with_bias, after = store
    if after and out_dtype != torch.bfloat16:
        pytest.skip("the bias after the rounding is the bfloat16 train path's form")
    aq, bq, sx, sw, bias = _gemm_operands(m, k, n, m + k + n, cuda_device)
    bias = bias if with_bias else None
    kw = dict(out_dtype=out_dtype, round_before_bias=after)
    launches.reset_launch_counts()
    got = q.int8_gemm(aq, bq, sx, sw, bias, **kw)
    again = q.int8_gemm(aq, bq, sx, sw, bias, **kw)
    torch.cuda.synchronize()
    assert launches.launch_counts()["int8_gemm"] == 2
    want = q.int8_gemm_reference(aq, bq, sx, sw, bias, **kw)
    assert got.dtype == out_dtype and got.shape == (m, n)
    assert torch.equal(got, want) and torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 17, 64])
def test_cuda_int8_product_pads_small_m(cuda_device, m):
    """Small M needs no padding: with unit scales and a float32 output the kernel's result is
    the exact int32 product (|acc| <= 512 x 127^2 < 2^24); K off a multiple of 8 is refused."""
    g = torch.Generator().manual_seed(m)
    aq = torch.randint(-127, 128, (m, 512), generator=g, dtype=torch.int8)
    bq = torch.randint(-127, 128, (2048, 512), generator=g, dtype=torch.int8)
    one_m, one_n = torch.ones(m, device=cuda_device), torch.ones(2048, device=cuda_device)
    got = q.int8_gemm(aq.to(cuda_device), bq.to(cuda_device), one_m, one_n,
                      out_dtype=torch.float32)
    assert got.shape == (m, 2048)
    assert torch.equal(got.cpu().to(torch.int64), aq.long() @ bq.long().t())
    assert torch.equal(q.int8_product(aq.to(cuda_device), bq.to(cuda_device)).cpu(),
                       aq.int() @ bq.int().t())
    with pytest.raises(ValueError, match="multiples of 8"):
        q.int8_gemm(aq[:, :500].contiguous().to(cuda_device),
                    bq[:, :500].contiguous().to(cuda_device), one_m, one_n,
                    out_dtype=torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_int8_dense_train_is_the_cpu_version(cuda_device, dtype):
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((4, 50, 768)).astype(np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((768, 3072)).astype(np.float32) * 0.03)
    b = torch.from_numpy(rng.standard_normal(3072).astype(np.float32) * 0.02)
    g = torch.from_numpy(rng.standard_normal((4, 50, 3072)).astype(np.float32)).to(dtype)
    out = {}
    for dev in ("cpu", cuda_device):
        xs, ws, bs = (t.detach().to(dev).clone().requires_grad_() for t in (x, w, b))
        y = q.int8_dense_train(xs, ws, bs)
        y.backward(g.to(dev))
        out[str(dev)] = [t.detach().cpu() for t in (y, xs.grad, ws.grad, bs.grad)]
    (y_c, dx_c, dw_c, db_c), (y_g, dx_g, dw_g, db_g) = out["cpu"], out[str(cuda_device)]
    assert torch.equal(y_g, y_c) and torch.equal(dx_g, dx_c)
    assert dw_g.dtype == torch.float32
    assert (dw_g - dw_c).abs().max() <= 1e-6 * dw_c.abs().max()
    assert (db_g.float() - db_c.float()).abs().max() <= (1e-6 if dtype == torch.float32
                                                         else 1e-2) * db_c.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 17, 256])
def test_cuda_int8_matmul_is_the_cpu_version(cuda_device, out_dtype, m):
    rng = np.random.default_rng(m)
    x = torch.from_numpy(rng.standard_normal((m, 512)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((512, 2048)).astype(np.float32) * 0.04)
    b = torch.from_numpy(rng.standard_normal(2048).astype(np.float32) * 0.02)
    got, want = [], []
    for dev, into in ((cuda_device, got), ("cpu", want)):
        wq, ws = q.quantize_weight(w.to(dev), "divide")
        for bias in (None, b.to(dev)):
            into.append(q.int8_matmul(x.to(dev), wq, ws, bias, out_dtype=out_dtype).cpu())
    for a, r in zip(got, want):
        assert a.dtype == out_dtype and torch.equal(a, r)
