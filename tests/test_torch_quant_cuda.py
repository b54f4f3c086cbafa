"""The int8 kernels (``ops/csrc/quant.cu``: the row quantize and the rescale) against their
plain PyTorch versions on the card, bit for bit: codes, scales and rescaled outputs, in both
scale forms, float32 and bfloat16, a zero row and rows of exact .5 ties; a second launch gives
the same bits; the int8 product's padded-M path (M = 1 and 17, under ``torch._int_mm``'s
M > 16) against the exact int32 product; and the two int8 entry points, ``int8_dense_train``
(forward, dx bit for bit; dw in float32 within 1e-6 x max|dw|) and ``int8_matmul``, on the
card against the same call on the CPU. Every test needs a CUDA device and skips without one;
nothing here imports JAX.

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
@pytest.mark.parametrize("shape", [(300, 768), (64, 3072), (37, 13)])
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
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
def test_cuda_rescale_is_the_plain_version(cuda_device, out_dtype, with_bias):
    g = torch.Generator().manual_seed(7)
    m, k, n = 300, 768, 3072
    aq = torch.randint(-127, 128, (m, k), generator=g, dtype=torch.int8).to(cuda_device)
    bq = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8).to(cuda_device)
    acc = q.int8_product(aq, bq)
    sx = (torch.rand(m, generator=g) * 0.05).to(cuda_device)
    sw = (torch.rand(n, generator=g) * 0.001).to(cuda_device)
    bias = torch.randn(n, generator=g).to(cuda_device) if with_bias else None
    launches.reset_launch_counts()
    got = q.rescale(acc, sx, sw, bias, out_dtype=out_dtype)
    again = q.rescale(acc, sx, sw, bias, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert launches.launch_counts()["int8_rescale"] == 2
    want = q.rescale_reference(acc, sx, sw, bias, out_dtype=out_dtype)
    assert got.dtype == out_dtype and torch.equal(got, want) and torch.equal(again, got)
    assert torch.equal(acc.cpu(), aq.cpu().int() @ bq.cpu().int().t())


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 17, 64])
def test_cuda_int8_product_pads_small_m(cuda_device, m):
    g = torch.Generator().manual_seed(m)
    aq = torch.randint(-127, 128, (m, 512), generator=g, dtype=torch.int8)
    bq = torch.randint(-127, 128, (2048, 512), generator=g, dtype=torch.int8)
    got = q.int8_product(aq.to(cuda_device), bq.to(cuda_device))
    assert got.shape == (m, 2048) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), aq.int() @ bq.int().t())
    with pytest.raises(ValueError, match="multiples of 8"):
        q.int8_product(aq[:, :500].contiguous().to(cuda_device),
                       bq[:, :500].contiguous().to(cuda_device))


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
