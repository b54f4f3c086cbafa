"""The gradient of block attention in the PyTorch port: the ``BlockAttention`` Function's
backward (the plain version on a CPU tensor) against ``jax.vjp`` of the JAX package's
``block_attention`` (its Pallas backward kernels in interpret mode on the CPU), and the
hand-written CUDA backward kernel against the plain version on the card.

Tolerances. float32: atol = 3e-4 x max(1, max|g|), rtol = 1e-3, the JAX package's own VJP
test (tests/test_block_attention.py); the two sides differ only in summation order.
bfloat16: atol = 2e-2 x max(1, max|g|): both round at the same points, and a sum taken in
another order can flip a bf16 rounding. The floor of 1 covers the key-bias gradient, which
is zero in exact arithmetic (softmax ignores a per-row constant), so both sides hold only
rounding noise there. On the card, the kernel against the plain version: every per-token
output within 1e-4 x max|plain| in float32 and 2e-2 x max|plain| in bfloat16.

The kernel's projection GEMMs run on the tensor cores, in float32 as 3xTF32: their arithmetic
is emulated on the CPU at ViT-B/32 widths (the K = 3W dx product and the do product, the
forward's LN-transformed q product in the NN form, and the MLP backward's dW1 in the TN form
over a ragged T = 3000 in three splits; k-step by k-step with the small terms first) and
holds 1e-4 x max|float64| where one TF32 product does not.

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_block_attention_bwd.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import block_attention as ba
from multimodal_tpu_torch.ops import block_mlp as bm
from multimodal_tpu_torch.ops import launches

torch.set_num_threads(1)

NAMES = ["dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo"]


def _inputs(b, s, w, seed=0):
    """x, the eight weights and biases, and a cotangent dy, as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    ws = []
    for _ in range(4):
        ws.append(rng.standard_normal((w, w), dtype=np.float32) * w ** -0.5)
        ws.append(rng.standard_normal((w,), dtype=np.float32) * 0.02)
    dy = rng.standard_normal((b, s, w), dtype=np.float32)
    return x, ws, dy


@functools.lru_cache(maxsize=None)
def _jax_grads(b, s, w, heads, causal, dtype_name):
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_attention import block_attention

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    x, ws, dy = _inputs(b, s, w)
    args = [jnp.asarray(a, dt) for a in [x, *ws]]
    _, vjp = jax.vjp(lambda *a: block_attention(*a, heads=heads, causal=causal), *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, dt))]


def _port_grads(b, s, w, heads, causal, dtype, device="cpu"):
    x, ws, dy = _inputs(b, s, w)
    leaves = [torch.from_numpy(a).to(device=device, dtype=dtype).requires_grad_()
              for a in [x, *ws]]
    y = ba.block_attention(*leaves, heads=heads, causal=causal)
    y.backward(torch.from_numpy(dy).to(device=device, dtype=dtype))
    return [t.grad.float().cpu().numpy() for t in leaves]


def _assert_grads_close(got, want, rel, rtol):
    for name, g, r in zip(NAMES, got, want):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=rel * scale, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("b,s,w,heads,causal", [(4, 50, 256, 4, False), (3, 77, 512, 8, True)])
def test_function_grads_match_jax_f32(b, s, w, heads, causal):
    got = _port_grads(b, s, w, heads, causal, torch.float32)
    _assert_grads_close(got, _jax_grads(b, s, w, heads, causal, "float32"), 3e-4, 1e-3)


@pytest.mark.parametrize("b,s,w,heads,causal", [(4, 50, 256, 4, False), (3, 77, 512, 8, True)])
def test_function_grads_match_jax_bf16(b, s, w, heads, causal):
    got = _port_grads(b, s, w, heads, causal, torch.bfloat16)
    _assert_grads_close(got, _jax_grads(b, s, w, heads, causal, "bfloat16"), 2e-2, 0)


@pytest.mark.parametrize("b,s,w,heads,causal", [(1, 24, 640, 8, True), (1, 24, 1408, 16, False)])
def test_function_grads_match_jax_padded_head_dims_f32(b, s, w, heads, causal):
    """Head dims 80 and 88 (multiples of 8, not of 16): the plain backward, the yardstick of
    the kernels' zero-padded last k-step, against the JAX kernel's."""
    assert w // heads in (80, 88)
    got = _port_grads(b, s, w, heads, causal, torch.float32)
    _assert_grads_close(got, _jax_grads(b, s, w, heads, causal, "float32"), 3e-4, 1e-3)


@pytest.mark.parametrize("dtype,rel,rtol", [(torch.float32, 3e-4, 1e-3), (torch.bfloat16, 2e-2, 0)])
def test_function_grads_match_jax_ragged_rows(dtype, rel, rtol):
    """B*S = 150 token rows, no multiple of the GEMM's 128-row tile: the plain backward, the
    yardstick of the kernel's masked rows, against the JAX kernel's."""
    b, s, w, heads = 3, 50, 384, 6
    name = "float32" if dtype == torch.float32 else "bfloat16"
    got = _port_grads(b, s, w, heads, False, dtype)
    _assert_grads_close(got, _jax_grads(b, s, w, heads, False, name), rel, rtol)


def test_function_grads_match_jax_large_kernel(monkeypatch):
    """S=197: the JAX side runs its per-head streaming backward (_bwd_kernel_large)."""
    monkeypatch.setenv("MMTPU_BLOCK_ATTN_BWD_LARGE", "1")
    b, s, w, heads = 2, 197, 256, 4
    got = _port_grads(b, s, w, heads, False, torch.float32)
    _assert_grads_close(got, _jax_grads(b, s, w, heads, False, "float32"), 3e-4, 1e-3)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_gradcheck_f64(causal):
    """In float64 no rounding point rounds, so the plain backward is the exact derivative."""
    rng = np.random.default_rng(7)
    b, s, w, heads = 2, 6, 16, 2
    args = [torch.from_numpy(rng.standard_normal((b, s, w))).requires_grad_()]
    for _ in range(4):
        args.append(torch.from_numpy(rng.standard_normal((w, w)) * w ** -0.5).requires_grad_())
        args.append(torch.from_numpy(rng.standard_normal(w) * 0.1).requires_grad_())
    fn = lambda *a: ba.BlockAttention.apply(*a, heads, causal)  # noqa: E731
    assert torch.autograd.gradcheck(fn, args)


def test_output_carries_grad_fn_and_weights_get_grads(monkeypatch):
    """The fault this op once had: a result without grad_fn left every weight without a
    gradient. The residual form must reach the Function's own backward."""
    calls = []
    plain = ba.block_attention_bwd_reference

    def counting(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(ba, "block_attention_bwd_reference", counting)
    x, ws, _ = _inputs(2, 20, 128, seed=3)
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(a).requires_grad_() for a in ws]
    gamma = torch.ones(128, requires_grad=True)
    beta = torch.zeros(128, requires_grad=True)
    out = ba.block_attention(xt, *wt, heads=2, ln_scale=gamma, ln_bias=beta, residual=True)
    assert out.grad_fn is not None
    core = ba.block_attention(xt, *wt, heads=2)
    assert type(core.grad_fn).__name__ == "BlockAttentionBackward"
    out.sum().backward()
    assert calls == [1]
    for t in [xt, gamma, beta, *wt]:
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert wt[0].grad.abs().sum() > 0 and gamma.grad.abs().sum() > 0
    assert launches.launch_counts()["block_attention_bwd"] == 0  # a CPU tensor launches nothing


# ----------------------------------------------------------------------------- 3xTF32
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: to nearest on the 13 dropped mantissa bits, ties away (add
    half a TF32 ulp to the bits, clear the 13), as tf32_tiles.cuh rounds."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """A float32 operand as the tensor core reads it as TF32: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _gemm_nt_tf32(segments, weights, products: int) -> torch.Tensor:
    """sum_z A_z @ W_z^T (A_z [M, K], W_z [N, K]) as the NT GEMM forms it in float32: k-steps
    of 8 over the segments in order, each adding its split operands' products to one f32
    accumulator, small_a big_w and big_a small_w before big_a big_w (products=3), or the one
    product of the TF32-rounded operands (products=1)."""
    acc = torch.zeros(segments[0].shape[0], weights[0].shape[0])
    for a, w in zip(segments, weights):
        a_big, w_big = _tf32(a), _tf32(w)
        a_small, w_small = _tf32_read(a - a_big), _tf32_read(w - w_big)
        for k0 in range(0, a.shape[1], 8):
            ks = slice(k0, k0 + 8)
            if products == 3:
                acc = acc + a_small[:, ks] @ w_big[:, ks].T
                acc = acc + a_big[:, ks] @ w_small[:, ks].T
            acc = acc + a_big[:, ks] @ w_big[:, ks].T
    return acc


def _case_operands(case: str, rng):
    """(segments, weights, float64 product) of one emulated GEMM, each as the NT form's
    sum_z A_z @ W_z^T that the k-step emulation takes:
    ``nt-k2304`` / ``nt-k768``: ViT-B/32 vision widths, the block backward's dx product over K =
    3W = 2304 ([dq | dk | dv] @ [Wq; Wk; Wv]^T) and its do product (dy @ Wo^T), 150 token rows;
    ``nn-ln-k768``: the block forward's q projection with the LN load transform, LN(x) @ Wq at
    W = K = 768 (the NN form's B read as its transpose: the same k-steps and splits);
    ``tn-lnb-t3000``: the MLP backward's dW1 = ln_b^T @ dh in the TN form over a ragged T =
    3000 token rows in three splits of 1024 (the last 952 rows, padded to 960 with zeros),
    W = 768, H = 256: each split's f32 partial, then their sum in order;
    ``nn-g-k3072`` / ``nn-g-k4096``: the MLP forward's c_proj, g @ W2 in the NN form, g = act(h)
    as c_fc's store writes it from a pre-activation h (150 token rows), over K = H = 3072 at
    ViT-B/16 (W = 768, quick_gelu) and K = 4096 at ViT-L/14 (W = 1024, tanh-gelu), the longest
    float32 sums of the MLP forward."""
    n = lambda *shape: rng.standard_normal(shape, dtype=np.float32)  # noqa: E731
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    w = 768
    if case.startswith("nn-g"):
        hid, w, act = (3072, 768, "quick_gelu") if case == "nn-g-k3072" else (4096, 1024, "gelu")
        g = bm.act_fwd(t(n(150, hid)), act)  # c_fc's g, in float32
        w2 = t(n(hid, w) * hid ** -0.5)
        return [[g]], [[w2.T.contiguous()]], g.double() @ w2.double()
    if case.startswith("nt"):
        nseg = 3 if case == "nt-k2304" else 1
        segments = [t(n(150, w) * scale) for scale in (0.3, 1.0, 3.0)[:nseg]]
        weights = [t(n(w, w) * w ** -0.5) for _ in range(nseg)]
        want = sum(a.double() @ m.double().T for a, m in zip(segments, weights))
        return [segments], [weights], want
    x, gamma, beta = t(n(150 if case == "nn-ln-k768" else 3000, w)), t(1 + 0.1 * n(w)), t(0.1 * n(w))
    if case == "nn-ln-k768":
        a = ba.ln_rows(x, gamma, beta, ba.LN_EPS)  # the forward's LN transform, in float32
        wq = t(n(w, w) * w ** -0.5)
        return [[a]], [[wq.T.contiguous()]], a.double() @ wq.double()
    mean, inv = ba._ln_stats(x, ba.LN_EPS)
    ln_b = (x - mean) * inv * gamma + beta  # LN-b in float32: every rounding is the identity
    dh = t(n(3000, 256))
    splits = [slice(0, 1024), slice(1024, 2048), slice(2048, 3000)]
    return ([[ln_b[k].T.contiguous()] for k in splits], [[dh[k].T.contiguous()] for k in splits],
            ln_b.double().T @ dh.double())


@pytest.mark.parametrize("case", [pytest.param("nt-k2304", id="3"), pytest.param("nt-k768", id="1"),
                                  "nn-ln-k768", "tn-lnb-t3000", "nn-g-k3072", "nn-g-k4096"])
def test_3xtf32_gemm_holds_the_float32_limit_and_one_tf32_product_does_not(case):
    """The projection GEMM's float32 arithmetic, k-step by k-step, in its three forms (see
    ``_case_operands``): three TF32 products a product stay within the card's float32 limit,
    1e-4 x max|float64|; one does not. The TN form's splits each sum in their own f32
    accumulator, summed after in order."""
    rng = np.random.default_rng(12)
    runs, weights, want = _case_operands(case, rng)
    rel = lambda got: ((got.double() - want).abs().max() / want.abs().max()).item()  # noqa: E731

    def emulate(products):
        parts = [_gemm_nt_tf32(segs, ws, products) for segs, ws in zip(runs, weights)]
        return functools.reduce(torch.add, parts)

    three, one = rel(emulate(3)), rel(emulate(1))
    print(f"{case}: err / max|float64|: 3xTF32 {three:.3e}, 1xTF32 {one:.3e}")
    assert three <= 1e-4, three
    assert one > 1e-4, one
    assert one > 20 * three


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,w,heads,causal", [(3, 50, 768, 12, False), (2, 77, 512, 8, True),
                                                (2, 77, 768, 12, True),
                                                (2, 197, 768, 12, False), (1, 257, 1024, 16, False),
                                                (1, 320, 256, 2, True), (2, 40, 384, 8, False),
                                                (2, 257, 1280, 16, True),
                                                (2, 257, 1408, 16, False),
                                                (3, 129, 768, 12, True),
                                                (3, 191, 768, 12, False)])
def test_cuda_bwd_kernel_matches_plain(cuda_device, b, s, w, heads, causal, dtype, tol):
    x, ws, dy = _inputs(b, s, w, seed=5)
    conv = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    args = [conv(x), conv(dy)] + [conv(a) for a in ws]
    launches.reset_launch_counts()
    got = ba.block_attention_bwd(*args, heads=heads, causal=causal)
    torch.cuda.synchronize()
    assert launches.launch_counts()["block_attention_bwd"] == 1
    want = ba.block_attention_bwd_reference(*args, heads=heads, causal=causal)
    for name, g, r in zip(["dx", "dq", "dk", "dv", "attnpre"], got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_backward_runs_the_kernel(cuda_device):
    """loss.backward() on the card gives every weight a gradient through the kernel, and
    agrees with the same Function on the CPU."""
    x, ws, dy = _inputs(2, 50, 256, seed=8)
    grads = {}
    for dev in ("cpu", cuda_device):
        leaves = [torch.from_numpy(a).to(dev).requires_grad_() for a in [x, *ws]]
        launches.reset_launch_counts()
        ba.block_attention(*leaves, heads=4, causal=True).backward(torch.from_numpy(dy).to(dev))
        counts = launches.launch_counts()
        grads[str(dev)] = [t.grad.cpu() for t in leaves]
    assert counts["block_attention_fwd"] == 1 and counts["block_attention_bwd"] == 1
    for name, g, r in zip(NAMES, grads[str(cuda_device)], grads["cpu"]):
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(g, r, atol=3e-4 * scale, rtol=1e-3, msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,w,heads,causal", [(3, 50, 512, 8, False), (3, 50, 640, 10, True),
                                                (1, 77, 1280, 16, False),
                                                (1, 61, 1408, 16, True)])
def test_cuda_gemm_widths_and_ragged_rows_match_plain(cuda_device, b, s, w, heads, causal, dtype,
                                                      tol):
    """The tensor-core GEMM at the widths 512, 640, 1280 and 1408 (N = W, K = W and 3W) with
    B*S (150, 77, 61) no multiple of its 128-row tile: every output of the backward."""
    x, ws, dy = _inputs(b, s, w, seed=6)
    conv = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    args = [conv(x), conv(dy)] + [conv(a) for a in ws]
    got = ba.block_attention_bwd(*args, heads=heads, causal=causal)
    want = ba.block_attention_bwd_reference(*args, heads=heads, causal=causal)
    for name, g, r in zip(["dx", "dq", "dk", "dv", "attnpre"], got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.abs().max().item(), (name, err)


def _ln_args(b, s, w, dtype, device, seed):
    x, ws, dy = _inputs(b, s, w, seed=seed)
    rng = np.random.default_rng(seed + 1)
    gamma = 1 + 0.1 * rng.standard_normal(w, dtype=np.float32)
    beta = 0.1 * rng.standard_normal(w, dtype=np.float32)
    return [torch.from_numpy(a).to(device, dtype) for a in [x, dy, gamma, beta, *ws]]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_cuda_ln_form_float32_g_matches_plain(cuda_device, dtype, tol):
    """The LN form keeps g = [dq | dk | dv] @ [Wq; Wk; Wv]^T unrounded (the GEMM's float32
    output) for the LN vjp: dx, ln_out and the dgamma / dbeta sums at 3 x 197 token rows."""
    args = _ln_args(3, 197, 768, dtype, cuda_device, seed=9)
    kw = dict(heads=12, causal=False, residual=True)
    got = ba.block_attention_ln_bwd(*args, **kw)
    want = ba.block_attention_ln_bwd_reference(*args, **kw)
    names = ["dx", "dq", "dk", "dv", "attnpre", "ln_out", "dgamma", "dbeta"]
    for name, g, r in zip(names, got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("ln", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_bwd_repeats_bit_for_bit(cuda_device, ln, dtype):
    """Every sum has one owner and a fixed order: a second launch gives the same bits, every
    output of both forms."""
    if ln:
        args = _ln_args(4, 197, 768, dtype, cuda_device, seed=10)
        run = lambda: ba.block_attention_ln_bwd(*args, heads=12, residual=True)  # noqa: E731
    else:
        x, ws, dy = _inputs(4, 50, 768, seed=10)
        args = [torch.from_numpy(a).to(cuda_device, dtype) for a in [x, dy, *ws]]
        run = lambda: ba.block_attention_bwd(*args, heads=12)  # noqa: E731
    for a, b in zip(run(), run()):
        assert torch.equal(a, b)
