"""The LN-fold form of block attention in the PyTorch port: ``BlockAttentionLN`` (forward and
full VJP: dx, dgamma, dbeta and the eight weight and bias gradients; the plain versions on a
CPU tensor) against the JAX package's ``block_attention(..., ln_scale, ln_bias, residual)``
(its Pallas LN-fold kernels in interpret mode on the CPU), and the hand-written CUDA kernels
against the plain versions on the card.

The JAX side folds the LayerNorm at S > 128 by itself; at S = 50 the test forces its fold
with ``MMTPU_BLOCK_ATTN_LN=1``, as the JAX package's own tests do, and the port calls
``block_attention_ln`` directly.

Tolerances. float32: the forward atol = rtol = 5e-5 and the gradients atol = 5e-4 x
max(1, max|g|), rtol = 2e-3, the JAX package's own LN-fold tests
(tests/test_block_attention.py); the two sides differ only in summation order. bfloat16:
atol = 2e-2 x max(1, max|value|): both round at the same points, and a sum taken in another
order can flip a bf16 rounding. The floor of 1 covers the key-bias gradient, which is zero in
exact arithmetic. On the card, kernel against plain: every output within 1e-4 x max|plain|
in float32 and 2e-2 x max|plain| in bfloat16.

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_block_attention_ln.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import block_attention as ba
from multimodal_tpu_torch.ops import launches

torch.set_num_threads(1)

NAMES = ["dx", "dgamma", "dbeta", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo"]
# (batch, seq, width, heads, causal, residual)
SHAPES = [(2, 145, 128, 2, False, True), (2, 145, 128, 2, True, True),
          (2, 145, 128, 2, False, False), (3, 50, 256, 4, False, True)]


def _inputs(b, s, w, seed=0):
    """x, gamma, beta, the eight weights and biases, and a cotangent dy, float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    gamma = 1 + 0.1 * rng.standard_normal((w,), dtype=np.float32)
    beta = 0.1 * rng.standard_normal((w,), dtype=np.float32)
    ws = []
    for _ in range(4):
        ws.append(rng.standard_normal((w, w), dtype=np.float32) * w ** -0.5)
        ws.append(rng.standard_normal((w,), dtype=np.float32) * 0.02)
    dy = rng.standard_normal((b, s, w), dtype=np.float32)
    return x, gamma, beta, ws, dy


@functools.lru_cache(maxsize=None)
def _jax_run(b, s, w, heads, causal, residual, dtype_name):
    """(y, grads) of the JAX operator with its LN fold on; run under MMTPU_BLOCK_ATTN_LN=1
    by the caller when S <= 128."""
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_attention import block_attention

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    x, gamma, beta, ws, dy = _inputs(b, s, w)
    args = [jnp.asarray(x, dt), jnp.asarray(gamma), jnp.asarray(beta)]
    args += [jnp.asarray(a, dt) for a in ws]

    def fn(x, gamma, beta, *ws):
        return block_attention(x, *ws, heads=heads, causal=causal, ln_scale=gamma,
                               ln_bias=beta, residual=residual)

    y, vjp = jax.vjp(fn, *args)
    grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, dt))]
    return np.asarray(y.astype(jnp.float32)), grads


def _port_run(b, s, w, heads, causal, residual, dtype, device="cpu"):
    x, gamma, beta, ws, dy = _inputs(b, s, w)

    def conv(a, dt):
        return torch.from_numpy(a).to(device=device, dtype=dt).requires_grad_()

    leaves = [conv(x, dtype), conv(gamma, torch.float32), conv(beta, torch.float32)]
    leaves += [conv(a, dtype) for a in ws]
    y = ba.block_attention_ln(*leaves, heads=heads, causal=causal, residual=residual)
    y.backward(torch.from_numpy(dy).to(device=device, dtype=dtype))
    return y.detach().float().cpu().numpy(), [t.grad.float().cpu().numpy() for t in leaves]


def _force_jax_fold(monkeypatch, s):
    if s <= 128:
        monkeypatch.setenv("MMTPU_BLOCK_ATTN_LN", "1")


@pytest.mark.parametrize("b,s,w,heads,causal,residual", SHAPES)
def test_ln_forward_matches_jax_f32(b, s, w, heads, causal, residual, monkeypatch):
    _force_jax_fold(monkeypatch, s)
    want, _ = _jax_run(b, s, w, heads, causal, residual, "float32")
    got, _ = _port_run(b, s, w, heads, causal, residual, torch.float32)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("b,s,w,heads,causal,residual", SHAPES)
def test_ln_full_vjp_matches_jax_f32(b, s, w, heads, causal, residual, monkeypatch):
    _force_jax_fold(monkeypatch, s)
    _, want = _jax_run(b, s, w, heads, causal, residual, "float32")
    _, got = _port_run(b, s, w, heads, causal, residual, torch.float32)
    assert len(got) == len(want) == len(NAMES)
    for name, g, r in zip(NAMES, got, want):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=5e-4 * scale, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("b,s,w,heads,causal,residual", [SHAPES[0], SHAPES[1], SHAPES[3]])
def test_ln_forward_and_vjp_match_jax_bf16(b, s, w, heads, causal, residual, monkeypatch):
    _force_jax_fold(monkeypatch, s)
    want_y, want = _jax_run(b, s, w, heads, causal, residual, "bfloat16")
    got_y, got = _port_run(b, s, w, heads, causal, residual, torch.bfloat16)
    np.testing.assert_allclose(got_y, want_y, atol=2e-2 * max(1.0, np.abs(want_y).max()), rtol=0)
    for name, g, r in zip(NAMES, got, want):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-2 * scale, rtol=0, err_msg=name)


def test_ln_grads_keep_parameter_dtypes():
    """bfloat16 compute with float32 LayerNorm parameters: dgamma and dbeta come back in
    float32, the weight gradients in the compute dtype."""
    x, gamma, beta, ws, dy = _inputs(2, 20, 128, seed=2)
    leaves = [torch.from_numpy(x).bfloat16().requires_grad_(),
              torch.from_numpy(gamma).requires_grad_(), torch.from_numpy(beta).requires_grad_()]
    leaves += [torch.from_numpy(a).bfloat16().requires_grad_() for a in ws]
    ba.block_attention_ln(*leaves, heads=2).backward(torch.from_numpy(dy).bfloat16())
    assert leaves[1].grad.dtype == leaves[2].grad.dtype == torch.float32
    assert all(t.grad.dtype == torch.bfloat16 for t in leaves[3:])


@pytest.mark.parametrize("s,folded", [(128, False), (129, True), (197, True), (50, False)])
def test_dispatch_folds_only_above_128(s, folded):
    """block_attention() folds the LayerNorm iff ln_scale is given and S > 128; the residual
    rides the kernel iff folded; without ln_scale the non-LN operator runs at every S."""
    x, gamma, beta, ws, _ = _inputs(1, s, 128, seed=1)
    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(a) for a in ws]
    ln = dict(ln_scale=torch.from_numpy(gamma), ln_bias=torch.from_numpy(beta))
    out = ba.block_attention(xt, *wt, heads=2, residual=True, **ln)
    name = type(out.grad_fn).__name__
    assert name == ("BlockAttentionLNBackward" if folded else "AddBackward0")
    want = ba.block_attention_ln_reference(xt, ln["ln_scale"], ln["ln_bias"], *wt, heads=2,
                                           residual=True)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    core = ba.block_attention(xt, *wt, heads=2)
    assert type(core.grad_fn).__name__ == "BlockAttentionBackward"


def test_residual_without_ln_raises():
    x, _, _, ws, _ = _inputs(1, 20, 128)
    with pytest.raises(ValueError, match="residual=True requires"):
        ba.block_attention(torch.from_numpy(x), *(torch.from_numpy(a) for a in ws), heads=2,
                           residual=True)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("residual", [False, True])
def test_plain_ln_backward_gradcheck_f64(causal, residual):
    """In float64 no rounding point rounds, so the plain LN backward is the exact
    derivative of the plain LN forward."""
    rng = np.random.default_rng(7)
    b, s, w, heads = 2, 6, 16, 2
    args = [torch.from_numpy(rng.standard_normal((b, s, w))).requires_grad_(),
            torch.from_numpy(1 + 0.1 * rng.standard_normal(w)).requires_grad_(),
            torch.from_numpy(0.1 * rng.standard_normal(w)).requires_grad_()]
    for _ in range(4):
        args.append(torch.from_numpy(rng.standard_normal((w, w)) * w ** -0.5).requires_grad_())
        args.append(torch.from_numpy(rng.standard_normal(w) * 0.1).requires_grad_())
    fn = lambda *a: ba.BlockAttentionLN.apply(*a, heads, causal, residual)  # noqa: E731
    assert torch.autograd.gradcheck(fn, args)


def test_weight_grads_come_from_ln_out_not_x(monkeypatch):
    """The LN form's weight gradients are products with ln_out: a backward that used the
    raw x would change when x is shifted by a per-row constant that LN removes."""
    x, gamma, beta, ws, dy = _inputs(2, 20, 128, seed=4)

    def wgrad(x_np):
        leaves = [torch.from_numpy(a).requires_grad_() for a in [x_np, gamma, beta, *ws]]
        ba.block_attention_ln(*leaves, heads=2).backward(torch.from_numpy(dy))
        return leaves[3].grad

    torch.testing.assert_close(wgrad(x), wgrad(x + 3.0), atol=2e-4, rtol=1e-3)
    assert launches.launch_counts()["block_attention_ln_bwd"] == 0  # a CPU tensor launches nothing


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


CUDA_SHAPES = [(2, 197, 768, 12, False), (1, 257, 1024, 16, False), (1, 320, 256, 2, True),
               (3, 50, 768, 12, False), (2, 77, 512, 8, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,w,heads,causal", CUDA_SHAPES)
def test_cuda_ln_fwd_kernel_matches_plain(cuda_device, b, s, w, heads, causal, dtype, tol,
                                          residual):
    x, gamma, beta, ws, _ = _inputs(b, s, w, seed=5)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in [x, gamma, beta, *ws]]
    launches.reset_launch_counts()
    got = ba.block_attention_ln(*args, heads=heads, causal=causal, residual=residual)
    torch.cuda.synchronize()
    assert launches.launch_counts()["block_attention_ln_fwd"] == 1
    want = ba.block_attention_ln_reference(*args, heads=heads, causal=causal, residual=residual)
    err = (got.float() - want.float()).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,w,heads,causal", CUDA_SHAPES)
def test_cuda_ln_bwd_kernel_matches_plain(cuda_device, b, s, w, heads, causal, dtype, tol,
                                          residual):
    x, gamma, beta, ws, dy = _inputs(b, s, w, seed=5)
    args = [torch.from_numpy(a).to(cuda_device, dtype) for a in [x, dy, gamma, beta, *ws]]
    kw = dict(heads=heads, causal=causal, residual=residual)
    launches.reset_launch_counts()
    got = ba.block_attention_ln_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert launches.launch_counts()["block_attention_ln_bwd"] == 1
    want = ba.block_attention_ln_bwd_reference(*args, **kw)
    names = ["dx", "dq", "dk", "dv", "attnpre", "ln_out", "dgamma", "dbeta"]
    for name, g, r in zip(names, got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_ln_backward_runs_the_kernels(cuda_device):
    """loss.backward() on the card goes through both LN-form kernels and agrees with the
    same Function on the CPU."""
    grads = {}
    for dev in ("cpu", cuda_device):
        launches.reset_launch_counts()
        _, grads[str(dev)] = _port_run(2, 145, 256, 4, True, True, torch.float32, device=dev)
        counts = launches.launch_counts()
    assert counts["block_attention_ln_fwd"] == 1 and counts["block_attention_ln_bwd"] == 1
    assert counts["block_attention_fwd"] == 0 and counts["block_attention_bwd"] == 0
    for name, g, r in zip(NAMES, grads[str(cuda_device)], grads["cpu"]):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=5e-4 * scale, rtol=2e-3, err_msg=name)
