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

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_block_attention_bwd.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import block_attention as ba
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
                                                (1, 320, 256, 2, True), (2, 40, 384, 8, False)])
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
