"""Fused whole-sequence attention in the PyTorch port: ``fused_attention`` (forward and
gradients; the plain versions on a CPU tensor) against the JAX package's
``fused_attention`` and ``attention(impl="fused")`` (its Pallas kernels in interpret mode
on the CPU), the ``impl`` dispatch of ``ops.attention.attention``, and the hand-written
CUDA kernels against the plain versions on the card.

Tolerances. float32: forward atol = rtol = 3e-5, gradients atol = rtol = 1e-4, the JAX
package's own test (tests/test_fused_attention.py); the two sides differ only in summation
order. bfloat16: atol = 2e-2 x max(1, max|value|), one bf16 rounding of probs and outputs.
On the card, kernel against plain: within 1e-4 x max|plain| in float32 and 2e-2 x max|plain|
in bfloat16.

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_fused_attention.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import fused_attention as fa
from multimodal_tpu_torch.ops.attention import attention

torch.set_num_threads(1)

# the shapes of the JAX package's own test: (seq, heads, head_dim, causal)
SHAPES = [(77, 8, 64, True), (50, 12, 64, False), (197, 12, 64, False), (33, 4, 128, True),
          (16, 2, 32, False)]
B = 2


def _qkv(s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, s, h * d), dtype=np.float32) for _ in range(4)]  # + do


@functools.lru_cache(maxsize=None)
def _jax_run(s, h, d, causal, dtype_name, through_attention=False):
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.ops.attention import attention as jax_attention
    from multimodal_tpu.ops.fused_attention import fused_attention

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    q, k, v, do = (jnp.asarray(a, dt) for a in _qkv(s, h, d))

    def fn(q, k, v):
        if through_attention:
            to4 = lambda t: t.reshape(B, s, h, d)  # noqa: E731
            return jax_attention(to4(q), to4(k), to4(v), causal=causal,
                                 impl="fused").reshape(B, s, h * d)
        return fused_attention(q, k, v, heads=h, causal=causal)

    out, vjp = jax.vjp(fn, q, k, v)
    f32 = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    return f32(out), [f32(g) for g in vjp(do)]


def _port_run(s, h, d, causal, dtype, device="cpu", through_attention=False):
    q, k, v, do = (torch.from_numpy(a).to(device=device, dtype=dtype) for a in _qkv(s, h, d))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    if through_attention:
        out = attention(*(t.view(B, s, h, d) for t in leaves), causal=causal,
                        impl="fused").reshape(B, s, h * d)
    else:
        out = fa.fused_attention(*leaves, heads=h, causal=causal)
    out.backward(do)
    return out.detach().float().cpu().numpy(), [t.grad.float().cpu().numpy() for t in leaves]


@pytest.mark.parametrize("s,h,d,causal", SHAPES)
def test_forward_matches_jax_f32(s, h, d, causal):
    want, _ = _jax_run(s, h, d, causal, "float32")
    got, _ = _port_run(s, h, d, causal, torch.float32)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("s,h,d,causal", SHAPES)
def test_grads_match_jax_f32(s, h, d, causal):
    _, want = _jax_run(s, h, d, causal, "float32")
    _, got = _port_run(s, h, d, causal, torch.float32)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("s,h,d,causal", [(197, 12, 64, False), (77, 8, 64, True)])
def test_forward_and_grads_match_jax_bf16(s, h, d, causal):
    want_out, want = _jax_run(s, h, d, causal, "bfloat16")
    got_out, got = _port_run(s, h, d, causal, torch.bfloat16)
    np.testing.assert_allclose(got_out, want_out, atol=2e-2 * max(1.0, np.abs(want_out).max()),
                               rtol=0)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, atol=2e-2 * max(1.0, np.abs(r).max()), rtol=0,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_attention_impl_fused_matches_jax_and_plain(causal):
    s, h, d = 77, 8, 64
    want_out, want = _jax_run(s, h, d, causal, "float32", through_attention=True)
    got_out, got = _port_run(s, h, d, causal, torch.float32, through_attention=True)
    np.testing.assert_allclose(got_out, want_out, atol=3e-5, rtol=3e-5)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4)
    q, k, v, _ = (torch.from_numpy(a).view(B, s, h, d) for a in _qkv(s, h, d))
    plain = attention(q, k, v, causal=causal, impl="xla").reshape(B, s, h * d)
    np.testing.assert_allclose(got_out, plain.numpy(), atol=3e-5, rtol=3e-5)


def test_bf16_delta_and_ds_use_the_exact_probs():
    """The fused backward forms rowsum(dp p) and ds from the exact f32 probabilities and
    only dv from the rounded ones; the block-attention backward uses the rounded ones
    throughout. In float32 the two agree, in bfloat16 they do not, and the port's plain
    version must follow the fused kernel."""
    s, h, d = 64, 2, 32
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(s, h, d, seed=3))

    def rounded_probs_backward(q, k, v, do):
        """The same backward with ds and delta from the rounded probabilities."""
        f32, dt, scale = torch.float32, q.dtype, d ** -0.5
        qh, kh, vh, doh = (fa._heads(t, h).to(f32) for t in (q, k, v, do))
        p = fa._exact_probs(qh, kh, False, scale).to(dt).to(f32)
        dp = doh @ vh.transpose(-1, -2)
        ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).to(dt).to(f32)
        return fa._pack(((ds @ kh) * scale).to(dt)), fa._pack((p.transpose(-1, -2) @ doh).to(dt))

    dq32, _, dv32 = fa.fused_attention_bwd_reference(q, k, v, do, heads=h)
    alt_dq32, alt_dv32 = rounded_probs_backward(q, k, v, do)
    torch.testing.assert_close(dq32, alt_dq32, atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(dv32, alt_dv32, atol=0, rtol=0)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    dq16, _, dv16 = fa.fused_attention_bwd_reference(qb, kb, vb, dob, heads=h)
    alt_dq16, alt_dv16 = rounded_probs_backward(qb, kb, vb, dob)
    assert torch.equal(dv16, alt_dv16)  # dv uses the rounded probs on both
    assert not torch.equal(dq16, alt_dq16)  # ds does not
    import jax.numpy as jnp

    from multimodal_tpu.ops.fused_attention import _call, _bwd_kernel

    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (qb, kb, vb, dob))
    want_dq = _call(_bwd_kernel, 3, jq, jk, jv, jdo, heads=h, head_dim=d, true_s=s,
                    causal=False, sm_scale=d ** -0.5)[0]
    want_dq = np.asarray(want_dq.astype(jnp.float32))
    err_port = np.abs(dq16.float().numpy() - want_dq).mean()
    err_alt = np.abs(alt_dq16.float().numpy() - want_dq).mean()
    assert err_port < 0.5 * err_alt, (err_port, err_alt)


def test_fused_supported_gate():
    assert not fa.fused_supported(77, 64)
    assert fa.fused_supported(128, 32)
    assert fa.fused_supported(197, 64)
    assert fa.fused_supported(512, 128)
    assert not fa.fused_supported(513, 64)
    assert not fa.fused_supported(197, 96)


def test_impl_errors_and_auto_on_cpu():
    q = torch.randn(1, 130, 2, 32, generator=torch.Generator().manual_seed(0))
    mask = torch.zeros(1, 1, 130, 130)
    with pytest.raises(ValueError, match="additive mask"):
        attention(q, q, q, mask=mask, impl="fused")
    with pytest.raises(ValueError, match="sq == sk"):
        attention(q[:, :5], q, q, impl="fused")
    with pytest.raises(NotImplementedError, match="Queue 2 #6-8"):
        attention(q, q, q, impl="flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, q, q, impl="pallas")
    # on a CPU tensor auto is the plain path (its autograd, no FusedAttention node), also at a
    # shape the fused kernels support; a mask goes to the plain path too
    assert fa.fused_supported(130, 32)
    out = attention(q.requires_grad_(), q, q)
    assert "FusedAttention" not in type(out.grad_fn).__name__
    torch.testing.assert_close(out, attention(q, q, q, impl="xla"))
    torch.testing.assert_close(attention(q, q, q, mask=mask), out)
    fused = attention(q, q, q, impl="fused")
    assert type(fused.grad_fn).__name__ == "ViewBackward0"
    assert type(fused.grad_fn.next_functions[0][0]).__name__ == "FusedAttentionBackward"
    assert fa.launches.launch_counts()["fused_attention_fwd"] == 0  # nothing launched on a CPU


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_gradcheck_f64(causal):
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 7, 16))).requires_grad_()
               for _ in range(3))
    fn = lambda *a: fa.FusedAttention.apply(*a, 2, causal, 0.3)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (q, k, v))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


CUDA_SHAPES = [(128, 4, 32, False), (197, 12, 64, False), (197, 12, 64, True),
               (257, 16, 64, False), (512, 2, 128, True), (512, 2, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,h,d,causal", CUDA_SHAPES)
def test_cuda_kernels_match_plain(cuda_device, s, h, d, causal, dtype, tol):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(s, h, d, seed=5))
    kw = dict(heads=h, causal=causal)
    fa.launches.reset_launch_counts()
    got = (fa.fused_attention(q, k, v, **kw), *fa.fused_attention_bwd(q, k, v, do, **kw))
    torch.cuda.synchronize()
    counts = fa.launches.launch_counts()
    assert counts["fused_attention_fwd"] == 1 and counts["fused_attention_bwd"] == 1
    want = (fa.fused_attention_reference(q, k, v, **kw),
            *fa.fused_attention_bwd_reference(q, k, v, do, **kw))
    for name, g, r in zip(["out", "dq", "dk", "dv"], got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_auto_takes_the_fused_kernels(cuda_device):
    """attention(impl="auto") on a CUDA tensor at a supported shape launches the kernels,
    forward and backward, and never the einsum; below the window it is the plain path."""
    s, h, d = 197, 4, 64
    q, k, v, do = (torch.from_numpy(a).to(cuda_device).view(B, s, h, d)
                   for a in _qkv(s, h, d, seed=6))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fa.launches.reset_launch_counts()
    out = attention(*leaves, causal=True)
    out.backward(do)
    counts = fa.launches.launch_counts()
    assert counts["fused_attention_fwd"] == 1 and counts["fused_attention_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention(*plain, causal=True, impl="xla")
    want.backward(do)
    torch.testing.assert_close(out, want, atol=3e-5, rtol=3e-5)
    for g, r in zip(leaves, plain):
        torch.testing.assert_close(g.grad, r.grad, atol=1e-4, rtol=1e-4)
    fa.launches.reset_launch_counts()
    attention(q[:, :77], k[:, :77], v[:, :77])
    assert fa.launches.launch_counts()["fused_attention_fwd"] == 0
