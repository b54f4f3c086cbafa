"""Block attention in the PyTorch port: the plain PyTorch version against the JAX Pallas
kernel (interpret mode on CPU), and the hand-written CUDA kernel against the plain
version on the card.

JAX is imported inside the helpers, so the CUDA case also runs where JAX is absent:
    python -m pytest tests/test_torch_block_attention.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import block_attention as ba
from multimodal_tpu_torch.ops import launches

torch.set_num_threads(1)

SHAPES = [(4, 50, 256, 4), (3, 77, 512, 8)]


def _inputs(b, s, w, seed=0):
    """x and (wq, bq, wk, bk, wv, bv, wo, bo) as float32 numpy, from a seeded generator."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    ws = []
    for _ in range(4):
        ws.append((rng.standard_normal((w, w), dtype=np.float32) * w ** -0.5))
        ws.append((rng.standard_normal((w,), dtype=np.float32) * 0.02))
    return x, ws


@functools.lru_cache(maxsize=None)
def _jax_out(b, s, w, heads, causal, dtype_name):
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_attention import block_attention

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    x, ws = _inputs(b, s, w)
    out = block_attention(jnp.asarray(x, dt), *(jnp.asarray(a, dt) for a in ws),
                          heads=heads, causal=causal)
    return np.asarray(out.astype(jnp.float32))


def _port_out(b, s, w, heads, causal, dtype, device="cpu"):
    x, ws = _inputs(b, s, w)
    conv = lambda a: torch.from_numpy(a).to(device=device, dtype=dtype)  # noqa: E731
    out = ba.block_attention(conv(x), *(conv(a) for a in ws), heads=heads, causal=causal)
    return out.float().cpu().numpy()


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,w,heads", SHAPES)
def test_plain_matches_jax_kernel_f32(b, s, w, heads, causal):
    assert ba.block_attn_supported(b, s, w, heads)
    got = _port_out(b, s, w, heads, causal, torch.float32)
    want = _jax_out(b, s, w, heads, causal, "float32")
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,s,w,heads", SHAPES)
def test_plain_matches_jax_kernel_bf16(b, s, w, heads, causal):
    got = _port_out(b, s, w, heads, causal, torch.bfloat16)
    want = _jax_out(b, s, w, heads, causal, "bfloat16")
    np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(), rtol=0)


def test_ln_and_residual_forms():
    """ln_scale runs the ln_rows pre-pass, residual adds the raw stream back."""
    b, s, w, heads = 2, 20, 128, 2
    x, ws = _inputs(b, s, w, seed=3)
    rng = np.random.default_rng(4)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(w, dtype=np.float32))
    beta = torch.from_numpy(0.1 * rng.standard_normal(w, dtype=np.float32))
    xt, wt = torch.from_numpy(x), [torch.from_numpy(a) for a in ws]
    got = ba.block_attention(xt, *wt, heads=heads, ln_scale=g, ln_bias=beta, residual=True)
    want = xt + ba.block_attention_reference(ba.ln_rows(xt, g, beta, 1e-5), *wt, heads=heads)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    with pytest.raises(ValueError, match="residual"):
        ba.block_attention(xt, *wt, heads=heads, residual=True)


def test_supported_predicate_matches_reference():
    from multimodal_tpu.ops.block_attention import block_attn_supported as jax_rule

    cases = [(256, 50, 768, 12), (256, 77, 512, 8), (4, 197, 768, 12), (2, 320, 1280, 16),
             (2, 321, 768, 12), (2, 50, 64, 2), (2, 50, 768, 16), (2, 50, 384, 5),
             (2, 50, 1536, 12), (2, 257, 1408, 16)]
    for c in cases:
        assert ba.block_attn_supported(*c) == jax_rule(*c), c


def test_cpu_tensor_never_counts_a_launch():
    launches.reset_launch_counts()
    _port_out(1, 8, 128, 2, True, torch.float32)
    counts = launches.launch_counts()
    assert {"block_attention_fwd", "block_attention_bwd"} <= set(counts)
    assert not any(counts.values())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,w,heads,causal", [(3, 50, 768, 12, False), (2, 77, 512, 8, True),
                                                (2, 77, 768, 12, True),
                                                (2, 197, 768, 12, False), (1, 320, 256, 2, True),
                                                (2, 40, 384, 8, False)])
def test_cuda_kernel_matches_plain(cuda_device, b, s, w, heads, causal, dtype, tol):
    x, ws = _inputs(b, s, w, seed=5)
    conv = lambda a: torch.from_numpy(a).to(cuda_device, dtype)  # noqa: E731
    xt, wt = conv(x), [conv(a) for a in ws]
    launches.reset_launch_counts()
    got = ba.block_attention(xt, *wt, heads=heads, causal=causal).float()
    torch.cuda.synchronize()
    assert launches.launch_counts()["block_attention_fwd"] == 1
    want = ba.block_attention_reference(xt, *wt, heads=heads, causal=causal).float()
    err = (got - want).abs().max().item()
    assert err <= tol * want.abs().max().item(), err


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    x, ws = _inputs(2, 50, 256, seed=6)
    conv = lambda a, dt=torch.float32: torch.from_numpy(a).to(cuda_device, dt)  # noqa: E731
    wt = [conv(a) for a in ws]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ba.block_attention(conv(x, torch.float16), *(conv(a, torch.float16) for a in ws),
                           heads=4)
    with pytest.raises(ValueError, match="does not take"):
        ba.block_attention(conv(np.zeros((1, 321, 256), np.float32)), *wt, heads=4)
    with pytest.raises(ValueError, match="contiguous"):
        ba.block_attention(conv(x).transpose(0, 1).contiguous().transpose(0, 1), *wt, heads=4)
    with pytest.raises(ValueError, match="expected"):
        ba.block_attention(conv(x), *wt[:7], wt[7].to(torch.bfloat16), heads=4)
