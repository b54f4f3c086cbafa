"""Flash attention in the PyTorch port: ``flash_attention`` (forward and gradients; the plain
versions on a CPU tensor) against the JAX package's ``flash_attention`` (its Pallas kernels in
interpret mode on the CPU), the ``impl`` dispatch of ``ops.attention.attention``, and the
hand-written CUDA kernels against the plain versions on the card.

Tolerances. float32 against the JAX kernel: values atol = rtol = 2e-5, gradients atol = rtol =
5e-5, the JAX package's own (tests/test_flash_attention.py); the two sides walk the same
256-key tiles and differ only in summation order. bfloat16: atol = rtol = 3e-2 on values and
gradients (the JAX test's); beyond that no element lies more than one bfloat16 step (2^-7
relative, 2^-9 absolute floor) from the JAX kernel's, and at most 1% of the elements of any
output differ from it at all (measured: 0.05% of out, 0.41% of dq, 0.14% of dk, 0.03% of dv at
S=300). On the card, kernel against plain:
within 1e-4 x max|plain| in float32 and 2e-2 x max|plain| in bfloat16, whose 64-key tiles round
the unnormalised probabilities relative to other running maxima than the plain version's 256.

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_flash_attention.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import flash_attention as fl
from multimodal_tpu_torch.ops.attention import attention

torch.set_num_threads(1)

NEG_INF = -1e30


def _qkv(b, sq, sk, h, d, seed=0):
    rng = np.random.default_rng(seed)
    draw = lambda s: rng.standard_normal((b, s, h, d), dtype=np.float32)  # noqa: E731
    return draw(sq), draw(sk), draw(sk), draw(sq)  # q, k, v, do


@functools.lru_cache(maxsize=None)
def _jax_run(b, sq, sk, h, d, causal, dtype_name, loss="vjp", seed=0):
    """Output and (dq, dk, dv) of the JAX operator: the vjp of a seeded cotangent, or the
    gradient of sum(out ** 2) or sum(out)."""
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.ops.flash_attention import flash_attention

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    q, k, v, do = (jnp.asarray(a, dt) for a in _qkv(b, sq, sk, h, d, seed))
    fn = lambda q, k, v: flash_attention(q, k, v, causal=causal)  # noqa: E731
    out, vjp = jax.vjp(fn, q, k, v)
    cot = {"vjp": do, "sq": 2 * out, "sum": jnp.ones_like(out)}[loss]
    f32 = lambda t: np.asarray(t.astype(jnp.float32))  # noqa: E731
    return f32(out), [f32(g) for g in vjp(cot.astype(dt))]


def _port_run(b, sq, sk, h, d, causal, dtype, loss="vjp", seed=0, device="cpu"):
    q, k, v, do = (torch.from_numpy(a).to(device=device, dtype=dtype)
                   for a in _qkv(b, sq, sk, h, d, seed))
    leaves = [t.requires_grad_() for t in (q, k, v)]
    out = fl.flash_attention(*leaves, causal=causal)
    cot = {"vjp": do, "sq": 2 * out.detach(), "sum": torch.ones_like(out)}[loss]
    out.backward(cot)
    return out.detach().float().cpu().numpy(), [t.grad.float().cpu().numpy() for t in leaves]


# the JAX package's own cases
@pytest.mark.parametrize("s,causal", [(50, False), (77, True), (197, False), (300, True),
                                      (300, False)])
def test_forward_matches_jax_f32(s, causal):
    want, _ = _jax_run(2, s, s, 4, 64, causal, "float32")
    got, _ = _port_run(2, s, s, 4, 64, causal, torch.float32)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s,causal,loss", [(77, False, "sq"), (77, True, "sq"),
                                           (300, True, "sum"), (300, True, "vjp")])
def test_grads_match_jax_f32(s, causal, loss):
    _, want = _jax_run(1, s, s, 2, 64, causal, "float32", loss)
    _, got = _port_run(1, s, s, 2, 64, causal, torch.float32, loss)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=5e-5, err_msg=f"d{name}")


def _beyond_one_step(got, want):
    """Share of elements further from ``want`` than one bfloat16 step of its size."""
    step = np.maximum(np.abs(want), 2.0 ** -2) * 2.0 ** -7
    return float((np.abs(got - want) > step).mean())


@pytest.mark.parametrize("s", [77, 300])
def test_forward_and_grads_match_jax_bf16(s):
    want_out, want = _jax_run(2, s, s, 4, 64, True, "bfloat16")
    got_out, got = _port_run(2, s, s, 4, 64, True, torch.bfloat16)
    np.testing.assert_allclose(got_out, want_out, atol=3e-2, rtol=3e-2)
    assert _beyond_one_step(got_out, want_out) == 0 and (got_out != want_out).mean() <= 0.01
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, atol=3e-2, rtol=3e-2, err_msg=f"d{name}")
        assert _beyond_one_step(g, r) == 0 and (g != r).mean() <= 0.01, name


def test_head_dim_80_matches_jax():
    want_out, want = _jax_run(1, 77, 77, 2, 80, True, "float32")
    got_out, got = _port_run(1, 77, 77, 2, 80, True, torch.float32)
    np.testing.assert_allclose(got_out, want_out, atol=2e-5, rtol=2e-5)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=5e-5)


@pytest.mark.parametrize("sq,sk", [(40, 72), (72, 40)])
def test_cross_length_causal_mask_is_top_left(sq, sk):
    """For sq != sk the operator keeps the kernels' top-left mask (key <= query), as the JAX
    operator does, and so differs from the plain attention path's bottom-right mask."""
    want_out, want = _jax_run(1, sq, sk, 2, 64, True, "float32")
    got_out, got = _port_run(1, sq, sk, 2, 64, True, torch.float32)
    np.testing.assert_allclose(got_out, want_out, atol=2e-5, rtol=2e-5)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, atol=5e-5, rtol=5e-5)
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, sq, sk, 2, 64))
    through = attention(q, k, v, causal=True, impl="flash").numpy()
    np.testing.assert_array_equal(through, got_out)
    plain = attention(q, k, v, causal=True, impl="xla").numpy()
    assert np.abs(plain - got_out).max() > 1e-2
    if sq < sk:  # no query sees a key past the last query: those keys get no gradient
        assert np.abs(got[1][:, sq:]).max() == 0 and np.abs(got[2][:, sq:]).max() == 0


@pytest.mark.parametrize("causal", [False, True])
def test_lse_is_the_logsumexp_of_the_masked_logits(causal):
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(2, 300, 300, 2, 32, seed=3))
    out, lse = fl.flash_attention_reference(q, k, v, causal=causal)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * 32 ** -0.5
    if causal:
        logits = logits.masked_fill(~torch.ones(300, 300, dtype=torch.bool).tril(), NEG_INF)
    assert lse.shape == (2, 2, 300) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=2e-6, rtol=2e-6)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v)
    torch.testing.assert_close(out, want, atol=2e-6, rtol=2e-5)


def test_fully_masked_tiles_and_rows_stay_finite():
    """The finite -1e30 sentinel: a row whose keys in a live tile are all masked adds exactly
    0 (rows 0..255 in the second 256-key tile), and the walk never produces NaN; with the
    tile width at 7 the causal diagonal crosses tiles at every offset."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(1, 300, 300, 1, 16, seed=4))
    out, lse = fl.flash_attention_reference(q, k, v, causal=True)
    small, small_lse = fl.flash_attention_reference(q, k, v, causal=True, block_k=7)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    torch.testing.assert_close(small, out, atol=2e-6, rtol=2e-5)
    torch.testing.assert_close(small_lse, lse, atol=2e-6, rtol=2e-6)
    torch.testing.assert_close(out[:, 0], v[:, 0])  # row 0 sees key 0 alone
    grads = fl.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)
    tiled = fl.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True, block_k=7)
    for g, t in zip(grads, tiled):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(t, g, atol=1e-5, rtol=1e-5)


def test_bf16_row_sum_takes_the_unrounded_probabilities():
    """l sums the float32 p while the accumulator takes p rounded to bfloat16, and the
    division comes last: out = (round(p) @ v) / sum(p), not / sum(round(p))."""
    q, k, v, _ = (torch.from_numpy(a).bfloat16() for a in _qkv(4, 64, 64, 2, 16, seed=5))
    out, _ = fl.flash_attention_reference(q, k, v)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 16 ** -0.5
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.bfloat16().float(), v.float())
    l_exact = p.sum(-1).transpose(1, 2)[..., None]
    l_rounded = p.bfloat16().float().sum(-1).transpose(1, 2)[..., None]
    # one product here against the walk's accumulate: a float32 sum-order difference only
    assert (out != (acc / l_exact).bfloat16()).float().mean() < 1e-3
    assert (out != (acc / l_rounded).bfloat16()).float().mean() > 1e-2


@pytest.mark.parametrize("sq,sk,causal", [(9, 9, False), (9, 9, True), (9, 13, True),
                                          (13, 9, True)])
def test_plain_backward_gradcheck_f64(sq, sk, causal):
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((1, sq, 2, 8))).requires_grad_()
    k, v = (torch.from_numpy(rng.standard_normal((1, sk, 2, 8))).requires_grad_()
            for _ in range(2))
    fn = lambda *a: fl.FlashAttention.apply(*a, causal, 0.3)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_function_node_and_plain_backward_on_cpu():
    """On a CPU tensor the operator is a ``FlashAttentionBackward`` node whose gradients are
    the plain backward's; nothing is launched."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(2, 70, 70, 2, 32, seed=6))
    fl.launches.reset_launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fl.flash_attention(*leaves, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(do)
    ref_out, lse = fl.flash_attention_reference(q, k, v, causal=True)
    want = fl.flash_attention_bwd_reference(q, k, v, ref_out, lse, do, causal=True)
    assert torch.equal(out, ref_out)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)
    delta = fl.flash_delta(ref_out, do)
    assert delta.shape == (2, 2, 70) and delta.is_contiguous()
    assert torch.equal(fl.flash_attention_dq(q, k, v, do, lse, delta, causal=True), want[0])
    dk, dv = fl.flash_attention_dkv(q, k, v, do, lse, delta, causal=True)
    assert torch.equal(dk, want[1]) and torch.equal(dv, want[2])
    counts = fl.launches.launch_counts()
    assert {counts[n] for n in ("flash_attention_fwd", "flash_attention_dq",
                                "flash_attention_dkv")} == {0}


def test_flash_supported_gate():
    """The JAX package's own cases (tests/test_flash_attention.py) and the rest of the rule."""
    assert not fl.flash_supported((1, 512, 2, 64), (1, 4096, 2, 64), causal=True)
    assert fl.flash_supported((1, 4096, 2, 64), (1, 4096, 2, 64), causal=True)
    assert fl.flash_supported((8, 2048, 8, 64), (8, 2048, 8, 64), causal=True)
    assert not fl.flash_supported((8, 2048, 8, 64), (8, 2048, 8, 64), causal=False)
    assert not fl.flash_supported((8, 2047, 8, 64), (8, 2047, 8, 64), causal=True)
    assert not fl.flash_supported((1, 2048, 2, 144), (1, 2048, 2, 144), causal=True)
    assert fl.MIN_FLASH_SEQ == 2048
    from multimodal_tpu.ops.flash_attention import flash_supported as jax_supported
    for shape in [((1, 2048, 2, 64), (1, 2048, 2, 64)), ((1, 300, 2, 64), (1, 4096, 2, 64)),
                  ((1, 2048, 2, 128), (1, 2048, 2, 128)), ((1, 1024, 2, 64), (1, 1024, 2, 64))]:
        for causal in (False, True):
            assert fl.flash_supported(*shape, causal) == jax_supported(*shape, causal)


def test_impl_flash_runs_and_auto_on_cpu_is_the_plain_path():
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 130, 2, 32, generator=g)
    mask = torch.zeros(1, 1, 130, 130)
    with pytest.raises(ValueError, match="additive mask"):
        attention(q, q, q, mask=mask, impl="flash")
    with pytest.raises(ValueError, match="head_dim 144"):
        attention(torch.zeros(1, 4, 1, 144), torch.zeros(1, 4, 1, 144),
                  torch.zeros(1, 4, 1, 144), impl="flash")
    out = attention(q.requires_grad_(), q, q, causal=True, impl="flash")
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    torch.testing.assert_close(out, attention(q, q, q, causal=True, impl="xla"),
                               atol=2e-6, rtol=2e-5)
    # auto on a CPU tensor is the plain path also where flash_supported holds
    long = torch.randn(1, 2048, 1, 8, generator=g).requires_grad_()
    assert fl.flash_supported(long.shape, long.shape, causal=True)
    auto = attention(long, long, long, causal=True)
    assert "FlashAttention" not in type(auto.grad_fn).__name__
    torch.testing.assert_close(auto, attention(long, long, long, causal=True, impl="xla"))
    assert fl.launches.launch_counts()["flash_attention_fwd"] == 0


def test_kernel_operand_checks_raise():
    q = torch.zeros(1, 16, 2, 64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fl._check_kernel_operands(q.double(), q.double(), q.double())
    with pytest.raises(ValueError, match="multiple of 8"):
        fl._check_kernel_operands(q[..., :36].contiguous(), q[..., :36].contiguous(),
                                  q[..., :36].contiguous())
    with pytest.raises(ValueError, match="expected"):
        fl._check_kernel_operands(q, q, q[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        fl._check_kernel_operands(q, q, q.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="row statistics"):
        fl._check_kernel_operands(q, q, q, like_q=(q,), rows=(torch.zeros(1, 16, 2),))
    fl._check_kernel_operands(q, q[:, :8].contiguous(), q[:, :8].contiguous(), like_q=(q,),
                              rows=(torch.zeros(1, 2, 16),))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fl.flash_attention_fwd(q.to("meta"), q.to("meta"), q.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (batch, sq, sk, heads, head_dim, causal): ragged tails, several tiles, sq != sk, D = 80 / 128
CUDA_SHAPES = [(2, 300, 300, 4, 64, True), (2, 300, 300, 4, 64, False),
               (1, 2050, 2050, 2, 64, True), (1, 40, 72, 2, 64, True), (1, 72, 40, 2, 64, True),
               (2, 257, 257, 3, 80, True), (1, 500, 500, 2, 128, False), (1, 63, 65, 1, 8, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,d,causal", CUDA_SHAPES)
def test_cuda_kernels_match_plain(cuda_device, b, sq, sk, h, d, causal, dtype, tol):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(b, sq, sk, h, d, seed=7))
    kw = dict(causal=causal)
    fl.launches.reset_launch_counts()
    out, lse = fl.flash_attention_fwd(q, k, v, **kw)
    delta = fl.flash_delta(out, do)
    got = (out, lse, fl.flash_attention_dq(q, k, v, do, lse, delta, **kw),
           *fl.flash_attention_dkv(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    counts = fl.launches.launch_counts()
    assert [counts[n] for n in ("flash_attention_fwd", "flash_attention_dq",
                                "flash_attention_dkv")] == [1, 1, 1]
    want_out, want_lse = fl.flash_attention_reference(q, k, v, **kw)
    want = (want_out, want_lse,
            *fl.flash_attention_bwd_reference(q, k, v, want_out, want_lse, do, **kw))
    for name, g, r in zip(["out", "lse", "dq", "dk", "dv"], got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_backward_repeats_bit_for_bit(cuda_device, dtype):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(2, 700, 700, 4, 64, seed=8))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        fl.flash_attention(*leaves, causal=True).backward(do)
        runs.append([t.grad for t in leaves])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_auto_takes_the_flash_kernels(cuda_device):
    """attention(impl="auto") on a CUDA tensor at a causal S=2048 launches the three
    kernels, forward and backward, and agrees with the plain path; without ``causal`` it is
    the plain path."""
    q, k, v, do = (torch.from_numpy(a).to(cuda_device) for a in _qkv(1, 2048, 2048, 2, 64, 9))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fl.launches.reset_launch_counts()
    out = attention(*leaves, causal=True)
    out.backward(do)
    counts = fl.launches.launch_counts()
    assert [counts[n] for n in ("flash_attention_fwd", "flash_attention_dq",
                                "flash_attention_dkv")] == [1, 1, 1]
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = attention(*plain, causal=True, impl="xla")
    want.backward(do)
    torch.testing.assert_close(out, want, atol=2e-5, rtol=2e-5)
    for g, r in zip(leaves, plain):
        torch.testing.assert_close(g.grad, r.grad, atol=5e-5, rtol=5e-5)
    fl.launches.reset_launch_counts()
    attention(q, k, v)
    assert fl.launches.launch_counts()["flash_attention_fwd"] == 0
