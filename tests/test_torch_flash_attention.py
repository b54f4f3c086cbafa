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
within 1e-4 x max|plain| in float32 and 2e-2 x max|plain| in bfloat16, whose key tiles round
the unnormalised probabilities relative to other running maxima than the plain version's 256.

The kernels' schedule (``tile_walk_fwd``, ``tile_walk_dq``, ``tile_walk_dkv``: their blocks,
warps, streamed tiles, live n-tiles, edge tests and rounding points in plain torch) is held to
the JAX package's ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel`` at ragged and cross
lengths and head dims 24, 64 and 88; the float32 kernels' 3xTF32 arithmetic is emulated on the
CPU (TF32 rounding on the bits, the split, the three products) and holds the card's float32
limit, 1e-4 x max|JAX|, where one TF32 product does not, forward and backward.

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


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte boundary."""
    off = torch.zeros(t.numel() + 4, dtype=t.dtype, device=t.device)[1:t.numel() + 1]
    off = off.view_as(t).copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16
    return off


def test_kernel_operand_check_names_a_misaligned_operand():
    """The backward kernels load by 16-byte cp.async: an operand whose base is not 16-byte
    aligned raises a ValueError that names it, before anything is launched."""
    q = torch.zeros(1, 16, 2, 64)
    rows = (torch.zeros(1, 2, 16), torch.zeros(1, 2, 16))
    fl._check_kernel_operands(q, q, q, like_q=(q,), rows=rows)
    for name, args in [("q", (_misaligned(q), q, q, (q,))), ("k", (q, _misaligned(q), q, (q,))),
                       ("v", (q, q, _misaligned(q), (q,))), ("do", (q, q, q, (_misaligned(q),)))]:
        with pytest.raises(ValueError, match=f"operand {name} must be 16-byte aligned"):
            fl._check_kernel_operands(*args[:3], like_q=args[3], rows=rows)
    with pytest.raises(ValueError, match="multiple of 8"):
        fl._check_kernel_operands(q[..., :60].contiguous(), q[..., :60].contiguous(),
                                  q[..., :60].contiguous())


# --------------------------------------------------------------------- the kernels' schedule
# The backward kernels (ops/csrc/flash_attention.cu) as plain torch, step by step: blocks of
# WARPS warps, a warp owning 16 rows (bfloat16) or 32 (float32 up to D=64: two m-tiles), the
# streamed tiles KT rows long; each warp's head products over its live n-tiles (pairs of 8),
# the mask tests only on a tile the kernel calls an edge tile, the second product's k-steps
# (16 in bfloat16, 8 in float32) only below the live rows, bf16 rounding where the kernels
# pack (ds for dq and dk, p for dv), sm_scale once at the store. If a bound or an edge test of
# the kernels were wrong, a live entry would go missing or a masked one would count here too.
WARPS, KT = 4, 32


def _warp_rows(dtype, d):
    return 32 if dtype == torch.float32 and d <= 64 else 16


def _k_step(dtype):
    return 8 if dtype == torch.float32 else 16


def _rows_tile(t, r0, n):
    """Rows r0..r0+n-1 of a [B, H, S, X] tensor, zero past its end (the kernels' zero fill)."""
    out = torch.zeros(t.shape[:2] + (n,) + t.shape[3:], dtype=t.dtype)
    part = t[:, :, r0:r0 + n]
    out[:, :, :part.shape[2]] = part
    return out


def _live_cols(live, kt=KT):
    """Columns of a streamed tile the head products form: n-tiles in pairs."""
    return min(kt, 8 * (live + live % 2))


def _steps_below(nrows, dtype, kt=KT):
    """Mask of the streamed tile's rows whose k-step of the second product runs."""
    step = _k_step(dtype)
    return ((torch.arange(kt) // step) * step < nrows).float()


def tile_walk_dq(q, k, v, do, lse, delta, *, causal, scale):
    dt, f32 = q.dtype, torch.float32
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh, kh, vh, doh = (t.transpose(1, 2).to(f32) for t in (q, k, v, do))
    lse, delta = lse[..., None].float(), delta[..., None].float()
    wr = _warp_rows(dt, d)
    dq = torch.zeros_like(qh)
    for r0 in range(0, sq, wr * WARPS):
        rows = min(wr * WARPS, sq - r0)
        kmax = min(sk, r0 + rows) if causal else sk
        for wrow in range(0, rows, wr):
            wmax = min(kmax, r0 + wrow + wr) if causal else kmax
            rs = slice(r0 + wrow, min(r0 + wrow + wr, sq))
            row = torch.arange(rs.start, rs.stop)[:, None]
            acc = torch.zeros(b, h, rs.stop - rs.start, d)
            for c0 in range(0, kmax, KT):
                live = min(KT // 8, (wmax - c0 + 7) // 8)
                if live <= 0:
                    continue
                cols = _live_cols(live)
                kt, vt = _rows_tile(kh, c0, KT), _rows_tile(vh, c0, KT)
                s = torch.zeros(b, h, row.shape[0], KT)
                dp = torch.zeros_like(s)
                s[..., :cols] = qh[:, :, rs] @ kt[:, :, :cols].transpose(-1, -2) * scale
                dp[..., :cols] = doh[:, :, rs] @ vt[:, :, :cols].transpose(-1, -2)
                if c0 + KT > kmax or (causal and c0 + KT - 1 > r0 + wrow):  # edge_tile
                    key = c0 + torch.arange(KT)[None, :]
                    s = torch.where((key < kmax) & ((key <= row) | (not causal)), s, NEG_INF)
                ds = (torch.exp(s - lse[:, :, rs]) * (dp - delta[:, :, rs])).to(dt).to(f32)
                acc += (ds * _steps_below(wmax - c0, dt)) @ kt
            dq[:, :, rs] = acc
    return (dq * scale).to(dt).transpose(1, 2)


def tile_walk_dkv(q, k, v, do, lse, delta, *, causal, scale):
    dt, f32 = q.dtype, torch.float32
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh, kh, vh, doh = (t.transpose(1, 2).to(f32) for t in (q, k, v, do))
    lse, delta = lse[..., None, :].float(), delta[..., None, :].float()  # per column
    wr = _warp_rows(dt, d)
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for j0 in range(0, sk, wr * WARPS):
        keys = min(wr * WARPS, sk - j0)
        for wrow in range(0, keys, wr):
            ks = slice(j0 + wrow, min(j0 + wrow + wr, sk))
            key = torch.arange(ks.start, ks.stop)[:, None]
            acc_k = torch.zeros(b, h, key.shape[0], d)
            acc_v = torch.zeros_like(acc_k)
            for q0 in range(j0 if causal else 0, sq, KT):
                cols = _live_cols(min(KT // 8, (sq - q0 + 7) // 8))
                qt, dot = _rows_tile(qh, q0, KT), _rows_tile(doh, q0, KT)
                lt = _rows_tile(lse.transpose(-1, -2), q0, KT).transpose(-1, -2)
                dlt = _rows_tile(delta.transpose(-1, -2), q0, KT).transpose(-1, -2)
                pt = torch.zeros(b, h, key.shape[0], KT)
                dst = torch.zeros_like(pt)
                pt[..., :cols] = kh[:, :, ks] @ qt[:, :, :cols].transpose(-1, -2) * scale
                dst[..., :cols] = vh[:, :, ks] @ dot[:, :, :cols].transpose(-1, -2)
                p = torch.exp(pt - lt)
                if q0 + KT > sq or j0 + wrow + wr > sk or (causal and j0 + wrow + wr - 1 > q0):
                    row = q0 + torch.arange(KT)[None, :]
                    p = torch.where((row < sq) & ((key <= row) | (not causal)), p, 0.0)
                ds = p * (dst - dlt)
                below = _steps_below(sq - q0, dt)
                acc_v += (p.to(dt).to(f32) * below) @ dot
                acc_k += (ds.to(dt).to(f32) * below) @ qt
            dk[:, :, ks], dv[:, :, ks] = acc_k, acc_v
    return (dk * scale).to(dt).transpose(1, 2), dv.to(dt).transpose(1, 2)


def _walk_inputs(b, sq, sk, h, d, causal, dtype, seed=0):
    """The port's tensors of ``_jax_run``'s inputs with the plain forward's lse and delta, as
    the operator's backward hands them to the kernels."""
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _qkv(b, sq, sk, h, d, seed))
    out, lse = fl.flash_attention_reference(q, k, v, causal=causal)
    return q, k, v, do, lse, fl.flash_delta(out, do)


# ragged lengths, sq != sk both ways, a tile edge; head dims 24, 64 and 88 (no multiple of 16)
WALK_SHAPES = [(72, 40, True), (40, 72, True), (130, 130, True), (33, 33, False)]


@pytest.mark.parametrize("d", [24, 64, 88])
@pytest.mark.parametrize("sq,sk,causal", WALK_SHAPES)
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tile_walk_matches_jax_kernels(sq, sk, causal, d, dtype_name):
    """The kernels' schedule against the JAX package's _dq_kernel and _dkv_kernel (interpret
    mode): float32 within 5e-6 x max|JAX| (the order of the sums only; measured <= 7.1e-7),
    bfloat16 within 2e-3 x max|JAX|, a tenth of the card's limit (the two sides round the same
    products at the same points, and most outputs agree to the bit; the forward's out, and so
    delta, differs from the JAX forward's by single bf16 steps: measured <= 2.4e-4)."""
    dtype = torch.float32 if dtype_name == "float32" else torch.bfloat16
    _, want = _jax_run(1, sq, sk, 2, d, causal, dtype_name)
    q, k, v, do, lse, delta = _walk_inputs(1, sq, sk, 2, d, causal, dtype)
    kw = dict(causal=causal, scale=d ** -0.5)
    got = (tile_walk_dq(q, k, v, do, lse, delta, **kw),
           *tile_walk_dkv(q, k, v, do, lse, delta, **kw))
    tol = 5e-6 if dtype == torch.float32 else 2e-3
    for name, g, r in zip(("dq", "dk", "dv"), got, want):
        err = np.abs(g.float().numpy() - r).max()
        assert err <= tol * np.abs(r).max(), (name, err, np.abs(r).max())


def test_tile_walk_is_the_plain_backward_in_float32():
    """At a length with many tiles and both m-tile counts (D=64: two a warp; D=80: one) the
    walk is the plain backward up to the order of the sums."""
    for d in (64, 80):
        q, k, v, do, lse, delta = _walk_inputs(2, 200, 200, 2, d, True, torch.float32, seed=11)
        kw = dict(causal=True, sm_scale=d ** -0.5)
        want = fl.flash_attention_bwd_reference(q, k, v, None, lse, do, delta=delta, **kw)
        got = (tile_walk_dq(q, k, v, do, lse, delta, causal=True, scale=d ** -0.5),
               *tile_walk_dkv(q, k, v, do, lse, delta, causal=True, scale=d ** -0.5))
        for g, r in zip(got, want):
            assert (g - r).abs().max() <= 1e-5 * r.abs().max()


def tile_walk_fwd(q, k, v, *, causal, scale):
    """The forward kernel's schedule: (out, lse). Blocks of WARPS warps, the warps' rows as in
    the dQ kernel; each warp walks the key tiles (64 keys in bfloat16, 32 in float32) below
    the block's causal bound, skipping those past its own, with an online softmax: logits over
    the live n-tiles, the mask tests only on an edge tile, the running max m and the sum l of
    the unrounded p, the accumulator rescaled and += round_T(p) @ v over the k-steps below the
    warp's bound; out = acc / l and lse = m + log(l)."""
    dt, f32 = q.dtype, torch.float32
    b, sq, h, d = q.shape
    sk = k.shape[1]
    qh, kh, vh = (t.transpose(1, 2).to(f32) for t in (q, k, v))
    wr = _warp_rows(dt, d)
    kt_rows = 64 if dt == torch.bfloat16 else 32
    out, lse = torch.zeros_like(qh), torch.zeros(b, h, sq)
    for r0 in range(0, sq, wr * WARPS):
        rows = min(wr * WARPS, sq - r0)
        kmax = min(sk, r0 + rows) if causal else sk
        for wrow in range(0, rows, wr):
            wmax = min(kmax, r0 + wrow + wr) if causal else kmax
            rs = slice(r0 + wrow, min(r0 + wrow + wr, sq))
            row = torch.arange(rs.start, rs.stop)[:, None]
            m = torch.full((b, h, row.shape[0], 1), NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros(b, h, row.shape[0], d)
            for c0 in range(0, kmax, kt_rows):
                live = min(kt_rows // 8, (wmax - c0 + 7) // 8)
                if live <= 0:
                    continue
                cols = _live_cols(live, kt_rows)
                kt, vt = _rows_tile(kh, c0, kt_rows), _rows_tile(vh, c0, kt_rows)
                s = torch.zeros(b, h, row.shape[0], kt_rows)
                s[..., :cols] = qh[:, :, rs] @ kt[:, :, :cols].transpose(-1, -2) * scale
                if c0 + kt_rows > kmax or (causal and c0 + kt_rows - 1 > r0 + wrow):  # edge_tile
                    key = c0 + torch.arange(kt_rows)[None, :]
                    s = torch.where((key < kmax) & ((key <= row) | (not causal)), s, NEG_INF)
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                below = _steps_below(wmax - c0, dt, kt_rows)
                acc = acc * alpha + (p.to(dt).to(f32) * below) @ vt
                m = m_new
            safe_l = torch.where(l == 0, torch.ones_like(l), l)
            out[:, :, rs] = acc / safe_l
            lse[:, :, rs] = (m + torch.log(safe_l))[..., 0]
    return out.to(dt).transpose(1, 2), lse


@functools.lru_cache(maxsize=None)
def _jax_fwd(b, sq, sk, h, d, causal, dtype_name, seed=0):
    """(out [B, Sq, H, D], lse [B, H, Sq]) of the JAX package's forward kernel, _fwd_kernel
    through _fwd on the operator's padded [B, H, S, D] layout, as float32 numpy."""
    import jax.numpy as jnp

    from multimodal_tpu.ops import flash_attention as jfl

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    q, k, v, _ = (jnp.asarray(a, dt) for a in _qkv(b, sq, sk, h, d, seed))
    bq, bk = jfl._block_sizes(sq, sk)

    def prep(x, s_p):
        x = jnp.transpose(x, (0, 2, 1, 3))
        return jnp.pad(x, ((0, 0), (0, 0), (0, s_p - x.shape[2]), (0, 0)))

    out, lse = jfl._fwd(prep(q, jfl._round_up(sq, bq)), prep(k, jfl._round_up(sk, bk)),
                        prep(v, jfl._round_up(sk, bk)), causal, d ** -0.5, sk)
    out = np.asarray(out[:, :, :sq].astype(jnp.float32)).transpose(0, 2, 1, 3)
    return out, np.asarray(lse[:, :, :sq, 0])


@pytest.mark.parametrize("d", [24, 64, 88])
@pytest.mark.parametrize("sq,sk,causal", WALK_SHAPES + [(40, 72, False)])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_tile_walk_fwd_matches_jax_kernel_and_plain(sq, sk, causal, d, dtype_name):
    """The forward kernel's schedule against the JAX package's _fwd_kernel (interpret mode)
    and the plain forward: out and lse within 1e-5 x max|reference| in float32 (the order of
    the sums only) and 2e-2 x max|reference| in bfloat16 (the unnormalised p is rounded
    against other running maxima: 64-key tiles here, 128 or 256 keys there)."""
    dtype = torch.float32 if dtype_name == "float32" else torch.bfloat16
    q, k, v, _ = (torch.from_numpy(a).to(dtype) for a in _qkv(1, sq, sk, 2, d))
    got = tile_walk_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    plain = fl.flash_attention_reference(q, k, v, causal=causal)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for ref in (_jax_fwd(1, sq, sk, 2, d, causal, dtype_name),
                tuple(t.float().numpy() for t in plain)):
        for name, g, r in zip(("out", "lse"), got, ref):
            err = np.abs(g.float().numpy() - r).max()
            assert err <= tol * np.abs(r).max(), (name, err, np.abs(r).max())


# ----------------------------------------------------------------------------- 3xTF32
def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32: to nearest on the 13 dropped mantissa bits, ties away (the
    kernels' rounding: add half a TF32 ulp to the bits, clear the 13)."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """A float32 operand as the tensor core reads it as TF32: its top 19 bits (truncated)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b as the float32 kernels form it: each operand split into big = tf32(x) and
    small = x - big, which the tensor core reads truncated; small_a big_b + big_a small_b +
    big_a big_b. The TF32 products are exact in float32 (11-bit significands); the sums are
    float32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_read(a - a_big), _tf32_read(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _tf32_backward(mm, q, k, v, do, lse, delta, *, causal, scale):
    """The flash backward with every product formed by ``mm``: (dq, dk, dv)."""
    qh, kh, vh, doh = (t.transpose(1, 2) for t in (q, k, v, do))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(doh, vh.transpose(-1, -2)) - delta[..., None])
    grads = (mm(ds, kh) * scale, mm(ds.transpose(-1, -2), qh) * scale,
             mm(p.transpose(-1, -2), doh))
    return tuple(t.transpose(1, 2) for t in grads)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    x = torch.tensor([1.0, -1.0, 1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 1 + 3 * 2 ** -12])
    want = [1.0, -1.0, 1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 1 + 2 ** -10]
    assert _tf32(x).tolist() == want
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(4096, dtype=np.float32))
    big = _tf32(r)
    assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((big - r).abs() <= 2.0 ** -11 * r.abs()).all()
    small = r - big  # exact; the tensor core reads it truncated, within 2^-21 relative of x
    assert (small.abs() <= 2.0 ** -11 * r.abs()).all()
    assert ((big + _tf32_read(small) - r).abs() <= 2.0 ** -21 * r.abs()).all()


@pytest.mark.parametrize("s,causal", [(300, True), (197, False)])
def test_3xtf32_backward_holds_the_float32_limit_and_one_tf32_product_does_not(s, causal):
    """The float32 kernels' arithmetic, emulated: with three TF32 products a product the
    backward stays within the card's float32 limit, 1e-4 x max|JAX float32|, of the JAX
    kernels; with one TF32 product it does not (its error enters the logits and exp), so the
    limit tells the two apart."""
    _, want = _jax_run(1, s, s, 2, 64, causal, "float32")
    q, k, v, do, lse, delta = _walk_inputs(1, s, s, 2, 64, causal, torch.float32)
    kw = dict(causal=causal, scale=64 ** -0.5)
    rel = lambda got: max(np.abs(g.numpy() - r).max() / np.abs(r).max()  # noqa: E731
                          for g, r in zip(got, want))
    three = rel(_tf32_backward(_mm_3xtf32, q, k, v, do, lse, delta, **kw))
    one = rel(_tf32_backward(_mm_1xtf32, q, k, v, do, lse, delta, **kw))
    assert three <= 1e-4, three
    assert one > 1e-4, one
    assert one > 20 * three


def _tf32_forward(mm, q, k, v, *, causal, scale):
    """The flash forward with both products formed by ``mm`` and the softmax in float32:
    (out, lse)."""
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    s = mm(qh, kh.transpose(-1, -2)) * scale
    if causal:  # top-left: key <= query
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    return (mm(p, vh) / l).transpose(1, 2), (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("s,causal", [(300, True), (197, False)])
def test_3xtf32_forward_holds_the_float32_limit_and_one_tf32_product_does_not(s, causal):
    """The float32 forward kernel's arithmetic, emulated: with three TF32 products a product
    out and lse stay within the card's float32 limit, 1e-4 x max|JAX float32|, of the JAX
    forward kernel; with one TF32 product out does not."""
    want = _jax_fwd(1, s, s, 2, 64, causal, "float32")
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, s, s, 2, 64))
    kw = dict(causal=causal, scale=64 ** -0.5)
    rel = lambda got: [np.abs(g.numpy() - r).max() / np.abs(r).max()  # noqa: E731
                       for g, r in zip(got, want)]
    three = rel(_tf32_forward(_mm_3xtf32, q, k, v, **kw))
    one = rel(_tf32_forward(_mm_1xtf32, q, k, v, **kw))
    print(f"S={s} causal={causal}: out, lse err / max|JAX|: 3xTF32 {three}, 1xTF32 {one}")
    assert max(three) <= 1e-4, three
    assert one[0] > 1e-4, one
    assert one[0] > 20 * three[0]


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
    """Two runs of the operator give the same bits: the forward's out and the three gradients."""
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(2, 700, 700, 4, 64, seed=8))
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fl.flash_attention(*leaves, causal=True)
        out.backward(do)
        runs.append([out.detach()] + [t.grad for t in leaves])
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_misaligned_operand_raises_before_the_launch(cuda_device, dtype):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(1, 64, 64, 2, 64, 10))
    out, lse = fl.flash_attention_fwd(q, k, v, causal=True)
    delta = fl.flash_delta(out, do)
    fl.launches.reset_launch_counts()
    with pytest.raises(ValueError, match="operand do must be 16-byte aligned"):
        fl.flash_attention_dq(q, k, v, _misaligned(do), lse, delta, causal=True)
    with pytest.raises(ValueError, match="operand k must be 16-byte aligned"):
        fl.flash_attention_dkv(q, _misaligned(k), v, do, lse, delta, causal=True)
    counts = fl.launches.launch_counts()
    assert counts["flash_attention_dq"] == counts["flash_attention_dkv"] == 0


@pytest.mark.cuda
def test_cuda_float32_backward_holds_its_limit_at_s8192(cuda_device):
    """The float32 backward's error grows with the sweep's length (3xTF32 products, f32
    sums): at S=8192, four times the longest shipped text context, dq, dk and dv stay within
    1e-4 x max|plain| on this seeded draw. Prints each ratio."""
    g = torch.Generator(device=cuda_device).manual_seed(8192)
    q, k, v, do = (torch.randn(1, 8192, 8, 64, generator=g, device=cuda_device)
                   for _ in range(4))
    out, lse = fl.flash_attention_reference(q, k, v, causal=True)
    delta = fl.flash_delta(out, do)
    got = (fl.flash_attention_dq(q, k, v, do, lse, delta, causal=True),
           *fl.flash_attention_dkv(q, k, v, do, lse, delta, causal=True))
    want = fl.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)
    for name, a, r in zip(["dq", "dk", "dv"], got, want):
        ratio = ((a - r).abs().max() / r.abs().max()).item()
        print(f"S=8192 float32 {name}: max err / max|plain| = {ratio:.3e}")
        assert torch.isfinite(a).all() and ratio <= 1e-4, (name, ratio)


@pytest.mark.cuda
def test_cuda_float32_forward_holds_its_limit_at_s8192(cuda_device):
    """The float32 forward's sums run longest at S=8192: out and lse stay within 1e-4 x
    max|plain| on this seeded draw. Prints each ratio."""
    g = torch.Generator(device=cuda_device).manual_seed(8193)
    q, k, v = (torch.randn(1, 8192, 8, 64, generator=g, device=cuda_device) for _ in range(3))
    got = fl.flash_attention_fwd(q, k, v, causal=True)
    want = fl.flash_attention_reference(q, k, v, causal=True)
    for name, a, r in zip(["out", "lse"], got, want):
        ratio = ((a - r).abs().max() / r.abs().max()).item()
        print(f"S=8192 float32 forward {name}: max err / max|plain| = {ratio:.3e}")
        assert torch.isfinite(a).all() and ratio <= 1e-4, (name, ratio)


@pytest.mark.parametrize("d", [36, 100])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_equals_the_plain_version(d, causal):
    """The operator's CUDA path zero-pads D up to a multiple of 8 for the kernels (which take
    no other D) and slices out, dq, dk and dv back, with sm_scale from the true D. Run here
    through the plain versions, the padded path equals the unpadded one in value and
    gradient."""
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(2, 40, 40, 3, d, seed=d))
    scale = d ** -0.5

    def run(pad):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fl.FlashAttention.apply(*leaves, causal, scale, pad)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    padded, plain = run(True), run(False)
    for name, got, want in zip(("out", "dq", "dk", "dv"), padded, plain):
        assert got.shape == (2, 40, 3, d), name
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5, msg=name)
    want_out = fl.flash_attention_reference(q, k, v, causal=causal)[0]
    torch.testing.assert_close(padded[0], want_out, atol=1e-6, rtol=1e-5)


def test_the_kernels_see_a_padded_head_dim(monkeypatch):
    """What reaches the kernel wrappers under the pad: D rounded up to 8, zero beyond the
    true D, and the true D's scale."""
    seen = []
    real_fwd = fl.flash_attention_fwd

    def spy(q, k, v, *, causal, sm_scale):
        seen.append((q.shape[-1], float(q[..., 100:].abs().max()), sm_scale))
        return real_fwd(q, k, v, causal=causal, sm_scale=sm_scale)

    monkeypatch.setattr(fl, "flash_attention_fwd", spy)
    q, k, v, _ = (torch.from_numpy(a) for a in _qkv(1, 16, 16, 2, 100, seed=1))
    out = fl.FlashAttention.apply(q, k, v, True, 100 ** -0.5, True)
    assert out.shape == (1, 16, 2, 100) and seen == [(104, 0.0, 100 ** -0.5)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d", [36, 100])
def test_cuda_padded_head_dim_matches_plain_at_s2048(cuda_device, d, dtype, tol):
    """auto at S=2048 causal with a D the kernels do not take (width 600 over 6 heads is
    D=100) runs the flash kernels on the padded D and agrees with the plain path."""
    from multimodal_tpu_torch.ops import launches

    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype)
                   for a in _qkv(1, 2048, 2048, 2, d, seed=d))
    assert fl.flash_supported(q.shape, k.shape, causal=True)
    outs = []
    for impl in ("auto", "xla"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        launches.reset_launch_counts()
        out = attention(*leaves, causal=True, impl=impl)
        out.backward(do)
        counts = launches.launch_counts()
        outs.append([out.detach().float()] + [t.grad.float() for t in leaves])
        flash = counts["flash_attention_fwd"] + counts["flash_attention_dq"]
        assert flash == (2 if impl == "auto" else 0), counts
    for name, got, want in zip(("out", "dq", "dk", "dv"), *outs):
        assert got.shape == (1, 2048, 2, d)
        err, ref = (got - want).abs().max().item(), want.abs().max().item()
        assert err <= tol * ref, (name, err, ref)
