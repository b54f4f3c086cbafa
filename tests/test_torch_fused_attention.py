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

The kernels walk the keys in tiles of 32 rows (bfloat16) or 64 (float32)
(``ops/csrc/attention_passes.cuh``).
``tile_walk_forward`` and ``tile_walk_backward`` below are that schedule in plain torch: one
online-softmax sweep (running row max and sum of exp, the accumulator and delta rescaled when
the max moves), a second sweep for ds and dq, then the key-tile pass that rebuilds p and ds from
the three saved numbers per row. They are held to the plain versions at ragged lengths, so the
sweep algebra and the ragged masks are checked on the CPU: in float32 within 1e-5 x max|plain|
(the order of the sums only), in bfloat16 within 2e-2 x max|plain| (the online sweep rounds the
unnormalised probability where the plain versions round the normalised one) with the exact
probabilities (the fused backward) and with the rounded ones (the block backward's attention
half).

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


# one past a 64-row tile edge and one short of it: (seq, heads, head_dim, causal)
TILE_EDGE_SHAPES = [(129, 2, 64, True), (191, 2, 64, False)]


@pytest.mark.parametrize("s,h,d,causal", TILE_EDGE_SHAPES)
def test_tile_edge_forward_matches_jax_f32(s, h, d, causal):
    want, _ = _jax_run(s, h, d, causal, "float32")
    got, _ = _port_run(s, h, d, causal, torch.float32)
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("s,h,d,causal", TILE_EDGE_SHAPES)
def test_tile_edge_grads_match_jax_f32(s, h, d, causal):
    _, want = _jax_run(s, h, d, causal, "float32")
    _, got = _port_run(s, h, d, causal, torch.float32)
    for name, g, r in zip("qkv", got, want):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


TILE = 64  # key rows (and query rows) per tile of the schedule below; the kernels use 32 and 64


def _tile_logits(qh, kh, c0, scale, causal):
    """Masked logits [B, H, S, <=TILE] of every query row against key tile c0, in f32."""
    s = qh.shape[-2]
    kt = kh[..., c0:c0 + TILE, :]
    logits = (qh @ kt.transpose(-1, -2)) * scale
    if causal:
        rows = torch.arange(s).view(-1, 1)
        cols = torch.arange(c0, c0 + kt.shape[-2]).view(1, -1)
        logits = torch.where(cols <= rows, logits, torch.full_like(logits, fa.NEG_INF))
    return logits


def _online_sweep(qh, kh, vh, doh, scale, causal, dt, exact_delta):
    """The kernels' first sweep, one key tile at a time: the running max m and sum of exp l,
    and either the running f32 sum of exp(logit - m) dp (``exact_delta``: delta from the exact
    probabilities) or the running sum of round(exp(logit - m)) v (out, unnormalised), each
    rescaled by exp(m_old - m_new) when m moves. Returns (m, l, that sum)."""
    f32 = torch.float32
    m = torch.full(qh.shape[:-1] + (1,), fa.NEG_INF)
    l = torch.zeros_like(m)
    run = torch.zeros_like(m) if exact_delta else torch.zeros_like(qh)
    for c0 in range(0, qh.shape[-2], TILE):
        logits = _tile_logits(qh, kh, c0, scale, causal)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha, e = torch.exp(m - m_new), torch.exp(logits - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        vt = vh[..., c0:c0 + TILE, :]
        if exact_delta:
            run = run * alpha + (e * (doh @ vt.transpose(-1, -2))).sum(-1, keepdim=True)
        else:
            run = run * alpha + e.to(dt).to(f32) @ vt
        m = m_new
    return m, l, run


def tile_walk_forward(q, k, v, *, heads, causal):
    """The forward's one sweep: an online softmax that rounds exp(logit - m) against the
    running max and divides the f32 accumulator by the sum of exp at the end."""
    f32, dt = torch.float32, q.dtype
    scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh = (fa._heads(t, heads).to(f32) for t in (q, k, v))
    _, l, acc = _online_sweep(qh, kh, vh, None, scale, causal, dt, exact_delta=False)
    return fa._pack((acc / l).to(dt))


def tile_walk_backward(q, k, v, do, *, heads, causal, exact_probs):
    """The dQ pass's two sweeps and the dK/dV pass. Returns (dq, dk, dv, attnpre);
    ``exact_probs`` chooses the probabilities delta and ds see, as the kernels' kExactProbs
    (attnpre is formed without it only)."""
    f32, dt = torch.float32, q.dtype
    scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh, doh = (fa._heads(t, heads).to(f32) for t in (q, k, v, do))
    s = qh.shape[-2]
    m, l, run = _online_sweep(qh, kh, vh, doh, scale, causal, dt, exact_delta=exact_probs)
    if exact_probs:
        delta, attnpre = run / l, torch.zeros_like(qh)
    else:  # delta = rowsum(do * attnpre) from attnpre's f32 accumulator
        delta, attnpre = (doh * run).sum(-1, keepdim=True) / l, run / l

    def probs(c0, rows=slice(None)):
        logits = _tile_logits(qh, kh, c0, scale, causal)[..., rows, :]
        p32 = torch.exp(logits - m[..., rows, :]) / l[..., rows, :]
        pr = p32.to(dt).to(f32)
        return pr, (p32 if exact_probs else pr)

    dq = torch.zeros_like(qh)
    for c0 in range(0, s, TILE):  # the second sweep
        _, pd = probs(c0)
        dp = doh @ vh[..., c0:c0 + TILE, :].transpose(-1, -2)
        ds = (pd * (dp - delta)).to(dt).to(f32)
        dq = dq + ds @ kh[..., c0:c0 + TILE, :]
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for c0 in range(0, s, TILE):  # the dK/dV pass: one key tile, the query rows in tiles
        for r0 in range(c0 if causal else 0, s, TILE):
            rows = slice(r0, r0 + TILE)
            pr, pd = probs(c0, rows)
            dp = doh[..., rows, :] @ vh[..., c0:c0 + TILE, :].transpose(-1, -2)
            ds = (pd * (dp - delta[..., rows, :])).to(dt).to(f32)
            dv[..., c0:c0 + TILE, :] += pr.transpose(-1, -2) @ doh[..., rows, :]
            dk[..., c0:c0 + TILE, :] += ds.transpose(-1, -2) @ qh[..., rows, :]
    return tuple(fa._pack(t.to(dt)) for t in (dq * scale, dk * scale, dv, attnpre))


def _rounded_probs_reference(q, k, v, do, *, heads, causal):
    """The attention half of ``block_attention``'s plain backward (its ``_bwd_core``): delta
    and ds from the rounded probabilities, attnpre = p v. Returns (dq, dk, dv, attnpre)."""
    from multimodal_tpu_torch.ops import block_attention as ba

    f32, dt = torch.float32, q.dtype
    scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh, doh = (ba._split_heads(t, heads) for t in (q, k, v, do))
    p32 = ba._probs(qh, kh, causal).to(f32)
    q32, k32, v32, do32 = (t.to(f32) for t in (qh, kh, vh, doh))
    attnpre = (p32 @ v32).to(dt)
    dv = (p32.transpose(-1, -2) @ do32).to(dt)
    dp = do32 @ v32.transpose(-1, -2)
    ds32 = (p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))).to(dt).to(f32)
    dq = ((ds32 @ k32) * scale).to(dt)
    dk = ((ds32.transpose(-1, -2) @ q32) * scale).to(dt)
    return tuple(ba._merge_heads(t) for t in (dq, dk, dv, attnpre))


def _assert_within(got, want, rel, names):
    for name, g, r in zip(names, got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert err <= rel * r.abs().max().item(), (name, err, r.abs().max().item())


RAGGED = [(70, 2, 32), (129, 2, 64), (191, 2, 64), (197, 3, 64)]  # (seq, heads, head_dim)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,h,d", RAGGED)
def test_tile_walk_matches_plain_f32(s, h, d, causal):
    q, k, v, do = (torch.from_numpy(a) for a in _qkv(s, h, d, seed=11))
    kw = dict(heads=h, causal=causal)
    _assert_within([tile_walk_forward(q, k, v, **kw)],
                   [fa.fused_attention_reference(q, k, v, **kw)], 1e-5, ["out"])
    got = tile_walk_backward(q, k, v, do, exact_probs=True, **kw)
    _assert_within(got[:3], fa.fused_attention_bwd_reference(q, k, v, do, **kw), 1e-5,
                   ["dq", "dk", "dv"])
    # in float32 the rounding is the identity, so both choices of probabilities agree
    _assert_within(tile_walk_backward(q, k, v, do, exact_probs=False, **kw),
                   _rounded_probs_reference(q, k, v, do, **kw), 1e-5,
                   ["dq", "dk", "dv", "attnpre"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,h,d", RAGGED[1:])
def test_tile_walk_matches_plain_bf16_exact_probs(s, h, d, causal):
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv(s, h, d, seed=12))
    kw = dict(heads=h, causal=causal)
    _assert_within([tile_walk_forward(q, k, v, **kw)],
                   [fa.fused_attention_reference(q, k, v, **kw)], 2e-2, ["out"])
    got = tile_walk_backward(q, k, v, do, exact_probs=True, **kw)
    _assert_within(got[:3], fa.fused_attention_bwd_reference(q, k, v, do, **kw), 2e-2,
                   ["dq", "dk", "dv"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,h,d", RAGGED[1:])
def test_tile_walk_matches_plain_bf16_rounded_probs(s, h, d, causal):
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv(s, h, d, seed=13))
    kw = dict(heads=h, causal=causal)
    got = tile_walk_backward(q, k, v, do, exact_probs=False, **kw)
    _assert_within(got, _rounded_probs_reference(q, k, v, do, **kw), 2e-2,
                   ["dq", "dk", "dv", "attnpre"])


@pytest.mark.parametrize("exact_probs", [True, False])
def test_tile_walk_with_32_row_tiles_bf16(exact_probs, monkeypatch):
    """The bfloat16 kernels stream 32-row tiles: the same walk at that tile size."""
    import sys

    monkeypatch.setattr(sys.modules[__name__], "TILE", 32)
    s, h, d = 197, 3, 64
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv(s, h, d, seed=15))
    kw = dict(heads=h, causal=True)
    _assert_within([tile_walk_forward(q, k, v, **kw)],
                   [fa.fused_attention_reference(q, k, v, **kw)], 2e-2, ["out"])
    got = tile_walk_backward(q, k, v, do, exact_probs=exact_probs, **kw)
    if exact_probs:
        _assert_within(got[:3], fa.fused_attention_bwd_reference(q, k, v, do, **kw), 2e-2,
                       ["dq", "dk", "dv"])
    else:
        _assert_within(got, _rounded_probs_reference(q, k, v, do, **kw), 2e-2,
                       ["dq", "dk", "dv", "attnpre"])


def test_tile_walk_tells_exact_from_rounded_probs_bf16():
    """The two instantiations differ where the plain versions do: with the exact
    probabilities the walk lands nearer the fused backward than the block backward's half."""
    s, h, d = 129, 2, 64
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv(s, h, d, seed=14))
    kw = dict(heads=h, causal=False)
    exact = tile_walk_backward(q, k, v, do, exact_probs=True, **kw)[0].float()
    rounded = tile_walk_backward(q, k, v, do, exact_probs=False, **kw)[0].float()
    fused = fa.fused_attention_bwd_reference(q, k, v, do, **kw)[0].float()
    block = _rounded_probs_reference(q, k, v, do, **kw)[0].float()
    assert not torch.equal(exact, rounded)
    assert (exact - fused).abs().mean() < (exact - block).abs().mean()
    assert (rounded - block).abs().mean() < (rounded - fused).abs().mean()


def test_kernel_operand_check_names_the_operand():
    """The kernels load 16 bytes at a time: a head dim that is no multiple of 8, a strided or
    a misaligned operand raises a ValueError that names it, before anything is launched."""
    q = torch.zeros(2, 130, 64)
    fa._check_kernel_operands((q, q, q, q), 2)
    off = torch.zeros(q.numel() + 1)[1:].view_as(q)  # 4 bytes past an aligned base
    assert off.is_contiguous() and off.data_ptr() % 16
    with pytest.raises(ValueError, match="operand v must be 16-byte aligned"):
        fa._check_kernel_operands((q, q, off), 2)
    with pytest.raises(ValueError, match="operand do must be 16-byte aligned"):
        fa._check_kernel_operands((q, q, q, off), 2)
    with pytest.raises(ValueError, match="operand k must be contiguous"):
        fa._check_kernel_operands((q, q.transpose(0, 1).contiguous().transpose(0, 1), q), 2)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa._check_kernel_operands((q[..., :60].contiguous(),) * 3, 5)  # head dim 12
    with pytest.raises(ValueError, match="operand k .*expected"):
        fa._check_kernel_operands((q, q[:, :8].contiguous(), q), 2)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check_kernel_operands((q.half(),) * 3, 2)


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
    flash = attention(q, q, q, impl="flash")  # runs the flash operator (its plain version here)
    torch.testing.assert_close(flash, attention(q, q, q, impl="xla"), atol=3e-5, rtol=3e-5)
    with pytest.raises(ValueError, match="additive mask"):
        attention(q, q, q, mask=mask, impl="flash")
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
               (257, 16, 64, False), (512, 2, 128, True), (512, 2, 128, False),
               (129, 12, 64, True), (191, 12, 64, False),  # around a 64-row tile edge
               (257, 16, 64, True), (512, 4, 32, False),
               (257, 4, 80, True), (257, 4, 88, False),  # a zero-padded last k-step of 16
               (50, 12, 64, False), (77, 8, 64, True)]  # one tile, as the block kernels call


@pytest.mark.cuda
def test_cuda_same_bits_twice(cuda_device):
    """No float atomics, one owner and a fixed order for every sum: two launches agree bit
    for bit, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(197, 12, 64))
        first = (fa.fused_attention(q, k, v, heads=12),
                 *fa.fused_attention_bwd(q, k, v, do, heads=12))
        again = (fa.fused_attention(q, k, v, heads=12),
                 *fa.fused_attention_bwd(q, k, v, do, heads=12))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


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
