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

The block kernels' backward passes and the float32 forward walk the keys in tiles of 32 rows
(bfloat16) or 64 (float32) (``ops/csrc/attention_passes.cuh``; the block kernels' attention half
runs the same passes, the bfloat16 forward core included). ``tile_walk_forward`` and
``tile_walk_backward`` below are that schedule in plain torch: one online-softmax sweep (running
row max and sum of exp, the accumulator rescaled when the max moves), a second sweep for ds and
dq, then the key-tile pass that rebuilds p and ds from the three saved numbers per row, with
delta and ds from the rounded probabilities (the block backward's attention half). They are
held to the plain versions at ragged lengths: in float32 within 1e-5 x max|plain| (the order of
the sums only; there the fused backward agrees too), in bfloat16 within 2e-2 x max|plain| (the
online sweep rounds the unnormalised probability where the plain versions round the normalised
one). ``wgmma_walk_forward`` is the bfloat16 forward kernel's own schedule (``fused_fwd_kernel``:
passes of 128 query rows, 16-row warps, key tiles of 128, 112 or 96 keys as the kernel picks
them, 64 above D=64, sm_scale in the exponent), held to the JAX kernel and the plain forward at
the edges of its passes and tiles. ``wgmma_walk_backward`` is the fused backward kernels'
schedule in each dtype (bfloat16: the dQ kernel's two sweeps with the exact delta, the dK/dV
kernel's passes of 128 keys; float32: the flash dQ and dK/dV kernels' walk on the forward's lse
and delta from out), held to the JAX ``_bwd_kernel`` and the plain backward at the same edges.

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_fused_attention.py -m cuda
"""

import functools
import math

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


def _online_sweep(qh, kh, vh, scale, causal, dt):
    """The passes' first sweep, one key tile at a time: the running max m and sum of exp l and
    the running sum of round(exp(logit - m)) v (out, unnormalised), each rescaled by
    exp(m_old - m_new) when m moves. Returns (m, l, that sum)."""
    f32 = torch.float32
    m = torch.full(qh.shape[:-1] + (1,), fa.NEG_INF)
    l = torch.zeros_like(m)
    run = torch.zeros_like(qh)
    for c0 in range(0, qh.shape[-2], TILE):
        logits = _tile_logits(qh, kh, c0, scale, causal)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        alpha, e = torch.exp(m - m_new), torch.exp(logits - m_new)
        l = l * alpha + e.sum(-1, keepdim=True)
        run = run * alpha + e.to(dt).to(f32) @ vh[..., c0:c0 + TILE, :]
        m = m_new
    return m, l, run


def tile_walk_forward(q, k, v, *, heads, causal):
    """The forward's one sweep: an online softmax that rounds exp(logit - m) against the
    running max and divides the f32 accumulator by the sum of exp at the end."""
    f32, dt = torch.float32, q.dtype
    scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh = (fa._heads(t, heads).to(f32) for t in (q, k, v))
    _, l, acc = _online_sweep(qh, kh, vh, scale, causal, dt)
    return fa._pack((acc / l).to(dt))


def tile_walk_backward(q, k, v, do, *, heads, causal):
    """The dQ pass's two sweeps and the dK/dV pass, which form delta and ds from the rounded
    probabilities (the block backward's attention half). Returns (dq, dk, dv, attnpre)."""
    f32, dt = torch.float32, q.dtype
    scale = (q.shape[-1] // heads) ** -0.5
    qh, kh, vh, doh = (fa._heads(t, heads).to(f32) for t in (q, k, v, do))
    s = qh.shape[-2]
    m, l, run = _online_sweep(qh, kh, vh, scale, causal, dt)
    # delta = rowsum(do * attnpre) from attnpre's f32 accumulator
    delta, attnpre = (doh * run).sum(-1, keepdim=True) / l, run / l

    def probs(c0, rows=slice(None)):
        logits = _tile_logits(qh, kh, c0, scale, causal)[..., rows, :]
        pr = (torch.exp(logits - m[..., rows, :]) / l[..., rows, :]).to(dt).to(f32)
        return pr, pr

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
    got = tile_walk_backward(q, k, v, do, **kw)
    # in float32 the rounding is the identity, so the fused backward (exact probabilities) and
    # the block backward's half (rounded ones) agree
    _assert_within(got[:3], fa.fused_attention_bwd_reference(q, k, v, do, **kw), 1e-5,
                   ["dq", "dk", "dv"])
    _assert_within(got, _rounded_probs_reference(q, k, v, do, **kw), 1e-5,
                   ["dq", "dk", "dv", "attnpre"])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,h,d", RAGGED[1:])
def test_tile_walk_matches_plain_bf16_rounded_probs(s, h, d, causal):
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv(s, h, d, seed=13))
    kw = dict(heads=h, causal=causal)
    _assert_within([tile_walk_forward(q, k, v, **kw)],
                   [fa.fused_attention_reference(q, k, v, **kw)], 2e-2, ["out"])
    got = tile_walk_backward(q, k, v, do, **kw)
    _assert_within(got, _rounded_probs_reference(q, k, v, do, **kw), 2e-2,
                   ["dq", "dk", "dv", "attnpre"])


def test_tile_walk_with_32_row_tiles_bf16(monkeypatch):
    """The bfloat16 passes stream 32-row tiles: the same walk at that tile size, with the
    rounded probabilities of the block backward."""
    import sys

    monkeypatch.setattr(sys.modules[__name__], "TILE", 32)
    s, h, d = 197, 3, 64
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv(s, h, d, seed=15))
    kw = dict(heads=h, causal=True)
    _assert_within([tile_walk_forward(q, k, v, **kw)],
                   [fa.fused_attention_reference(q, k, v, **kw)], 2e-2, ["out"])
    got = tile_walk_backward(q, k, v, do, **kw)
    _assert_within(got, _rounded_probs_reference(q, k, v, do, **kw), 2e-2,
                   ["dq", "dk", "dv", "attnpre"])


def test_tile_walk_tells_exact_from_rounded_probs_bf16():
    """The fused backward's kernels and the block backward's passes differ where the plain
    versions do: the fused kernels' walk (exact probabilities) lands nearer the fused backward
    than the block backward's half, the passes' walk (rounded ones) nearer the block's."""
    s, h, d = 129, 2, 64
    q, k, v, do = (torch.from_numpy(a).bfloat16() for a in _qkv(s, h, d, seed=14))
    kw = dict(heads=h, causal=False)
    exact = wgmma_walk_backward(q, k, v, do, **kw)[0].float()
    rounded = tile_walk_backward(q, k, v, do, **kw)[0].float()
    fused = fa.fused_attention_bwd_reference(q, k, v, do, **kw)[0].float()
    block = _rounded_probs_reference(q, k, v, do, **kw)[0].float()
    assert not torch.equal(exact, rounded)
    assert (exact - fused).abs().mean() < (exact - block).abs().mean()
    assert (rounded - block).abs().mean() < (rounded - fused).abs().mean()


# ----------------------------------------------------- the bfloat16 forward's wgmma schedule
# fused_fwd_kernel (ops/csrc/fused_attention.cu) as plain torch: an (image, head) in passes of
# 128 query rows, each warp's 16 rows walking the key tiles below the pass's causal bound, every
# column of a tile formed (zeros past S, as TMA fills them), the mask tests only on a tile the
# kernel calls an edge tile for the warp, the online softmax on unscaled logits t with sm_scale
# in the exponent (p = 2^(t c - m c), c = sm_scale log2(e)), p rounded to bf16 for p v against
# the running max, the f32 sum divided by l once at the end. Written for any dtype: in float32
# rounding is the identity and the walk differs from the plain forward by the order of the sums.
PASS_ROWS, WARP_ROWS = 128, 16


def fused_keys(s, d, causal):
    """The kernel's key tile (fused_attention.cu:fused_keys): 64 above D=64; below, of 128, 112
    and 96 keys the one whose tiles pad the keys the passes see the least, the widest on a
    tie."""
    if d > 64:
        return 64
    best, best_cost = None, None
    for keys in (128, 112, 96):
        cost = sum(-(-(min(s, r0 + PASS_ROWS) if causal else s) // keys) * keys
                   for r0 in range(0, s, PASS_ROWS))
        if best_cost is None or cost < best_cost:
            best, best_cost = keys, cost
    return best


def _rows_tile(t, r0, n):
    """Rows r0..r0+n-1 of a [B, H, S, D] tensor, zero past its end (TMA's zero fill)."""
    out = torch.zeros(t.shape[:2] + (n,) + t.shape[3:], dtype=t.dtype)
    part = t[:, :, r0:r0 + n]
    out[:, :, :part.shape[2]] = part
    return out


def wgmma_walk_forward(q, k, v, *, heads, causal):
    f32, dt = torch.float32, q.dtype
    d = q.shape[-1] // heads
    scale = d ** -0.5
    c = scale * math.log2(math.e)  # the kernel folds sm_scale into its exponent
    qh, kh, vh = (fa._heads(t, heads).to(f32) for t in (q, k, v))
    s = qh.shape[-2]
    keys = fused_keys(s, d, causal)
    out = torch.zeros_like(qh)
    for r0 in range(0, s, PASS_ROWS):
        kmax = min(s, r0 + PASS_ROWS) if causal else s
        for warp_row in range(r0, min(r0 + PASS_ROWS, s), WARP_ROWS):  # rows past s: not stored
            rs = slice(warp_row, min(warp_row + WARP_ROWS, s))
            row = torch.arange(rs.start, rs.stop)[:, None]
            m = torch.full(qh.shape[:2] + (row.shape[0], 1), fa.NEG_INF)
            l = torch.zeros_like(m)
            acc = torch.zeros(qh.shape[:2] + (row.shape[0], d))
            for c0 in range(0, kmax, keys):  # every tile below the pass's bound
                kt, vt = _rows_tile(kh, c0, keys), _rows_tile(vh, c0, keys)
                t = qh[:, :, rs] @ kt.transpose(-1, -2)  # unscaled
                if c0 + keys > kmax or (causal and c0 + keys - 1 > warp_row):  # edge_tile
                    key = c0 + torch.arange(keys)[None, :]
                    t = torch.where((key < kmax) & ((key <= row) | (not causal)), t, fa.NEG_INF)
                m_new = torch.maximum(m, t.amax(dim=-1, keepdim=True))
                p = torch.exp2(t * c - m_new * c)
                alpha = torch.exp2(m * c - m_new * c)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + p.to(dt).to(f32) @ vt
                m = m_new
            out[:, :, rs] = acc / torch.where(l == 0, torch.ones_like(l), l)
    return fa._pack(out.to(dt))


def test_fused_keys_pick_the_tile_that_pads_least():
    """S=197 takes two tiles of 112 keys a pass (224 keys, not 256), S=257 three of 96 (288,
    not 384), S=128 and S=512 whole tiles of 128; the causal S=197 keeps 128 (its first pass
    sees 128 keys); D=128 takes 64 keys, for registers."""
    assert fused_keys(197, 64, False) == 112 and fused_keys(197, 64, True) == 128
    assert fused_keys(257, 64, False) == 96 and fused_keys(257, 32, True) == 128
    assert fused_keys(128, 64, False) == fused_keys(512, 32, False) == 128
    assert fused_keys(129, 64, False) == 96 and fused_keys(193, 64, False) == 112
    assert fused_keys(197, 128, False) == 64


# one short of, at and one past the 128-row passes and the key tiles of every width the kernel
# picks (128: S=128, 256, 511, 512; 112: 193, 255; 96: 129, 191, 192, 257)
WGMMA_EDGE_LENGTHS = [128, 129, 191, 192, 193, 255, 256, 257, 511, 512]


@functools.lru_cache(maxsize=None)
def _jax_forward(s, h, d, causal, dtype_name, seed=0):
    """The JAX package's fused_attention forward (its _fwd_kernel in interpret mode) at B=1."""
    import jax.numpy as jnp

    from multimodal_tpu.ops.fused_attention import fused_attention

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.standard_normal((1, s, h * d), dtype=np.float32), dt)
               for _ in range(3))
    return np.asarray(fused_attention(q, k, v, heads=h, causal=causal).astype(jnp.float32))


def _edge_inputs(s, h, d, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, s, h * d), dtype=np.float32)).to(dtype)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", WGMMA_EDGE_LENGTHS)
def test_wgmma_walk_forward_matches_jax_and_plain_at_the_tile_edges_bf16(s, d, causal):
    """The bfloat16 forward kernel's schedule at the edges of its passes and key tiles, every
    head dim class (one 64-column box with zero columns past D, one, two): against the JAX
    _fwd_kernel (interpret mode) and the plain forward within 2e-2 x max(1, max|reference|)
    (the online softmax rounds p against the running max where both round the normalised p)."""
    h = 2
    q, k, v = _edge_inputs(s, h, d, torch.bfloat16)
    got = wgmma_walk_forward(q, k, v, heads=h, causal=causal).float().numpy()
    for ref in (_jax_forward(s, h, d, causal, "bfloat16"),
                fa.fused_attention_reference(q, k, v, heads=h, causal=causal).float().numpy()):
        np.testing.assert_allclose(got, ref, atol=2e-2 * max(1.0, np.abs(ref).max()), rtol=0)


@pytest.mark.parametrize("s,d,causal", [(129, 64, False), (197, 64, False), (193, 32, True),
                                        (257, 64, False), (512, 128, True)])
def test_wgmma_walk_forward_is_the_plain_forward_in_float32(s, d, causal):
    """On float32 inputs the schedule differs from the JAX kernel and the plain forward by the
    order of the sums only: within 1e-5 x max|reference|."""
    h = 2
    q, k, v = _edge_inputs(s, h, d, torch.float32, seed=1)
    got = wgmma_walk_forward(q, k, v, heads=h, causal=causal)
    plain = fa.fused_attention_reference(q, k, v, heads=h, causal=causal)
    _assert_within([got], [plain], 1e-5, ["out"])
    want = _jax_forward(s, h, d, causal, "float32", seed=1)
    assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


# --------------------------------------------------------------- the backward kernels' schedules
# fused_dq_kernel / fused_dkv_kernel of ops/csrc/fused_attention.cu (bfloat16) as plain torch.
# The dQ kernel: passes of 128 query rows over the key tiles below the pass's causal bound in
# tiles of 64 keys (32 above D=64; every column of a tile formed, zeros past S as TMA gives
# them). A first sweep keeps the running max m, the sum of exp l and the running f32 sum of
# exp(s - m) dp, each rescaled when m moves, and the row's lse (log2 units) and delta come from
# them; the second sweep forms p = 2^(t c - lse), ds = round(p (dp - delta)) and dq.
# The dK/dV kernel: passes of 128 keys, the query rows in tiles of 32 (16 above D=64) from the
# pass's first key under the causal mask, p and ds rebuilt from each row's lse and delta,
# dv += round(p)^T do, dk += round(ds)^T q. The logits stay unscaled with sm_scale in the
# exponent (c = sm_scale log2(e)). Each sum is taken in f32 and rounded once at the end. The
# masks: keys at or past S, rows at or past S and, under the causal mask, keys past a row take
# the finite -1e30 before the max (first sweep) or p = 0 (second sweep, dK/dV). A row's 16-row
# warp decides only whether a tile runs the mask tests, which changes no number, so the walk
# forms a pass's rows together.
# The float32 backward is the flash dQ and dK/dV kernels on the packed tensors read as
# [B, S, H, D], on the float32 forward core's lse and delta = rowsum(do * out): its walk is
# tests/test_torch_flash_attention.py's tile_walk_dq and tile_walk_dkv.
def _masked(t, rows, keys, s, causal):
    """Where (row, key) of a [.., rows, keys] tile is live: key < s, row < s, key <= row."""
    row, key = rows[:, None], keys[None, :]
    return (key < s) & (row < s) & ((key <= row) | (not causal))


def _forward_core_lse(qh, kh, scale, causal):
    """The float32 forward core's log-sum-exp of each row, [B, H, S]: an online sweep over
    64-key tiles on the scaled logits (attention_passes.cuh, attend_f32), m + log(l)."""
    m = torch.full(qh.shape[:-1] + (1,), fa.NEG_INF)
    l = torch.zeros_like(m)
    for c0 in range(0, qh.shape[-2], 64):
        logits = _tile_logits(qh, kh, c0, scale, causal)
        m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.exp(logits - m_new).sum(-1, keepdim=True)
        m = m_new
    return (m + torch.log(l))[..., 0]


def _flash_walk_backward(q, k, v, do, out, *, heads, causal):
    """The float32 backward's schedule: the flash kernels' walk on [B, S, H, D] views of the
    packed tensors, with the forward core's lse and delta = rowsum(do * out)."""
    from test_torch_flash_attention import tile_walk_dkv, tile_walk_dq

    from multimodal_tpu_torch.ops.flash_attention import flash_delta

    b, s, w = q.shape
    d = w // heads
    q4, k4, v4, do4, out4 = (t.view(b, s, heads, d) for t in (q, k, v, do, out))
    lse = _forward_core_lse(fa._heads(q, heads), fa._heads(k, heads), d ** -0.5, causal)
    delta = flash_delta(out4, do4)
    kw = dict(causal=causal, scale=d ** -0.5)
    dq = tile_walk_dq(q4, k4, v4, do4, lse, delta, **kw)
    dk, dv = tile_walk_dkv(q4, k4, v4, do4, lse, delta, **kw)
    return tuple(t.reshape(b, s, w) for t in (dq, dk, dv))


def wgmma_walk_backward(q, k, v, do, *, heads, causal, out=None):
    """(dq, dk, dv) by the backward kernels' schedule: the bfloat16 kernels' own on a bfloat16
    q; on a float32 q the flash kernels' (``_flash_walk_backward``), which takes delta from
    ``out``, the forward's output."""
    if q.dtype == torch.float32:
        return _flash_walk_backward(q, k, v, do, out, heads=heads, causal=causal)
    f32, dt = torch.float32, q.dtype
    d = q.shape[-1] // heads
    scale = d ** -0.5
    c = scale * math.log2(math.e)
    qh, kh, vh, doh = (fa._heads(t, heads).to(f32) for t in (q, k, v, do))
    s = qh.shape[-2]
    pass_rows, keys, dkv_rows = PASS_ROWS, (64 if d <= 64 else 32), (32 if d <= 64 else 16)
    logits = lambda a, b: a @ b.transpose(-1, -2)  # noqa: E731
    lse = torch.zeros(qh.shape[:-1] + (1,))  # log2 units
    delta = torch.zeros_like(lse)
    dq = torch.zeros_like(qh)
    for r0 in range(0, s, pass_rows):
        rows = torch.arange(r0, r0 + pass_rows)
        kmax = min(s, r0 + pass_rows) if causal else s
        qt, dot = _rows_tile(qh, r0, pass_rows), _rows_tile(doh, r0, pass_rows)
        m = torch.full(qt.shape[:-1] + (1,), fa.NEG_INF)
        l, run = torch.zeros_like(m), torch.zeros_like(m)
        for c0 in range(0, kmax, keys):  # the first sweep
            kt, vt = _rows_tile(kh, c0, keys), _rows_tile(vh, c0, keys)
            key = torch.arange(c0, c0 + keys)[None, :]
            t = torch.where((key < kmax) & ((key <= rows[:, None]) | (not causal)),
                            logits(qt, kt), fa.NEG_INF)
            m_new = torch.maximum(m, t.amax(dim=-1, keepdim=True))
            p, alpha = torch.exp2(t * c - m_new * c), torch.exp2(m * c - m_new * c)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            run = run * alpha + (p * (dot @ vt.transpose(-1, -2))).sum(dim=-1, keepdim=True)
            m = m_new
        off, dl = m * c + torch.log2(l), run / l
        acc = torch.zeros_like(qt)
        for c0 in range(0, kmax, keys):  # the second sweep
            kt, vt = _rows_tile(kh, c0, keys), _rows_tile(vh, c0, keys)
            key = torch.arange(c0, c0 + keys)
            p = torch.where(_masked(None, rows, key, s, causal),
                            torch.exp2(logits(qt, kt) * c - off), 0.)
            ds = (p * (dot @ vt.transpose(-1, -2) - dl)).to(dt).to(f32)
            acc = acc + ds @ kt
        n = min(pass_rows, s - r0)
        dq[:, :, r0:r0 + n], delta[:, :, r0:r0 + n] = acc[:, :, :n], dl[:, :, :n]
        lse[:, :, r0:r0 + n] = off[:, :, :n]
    dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
    for j0 in range(0, s, 128):  # the dK/dV kernel's passes of 128 keys
        key = torch.arange(j0, j0 + 128)
        kt, vt = _rows_tile(kh, j0, 128), _rows_tile(vh, j0, 128)
        acc_k, acc_v = torch.zeros_like(kt), torch.zeros_like(vt)
        for q0 in range(j0 if causal else 0, s, dkv_rows):
            rows = torch.arange(q0, q0 + dkv_rows)
            qt, dot = _rows_tile(qh, q0, dkv_rows), _rows_tile(doh, q0, dkv_rows)
            off = _rows_tile(lse, q0, dkv_rows).transpose(-1, -2)  # a row's number per column
            dl = _rows_tile(delta, q0, dkv_rows).transpose(-1, -2)
            live = _masked(None, rows, key, s, causal).transpose(-1, -2)  # [keys, rows]
            pt = torch.where(live, torch.exp2(logits(kt, qt) * c - off), 0.)
            dst = (pt * (vt @ dot.transpose(-1, -2) - dl)).to(dt).to(f32)
            acc_v = acc_v + pt.to(dt).to(f32) @ dot
            acc_k = acc_k + dst @ qt
        n = min(128, s - j0)
        dk[:, :, j0:j0 + n], dv[:, :, j0:j0 + n] = acc_k[:, :, :n], acc_v[:, :, :n]
    return tuple(fa._pack(t.to(dt)) for t in (dq * scale, dk * scale, dv))


@functools.lru_cache(maxsize=None)
def _jax_backward(s, h, d, causal, dtype_name, seed=0):
    """The JAX package's _bwd_kernel (interpret mode) at B=1 on _bwd_inputs: (dq, dk, dv)."""
    import jax.numpy as jnp

    from multimodal_tpu.ops.fused_attention import _bwd_kernel, _call

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    args = (jnp.asarray(a, dt) for a in _bwd_arrays(s, h, d, seed))
    got = _call(_bwd_kernel, 3, *args, heads=h, head_dim=d, true_s=s, causal=causal,
                sm_scale=d ** -0.5)
    return [np.asarray(t.astype(jnp.float32)) for t in got]


def _bwd_arrays(s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, s, h * d), dtype=np.float32) for _ in range(4)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("s", WGMMA_EDGE_LENGTHS)
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_wgmma_walk_backward_matches_jax_and_plain_at_the_tile_edges(dtype_name, s, d, causal):
    """The backward kernels' schedules at the edges of their passes and tiles, every head dim
    class, against the JAX _bwd_kernel (interpret mode) and the plain backward: bfloat16 within
    2e-2 x max(1, max|reference|) (p and ds round at the same points; the sums run in another
    order), float32 within 1e-4 x max(1, max|reference|) (the order of the sums, and delta from
    out, only)."""
    h, dtype = 2, getattr(torch, dtype_name)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in _bwd_arrays(s, h, d, seed=2))
    out = fa.fused_attention_reference(q, k, v, heads=h, causal=causal)
    got = wgmma_walk_backward(q, k, v, do, heads=h, causal=causal, out=out)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    plain = fa.fused_attention_bwd_reference(q, k, v, do, heads=h, causal=causal)
    for refs in (_jax_backward(s, h, d, causal, dtype_name, seed=2),
                 [t.float().numpy() for t in plain]):
        for name, g, r in zip(("dq", "dk", "dv"), got, refs):
            np.testing.assert_allclose(g.float().numpy(), r, rtol=0, err_msg=name,
                                       atol=tol * max(1.0, np.abs(r).max()))


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
               (50, 12, 64, False), (77, 8, 64, True),  # one tile, as the block kernels call
               (129, 3, 64, False), (193, 3, 64, False), (255, 3, 32, True),  # 96, 112, 128 keys
               (511, 2, 128, False)]


@pytest.mark.cuda
def test_cuda_same_bits_twice(cuda_device):
    """No float atomics, one owner and a fixed order for every sum: two launches agree bit
    for bit, in both dtypes."""
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(197, 12, 64))
        runs = []
        for _ in range(2):  # the backward on the forward's pair, as the operator hands it over
            out, lse = fa.fused_attention_fwd(q, k, v, heads=12)
            runs.append((out, *fa.fused_attention_bwd(q, k, v, do, heads=12, out=out, lse=lse)))
        assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("s,h,d,causal", CUDA_SHAPES)
def test_cuda_kernels_match_plain(cuda_device, s, h, d, causal, dtype, tol):
    q, k, v, do = (torch.from_numpy(a).to(cuda_device, dtype) for a in _qkv(s, h, d, seed=5))
    kw = dict(heads=h, causal=causal)
    fa.launches.reset_launch_counts()
    out, lse = fa.fused_attention_fwd(q, k, v, **kw)
    got = (out, *fa.fused_attention_bwd(q, k, v, do, out=out, lse=lse, **kw))
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
