"""The bfloat16 block-attention kernels' schedules walked in plain torch on the CPU: the projection
GEMMs of ``ops/csrc/block_attention_{fwd,bwd}.cu`` on ``wgmma_gemm.cuh`` (the NN form over three
weight sets, the residual store's two roundings, the NT form over one and over three K segments,
bfloat16 or float32 out) and the backward's attention half on ``fused_attention.cu``'s dQ and
dK/dV kernels in their block form (rounded probabilities, attnpre, two items a pass at S <= 64).
Each walk is held to the JAX package's Pallas kernels (``_fwd_kernel``, ``_bwd_kernel`` and
``_bwd_kernel_large`` in interpret mode) and to the port's plain versions.

The GEMM walk sums tile by tile (128 x 128 of C) and K-step by K-step (64, as four products of
16), with TMA's zero fill past M and the LN load on the landed A box; the NT form walks its
segments' K-steps in turn into one f32 sum. The attention walk keeps the kernels' schedule: the
dQ kernel's first sweep is the forward's online sweep (p rounded against the running max, the
accumulator rescaled, sm_scale in the exponent), which yields attnpre = round(acc / l) and delta
= rowsum(do acc) / l; its second sweep and the dK/dV kernel's passes of 128 keys round p =
2^(t c - lse) before ds = round(p (dp - delta)) and dv; the dK/dV kernel reads its query rows in
tiles of 32 (16 above D = 64) from the first tile under the causal mask.

Tolerances: bfloat16 within 2e-2 x max(1, max|reference|) (both sides round at the same points;
the sums run in another order, and the online sweep rounds the unnormalised p where the plain
versions round the normalised one). The key-bias gradient, zero in exact arithmetic, is held on
the scale of the query-bias gradient. The residual store's one-rounding form is told from its
two-rounding form by the share of elements that differ from the plain forward's y.
"""

import functools
import math

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import block_attention as ba
from test_torch_fused_attention import tile_walk_forward, wgmma_walk_forward

torch.set_num_threads(1)

TILE, KSTEP = 128, 64  # wgmma_gemm.cuh: a 128 x 128 tile of C, K-steps of 64
NAMES = ["dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo"]
LN_NAMES = ["dx", "dgamma", "dbeta"] + NAMES[1:]
BF16 = torch.bfloat16


def _box(mat: torch.Tensor, r0: int, c0: int, rows: int, cols: int) -> torch.Tensor:
    """rows x cols of ``mat`` from (r0, c0), zeros past either extent, as TMA lands a box."""
    box = torch.zeros(rows, cols, dtype=mat.dtype)
    part = mat[r0:r0 + rows, c0:c0 + cols]
    box[:part.shape[0], :part.shape[1]] = part
    return box


def gemm_walk(a, b, form: str, transform=None):
    """The f32 sums of the block kernels' ``wgmma_gemm_kernel`` before its store. NN: ``a`` is A
    [M, K], ``b`` a list of weight sets B_z [K, N]; returns the list of C_z. NT: ``a`` and ``b``
    are lists of A_z [M, K] and W_z [N, K], whose K-steps run in turn into one sum; returns
    [M, N]. ``transform(box, m0, k0)`` is the LN load on a landed A box of A[m0:, k0:]."""
    segments = list(zip(a, b)) if form == "NT" else [(a, None)]
    m = segments[0][0].shape[0]
    sets = b if form == "NN" else [None]
    outs = []
    for w_set in sets:
        n = w_set.shape[1] if form == "NN" else b[0].shape[0]
        out = torch.zeros(-(-m // TILE) * TILE, n)
        for m0 in range(0, m, TILE):
            for n0 in range(0, n, TILE):
                acc = torch.zeros(TILE, TILE)
                for a_z, w_z in segments:
                    w_z = w_set if form == "NN" else w_z
                    for k0 in range(0, a_z.shape[1], KSTEP):
                        at = _box(a_z, m0, k0, TILE, KSTEP)
                        if transform is not None:
                            at = transform(at, m0, k0)
                        bt = (_box(w_z, k0, n0, KSTEP, TILE) if form == "NN"
                              else _box(w_z, n0, k0, TILE, KSTEP).T)
                        for kk in range(0, KSTEP, 16):
                            acc = acc + at[:, kk:kk + 16].float() @ bt[kk:kk + 16].float()
                out[m0:m0 + TILE, n0:n0 + TILE] = acc
        outs.append(out[:m, :n])
    return outs if form == "NN" else outs[0]


def store(acc, bias, dt, residual=None, roundings: int = 2):
    """The store of an f32 sum: the bias added in f32 and one rounding to dt; with a residual,
    ``roundings=2`` rounds that, adds the residual and rounds again (``kStoreResidual``, the
    TPU kernel's order), ``roundings=1`` adds both in f32 before one rounding."""
    v = acc + bias.float() if bias is not None else acc
    if residual is None:
        return v.to(dt)
    if roundings == 2:
        v = v.to(dt).float()
    return (v + residual.float()).to(dt)


def _ln_load(x2, gamma, beta):
    """The LN load transform of the q/k/v NN form on a landed box of x (ln_bf16x8): the row's
    f32 statistics rounded to bf16, then ((x - mean) inv) gamma + beta rounding after every
    operation; rows past M have zero statistics (their results are never stored)."""
    mean, inv = ba._ln_stats(x2, ba.LN_EPS)
    mt, it = mean.to(x2.dtype), inv.to(x2.dtype)

    def load(box, m0, k0):
        rows = min(TILE, x2.shape[0] - m0)
        st_m = torch.zeros(TILE, 1, dtype=x2.dtype)
        st_i = torch.zeros(TILE, 1, dtype=x2.dtype)
        st_m[:rows], st_i[:rows] = mt[m0:m0 + rows], it[m0:m0 + rows]
        return ((box - st_m) * st_i) * gamma[k0:k0 + KSTEP] + beta[k0:k0 + KSTEP]
    return load


def block_walk_fwd(x, ws, *, heads, causal, ln=None, residual=False, roundings=2):
    """y [B, S, W] of the bfloat16 forward as its launches form it: the NN form over three
    weight sets (q, k, v; with ``ln`` = (gamma, beta) the LN load on x), the attention core
    (``fused_fwd_kernel``'s walk at S >= 128 and D in {32, 64, 128}, else the mma.sync core's
    online sweep), the NN form for the out projection with the residual store (``residual``)
    or the round store."""
    b, s, w = x.shape
    dt, m, d = x.dtype, b * s, w // heads
    wq, bq, wk, bk, wv, bv, wo, bo = ws
    x2 = x.reshape(m, w)
    load = _ln_load(x2, *ln) if ln is not None else None
    q, k, v = (store(acc, bias, dt).view(b, s, w)
               for acc, bias in zip(gemm_walk(x2, [wq, wk, wv], "NN", load), (bq, bk, bv)))
    core = wgmma_walk_forward if s >= 128 and d in (32, 64, 128) else tile_walk_forward
    attn = core(q, k, v, heads=heads, causal=causal).reshape(m, w)
    (acc,) = gemm_walk(attn, [wo], "NN")
    return store(acc, bo, dt, x2 if residual else None, roundings).view(b, s, w)


# -------------------------------------------------------------------- the attention half
def pass_units(items: int, packed: bool):
    """The dQ and dK/dV kernels' units, as ``pass_item`` forms them: (unit, warpgroup, item,
    live) for both warpgroups of every pass unit; packed (S <= 64), warpgroup w of unit u takes
    item 2u + w, the last item again past the end (not stored); else both take item u."""
    units = (items + 1) // 2 if packed else items
    out = []
    for u in range(units):
        for wg in range(2):
            want = 2 * u + wg if packed else u
            out.append((u, wg, min(want, items - 1), want < items))
    return out


def attention_walk_bwd(q, k, v, do, *, heads, causal):
    """(attnpre, dq, dk, dv) [B, S, W] of the block form's dQ and dK/dV kernels, item by item as
    the units assign them (``pass_units``): passes of 128 query rows (packed: one item's 64
    rows a warpgroup), key tiles of 64 (32 above D = 64), then passes of 128 keys over query
    tiles of 32 (16) rows on the rows' lse (log2 units) and delta."""
    f32, dt = torch.float32, q.dtype
    b, s, w = q.shape
    d = w // heads
    scale = d ** -0.5
    c = scale * math.log2(math.e)
    keys, rows_t = (64, 32) if d <= 64 else (32, 16)
    packed = s <= 64
    heads_of = lambda t: t.view(b, s, heads, d).permute(0, 2, 1, 3).reshape(  # noqa: E731
        b * heads, s, d).to(f32)
    qh, kh, vh, doh = (heads_of(t) for t in (q, k, v, do))
    outs = [torch.zeros(b * heads, s, d) for _ in range(4)]  # attnpre, dq, dk, dv
    lse, delta = torch.zeros(b * heads, s, 1), torch.zeros(b * heads, s, 1)

    def rows(t, r0, n):
        out = torch.zeros(n, t.shape[-1])
        part = t[r0:r0 + n]
        out[:part.shape[0]] = part
        return out

    def mask(row, key):  # [rows, 1] and [1, keys]: the key live and, causal, not past the row
        return (key < s) & (row < s) & ((key <= row) | (not causal))

    for unit, wg, item, live in pass_units(b * heads, packed):
        if not live:  # the repeated item's results are not stored
            continue
        for p in range(1 if packed else -(-s // 128)):
            r0 = 0 if packed else p * 128
            if not packed and wg == 1 and r0 + 64 >= s:
                continue  # the warpgroup's rows lie past S: nothing stored
            r_lo = r0 if packed else r0 + 64 * wg
            kmax = min(s, r0 + min(128, s - r0)) if causal else s
            qt, dot = rows(qh[item], r_lo, 64), rows(doh[item], r_lo, 64)
            row = torch.arange(r_lo, r_lo + 64)[:, None]
            m = torch.full((64, 1), ba.NEG_INF)
            l, acc = torch.zeros(64, 1), torch.zeros(64, d)
            for c0 in range(0, kmax, keys):  # the first sweep: the forward's online sweep
                kt, vt = rows(kh[item], c0, keys), rows(vh[item], c0, keys)
                key = torch.arange(c0, c0 + keys)[None, :]
                t = torch.where(mask(row, key) & (key < kmax), qt @ kt.T, ba.NEG_INF)
                m_new = torch.maximum(m, t.amax(dim=-1, keepdim=True))
                pr, alpha = torch.exp2(t * c - m_new * c), torch.exp2(m * c - m_new * c)
                l = l * alpha + pr.sum(dim=-1, keepdim=True)
                acc = acc * alpha + pr.to(dt).to(f32) @ vt
                m = m_new
            off, inv = m * c + torch.log2(l), 1 / l
            dl = (dot * acc).sum(dim=-1, keepdim=True) * inv
            acc_q = torch.zeros(64, d)
            for c0 in range(0, kmax, keys):  # the second sweep: rounded p, ds, dq
                kt, vt = rows(kh[item], c0, keys), rows(vh[item], c0, keys)
                key = torch.arange(c0, c0 + keys)[None, :]
                pr = torch.where(mask(row, key), torch.exp2((qt @ kt.T) * c - off), 0.)
                pr = pr.to(dt).to(f32)
                ds = (pr * (dot @ vt.T - dl)).to(dt).to(f32)
                acc_q = acc_q + ds @ kt
            n = min(64, s - r_lo)
            outs[0][item, r_lo:r_lo + n] = (acc * inv)[:n]
            outs[1][item, r_lo:r_lo + n] = (acc_q * scale)[:n]
            lse[item, r_lo:r_lo + n], delta[item, r_lo:r_lo + n] = off[:n], dl[:n]
    for unit, wg, item, live in pass_units(b * heads, packed):
        if not live:
            continue
        for p in range(1 if packed else -(-s // 128)):
            j_lo = 0 if packed else p * 128 + 64 * wg
            if j_lo >= s:
                continue
            kt, vt = rows(kh[item], j_lo, 64), rows(vh[item], j_lo, 64)
            key = torch.arange(j_lo, j_lo + 64)[:, None]  # the keys as rows
            acc_k, acc_v = torch.zeros(64, d), torch.zeros(64, d)
            first = 0 if packed or not causal else p * 128 // rows_t
            for q0 in range(first * rows_t, s, rows_t):
                qt, dot = rows(qh[item], q0, rows_t), rows(doh[item], q0, rows_t)
                off, dl = rows(lse[item], q0, rows_t).T, rows(delta[item], q0, rows_t).T
                row = torch.arange(q0, q0 + rows_t)[None, :]
                pt = torch.where(mask(row, key), torch.exp2((kt @ qt.T) * c - off), 0.)
                pt = pt.to(dt).to(f32)
                dst = (pt * (vt @ dot.T - dl)).to(dt).to(f32)
                acc_v = acc_v + pt @ dot
                acc_k = acc_k + dst @ qt
            n = min(64, s - j_lo)
            outs[2][item, j_lo:j_lo + n] = (acc_k * scale)[:n]
            outs[3][item, j_lo:j_lo + n] = acc_v[:n]
    merge = lambda t: t.view(b, heads, s, d).permute(0, 2, 1, 3).reshape(b, s, w)  # noqa: E731
    return tuple(merge(t).to(dt) for t in outs)


def block_walk_bwd(x, dy, ws, *, heads, causal, ln=None, residual=False):
    """The bfloat16 backward's per-token outputs as its launches form them: (dx, dq, dk, dv,
    attnpre), and with ``ln`` = (gamma, beta) also ln_out and (dgamma, dbeta) summed. q, k, v
    by the NN form on x or ln_out (written by ln_bf16x8, the LN load's function); do by the NT
    form over one segment; the attention half (``attention_walk_bwd`` at D in {32, 64, 128},
    else the mma.sync passes, here their plain version); g by the NT form over the three
    segments in f32, then dx = round(g) or the LN vjp on g."""
    b, s, w = x.shape
    dt, m = x.dtype, b * s
    wq, bq, wk, bk, wv, bv, wo, bo = ws
    x2, dy2 = x.reshape(m, w), dy.reshape(m, w)
    xin = ba.ln_rows(x2, *ln, ba.LN_EPS) if ln is not None else x2
    q, k, v = (store(acc, bias, dt).view(b, s, w)
               for acc, bias in zip(gemm_walk(xin, [wq, wk, wv], "NN"), (bq, bk, bv)))
    do = store(gemm_walk([dy2], [wo], "NT"), None, dt).view(b, s, w)
    half = (attention_walk_bwd if w // heads in (32, 64, 128)
            else ba.attention_half_reference)
    attnpre, dq, dk, dv = half(q, k, v, do, heads=heads, causal=causal)
    g = gemm_walk([t.reshape(m, w) for t in (dq, dk, dv)], [wq, wk, wv], "NT")
    if ln is None:
        return g.to(dt).view(b, s, w), dq, dk, dv, attnpre
    gamma, _ = ln
    mean, inv = ba._ln_stats(x2, ba.LN_EPS)
    xhat32 = (x2.float() - mean) * inv
    dxhat = g * gamma.float()
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat32 * (dxhat * xhat32).mean(dim=-1, keepdim=True))
    if residual:
        dx = dx + dy2.float()
    return (dx.to(dt).view(b, s, w), dq, dk, dv, attnpre, xin.view(b, s, w),
            (g * xhat32).sum(dim=0), g.sum(dim=0))


# -------------------------------------------------------------------- inputs and JAX
def _inputs(b, s, w, seed=0):
    """x, the eight weights and biases, a cotangent dy, gamma and beta, as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    ws = []
    for _ in range(4):
        ws.append(rng.standard_normal((w, w), dtype=np.float32) * w ** -0.5)
        ws.append(rng.standard_normal((w,), dtype=np.float32) * 0.02)
    dy = rng.standard_normal((b, s, w), dtype=np.float32)
    gamma = 1 + 0.1 * rng.standard_normal((w,), dtype=np.float32)
    beta = 0.1 * rng.standard_normal((w,), dtype=np.float32)
    return x, ws, dy, gamma, beta


def _torch_inputs(b, s, w, seed=0):
    x, ws, dy, gamma, beta = _inputs(b, s, w, seed)
    to = lambda a: torch.from_numpy(a).to(BF16)  # noqa: E731
    return to(x), [to(a) for a in ws], to(dy), to(gamma), to(beta)


@functools.lru_cache(maxsize=None)
def _jax_fwd(b, s, w, heads, causal, ln, residual, seed=0):
    """y of the JAX operator (its _fwd_kernel in interpret mode; the LN-fold form with
    ``ln``), bfloat16, as float32 numpy."""
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_attention import block_attention

    x, ws, _, gamma, beta = _inputs(b, s, w, seed)
    to = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    kw = dict(ln_scale=to(gamma), ln_bias=to(beta), residual=residual) if ln else {}
    y = block_attention(to(x), *(to(a) for a in ws), heads=heads, causal=causal, **kw)
    return np.asarray(y.astype(jnp.float32))


@functools.lru_cache(maxsize=None)
def _jax_tokens(b, s, w, heads, causal, seed=0):
    """(dx, dq, dk, dv, attnpre) of the JAX backward kernel (``_bwd_kernel`` at S <= 128,
    ``_bwd_kernel_large`` above: the per-head streaming kernel, the only one for an unpadded S
    past 128) in interpret mode, bfloat16, as float32 numpy."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from multimodal_tpu.ops import block_attention as jba
    from multimodal_tpu.ops.pallas_util import sds

    x, ws, dy, _, _ = _inputs(b, s, w, seed)
    to = lambda a: jnp.asarray(a, jnp.bfloat16)  # noqa: E731
    x, dy, ws = to(x), to(dy), [to(a) for a in ws]
    g = jba._images_per_program(b, s, fwd=False)
    kern = functools.partial(jba._bwd_kernel if s <= 128 else jba._bwd_kernel_large, g_imgs=g,
                             heads=heads, head_dim=w // heads, scale=(w // heads) ** -0.5,
                             causal=causal, kv_len=None)
    xspec = pl.BlockSpec((g, s, w), lambda i: (i, 0, 0))
    outs = pl.pallas_call(kern, grid=(b // g,), in_specs=[xspec, xspec] + jba._weight_specs(w),
                          out_specs=[xspec] * 5, out_shape=[sds((b, s, w), x.dtype, x)] * 5,
                          interpret=True)(x, dy, *ws)
    return [np.asarray(t.astype(jnp.float32)) for t in outs]


def _close(got, want, what, scale=None):
    """bfloat16: within 2e-2 x max(1, max|want|), or 2e-2 x max(1, ``scale``)."""
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = want.float().numpy() if isinstance(want, torch.Tensor) else want
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, err_msg=what, atol=2e-2 * max(1.0, scale))


# (batch, seq, width, heads, causal): ragged M = B*S across the 128-row tiles, several N tiles
# and K-steps; S >= 128 takes the fused forward's core and the unpacked passes; D = 32, 64, 128
GEMM_CASES = [(3, 50, 256, 4, False), (2, 77, 256, 8, True), (2, 129, 256, 2, False),
              (1, 197, 256, 4, True)]


@pytest.mark.parametrize("b,s,w,heads,causal", GEMM_CASES)
def test_forward_walk_matches_jax_fwd_kernel_and_plain(b, s, w, heads, causal):
    """The forward's launches in plain torch (the three-set NN, the core, the out projection's
    round store) against the JAX _fwd_kernel and the plain forward."""
    x, ws, _, _, _ = _torch_inputs(b, s, w)
    got = block_walk_fwd(x, ws, heads=heads, causal=causal)
    _close(got, _jax_fwd(b, s, w, heads, causal, False, False), "y vs JAX")
    _close(got, ba.block_attention_reference(x, *ws, heads=heads, causal=causal), "y vs plain")


@pytest.mark.parametrize("b,s,w,heads,causal", [(2, 145, 128, 2, False), (2, 145, 128, 2, True),
                                                (3, 50, 256, 4, False)])
def test_ln_forward_walk_with_the_residual_store_matches_jax_and_plain(b, s, w, heads, causal,
                                                                       monkeypatch):
    """The LN form: the LN load on x's landed boxes, and the out projection's residual store
    (bias, a rounding, + x, a second rounding), against the JAX LN-fold _fwd_kernel with its
    in-kernel residual and the plain LN forward."""
    if s <= 128:
        monkeypatch.setenv("MMTPU_BLOCK_ATTN_LN", "1")
    x, ws, _, gamma, beta = _torch_inputs(b, s, w)
    got = block_walk_fwd(x, ws, heads=heads, causal=causal, ln=(gamma, beta), residual=True)
    _close(got, _jax_fwd(b, s, w, heads, causal, True, True), "y vs JAX")
    _close(got, ba.block_attention_ln_reference(x, gamma, beta, *ws, heads=heads, causal=causal,
                                                residual=True), "y vs plain")


def test_residual_store_rounds_twice_as_the_plain_forward():
    """bfloat16, the LN form with the residual at S = 145, on the plain forward's attention
    output: the out projection's walk with the residual store (y rounded, + x, rounded again,
    the TPU kernel's order) disagrees with the plain forward's y on under 2% of the elements
    (sums taken in another order flip a few roundings); the one-rounding store of the MLP's
    c_proj (bias and residual added in f32) on the same sums disagrees on over a tenth (14% at
    this shape), which the 2e-2 limit alone would not catch. The plain forward is held to the
    JAX kernel above."""
    b, s, w, heads = 2, 145, 128, 2
    x, ws, _, gamma, beta = _torch_inputs(b, s, w)
    x2 = x.reshape(-1, w)
    xn = ba.ln_rows(x2, gamma, beta, ba.LN_EPS).view(b, s, w)
    q, k, v = (ba._split_heads(ba._proj(xn, ws[2 * i], ws[2 * i + 1]), heads) for i in range(3))
    attn = ba._merge_heads((ba._probs(q, k, False).float() @ v.float()).to(BF16))
    want = ba.block_attention_ln_reference(x, gamma, beta, *ws, heads=heads, residual=True)
    (acc,) = gemm_walk(attn.reshape(-1, w), [ws[6]], "NN")
    share = {n: float((store(acc, ws[7], BF16, x2, n).view(b, s, w) != want).float().mean())
             for n in (1, 2)}
    assert share[2] < 0.02, share
    assert share[1] > 0.1, share


@pytest.mark.parametrize("b,s,w,heads,causal", GEMM_CASES)
def test_backward_walk_matches_jax_bwd_kernels_and_plain(b, s, w, heads, causal):
    """The backward's launches in plain torch (the three-set NN recompute, do by the one-segment
    NT form, the attention half, dx by the three-segment NT form rounded once) against the JAX
    _bwd_kernel (S <= 128) or _bwd_kernel_large (S > 128) and the plain backward, every per-token
    output."""
    x, ws, dy, _, _ = _torch_inputs(b, s, w)
    got = block_walk_bwd(x, dy, ws, heads=heads, causal=causal)
    want = ba.block_attention_bwd_reference(x, dy, *ws, heads=heads, causal=causal)
    for name, g, j, p in zip(("dx", "dq", "dk", "dv", "attnpre"), got,
                             _jax_tokens(b, s, w, heads, causal), want):
        _close(g, j, f"{name} vs JAX")
        _close(g, p, f"{name} vs plain")


@pytest.mark.parametrize("b,s,w,heads,causal", [(2, 145, 128, 2, False), (3, 50, 256, 4, True)])
def test_ln_backward_walk_with_float32_g_matches_jax_and_plain(b, s, w, heads, causal,
                                                               monkeypatch):
    """The LN form's backward: q, k, v recomputed on ln_out, g = [dq | dk | dv] W^T by the NT
    form over three segments kept in float32, the LN vjp with the residual's dy; the gradients
    the operator forms from it (ln_out for the weights) against the JAX LN-fold operator's VJP,
    the per-token outputs against the plain LN backward."""
    if s <= 128:
        monkeypatch.setenv("MMTPU_BLOCK_ATTN_LN", "1")
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_attention import block_attention

    x, ws, dy, gamma, beta = _torch_inputs(b, s, w)
    dx, dq, dk, dv, attnpre, ln_out, dgamma, dbeta = block_walk_bwd(
        x, dy, ws, heads=heads, causal=causal, ln=(gamma, beta), residual=True)
    wgrad = lambda a, dz: ba._attn_wgrad(a, dz, BF16)  # noqa: E731
    got = [dx, dgamma, dbeta, wgrad(ln_out, dq), ba._bias_grad(dq, BF16), wgrad(ln_out, dk),
           ba._bias_grad(dk, BF16), wgrad(ln_out, dv), ba._bias_grad(dv, BF16),
           wgrad(attnpre, dy), ba._bias_grad(dy, BF16)]
    to = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    _, vjp = jax.vjp(lambda *a: block_attention(a[0], *a[3:], heads=heads, causal=causal,
                                                ln_scale=a[1], ln_bias=a[2], residual=True),
                     to(x), to(gamma), to(beta), *(to(t) for t in ws))
    want = [np.asarray(g.astype(jnp.float32)) for g in vjp(to(dy))]
    for name, g, r in zip(LN_NAMES, got, want):
        # the key-bias gradient is zero in exact arithmetic: both sides hold rounding noise,
        # summed over every row; it is held on the scale of the query-bias gradient, a sum of
        # the same rows
        _close(g, r, f"{name} vs JAX",
               scale=float(np.abs(want[4]).max()) if name == "dbk" else None)
    plain = ba.block_attention_ln_bwd_reference(x, dy, gamma, beta, *ws, heads=heads,
                                                causal=causal, residual=True)
    for name, g, p in zip(("dx", "dq", "dk", "dv", "attnpre", "ln_out", "dgamma", "dbeta"),
                          (dx, dq, dk, dv, attnpre, ln_out, dgamma, dbeta), plain):
        _close(g, p, f"{name} vs plain")
    # the LN load's function (ln_bf16x8) on x's boxes gives ln_out's bits: the forward's q, k,
    # v and the backward's recompute are the same sums of the same values
    x2 = x.reshape(-1, w)
    fwd_q = store(gemm_walk(x2, [ws[0]], "NN", _ln_load(x2, gamma, beta))[0], ws[1], BF16)
    bwd_q = store(gemm_walk(ln_out.reshape(-1, w), [ws[0]], "NN")[0], ws[1], BF16)
    assert torch.equal(fwd_q, bwd_q)


def test_nt_walk_over_three_segments_is_one_sum_over_k_3w():
    """dx = [dq | dk | dv] [Wq; Wk; Wv]^T: the three segments' K-steps run into one f32 sum, the
    same function as one product over the concatenation (within float32 summation order), and
    not three products rounded apart."""
    rng = np.random.default_rng(3)
    m, w = 150, 256
    grads = [torch.from_numpy(rng.standard_normal((m, w), dtype=np.float32)).to(BF16)
             for _ in range(3)]
    wts = [torch.from_numpy(rng.standard_normal((w, w), dtype=np.float32) * w ** -0.5).to(BF16)
           for _ in range(3)]
    got = gemm_walk(grads, wts, "NT")
    want = torch.cat(grads, dim=1).float() @ torch.cat([t.T for t in wts], dim=0).float()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    apart = sum(store(gemm_walk([a], [wt], "NT"), None, BF16).float()
                for a, wt in zip(grads, wts)).to(BF16)
    assert (apart != got.to(BF16)).float().mean() > 0.05


@pytest.mark.parametrize("items,packed", [(2, True), (3, True), (24, False), (1, True)])
def test_pass_units_give_every_item_one_live_warpgroup(items, packed):
    """Packed, a pass holds two items, one a warpgroup, and an odd count's last pass repeats
    the last item in its second warpgroup without storing it; unpacked, both warpgroups of a
    pass take one item's rows."""
    units = pass_units(items, packed)
    live = sorted(item for _, _, item, ok in units if ok)
    assert live == (list(range(items)) if packed else sorted(list(range(items)) * 2))
    assert all(item == items - 1 for _, _, item, ok in units if not ok)
    assert len(units) == 2 * ((items + 1) // 2 if packed else items)


def _attention_inputs(s, d, heads=2, seed=5):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((1, s, heads * d), dtype=np.float32)).to(BF16)
            for _ in range(4)]


@pytest.mark.parametrize("s,causal", [(50, False), (64, False), (77, True), (129, False),
                                      (197, False)])
@pytest.mark.parametrize("d", [32, 64])
def test_attention_walk_matches_the_plain_attention_half(s, d, causal):
    """The block form's dQ and dK/dV schedule (rounded-probability delta and ds, attnpre from the
    online sweep, two items a pass at S <= 64) at B = 1 and two heads, against the plain
    attention half: attnpre, dq, dk and dv within 2e-2 x max(1, max|plain|)."""
    q, k, v, do = _attention_inputs(s, d)
    got = attention_walk_bwd(q, k, v, do, heads=2, causal=causal)
    want = ba.attention_half_reference(q, k, v, do, heads=2, causal=causal)
    for name, g, r in zip(("attnpre", "dq", "dk", "dv"), got, want):
        _close(g, r, name)


@pytest.mark.parametrize("s,causal", [(50, False), (64, False), (77, True), (129, False),
                                      (197, False)])
@pytest.mark.parametrize("d", [32, 64])
def test_attention_walk_in_the_block_matches_jax_bwd_kernels(s, d, causal):
    """The same schedule inside the whole block at B = 1 and W = 128 (the kernels' narrowest
    width: two heads at D = 64, four at D = 32): the per-token outputs of the backward walk
    against the JAX _bwd_kernel (S <= 128) or _bwd_kernel_large (S > 128) in interpret mode."""
    w, heads = 128, 128 // d
    x, ws, dy, _, _ = _torch_inputs(1, s, w, seed=4)
    got = block_walk_bwd(x, dy, ws, heads=heads, causal=causal)
    for name, g, j in zip(("dx", "dq", "dk", "dv", "attnpre"), got,
                          _jax_tokens(1, s, w, heads, causal, seed=4)):
        _close(g, j, f"{name} vs JAX")


def test_attention_walk_tells_rounded_from_exact_probabilities():
    """The block form rounds p before delta and ds; the fused form keeps the exact p there. At
    S = 77 the walk's dq stays closer to the plain block backward than the fused form's
    arithmetic (the plain fused backward) on the same tensors."""
    from multimodal_tpu_torch.ops import fused_attention as fa

    q, k, v, do = _attention_inputs(77, 64, seed=6)
    _, dq, _, _ = attention_walk_bwd(q, k, v, do, heads=2, causal=False)
    _, want, _, _ = ba.attention_half_reference(q, k, v, do, heads=2, causal=False)
    exact, _, _ = fa.fused_attention_bwd_reference(q, k, v, do, heads=2, causal=False)
    err_walk = (dq.float() - want.float()).abs().mean()
    err_exact = (exact.float() - want.float()).abs().mean()
    assert err_walk < 0.5 * err_exact, (err_walk, err_exact)


@pytest.mark.parametrize("kernel,family", [
    ("wgmma_gemm_kernel<__nv_bfloat16, __nv_bfloat16, 0, 1, 0, 128, 3>",
     "block q/k/v and out-projection GEMMs"),
    ("wgmma_gemm_kernel<__nv_bfloat16, __nv_bfloat16, 0, 0, 1, 128, 3>",
     "block q/k/v and out-projection GEMMs"),
    ("wgmma_gemm_kernel<__nv_bfloat16, float, 1, 0, 0, 128, 3>", "block backward do and dx"),
    ("wgmma_gemm_kernel<__nv_bfloat16, __nv_bfloat16, 0, 0, 0, 128, 1>",
     "fused MLP forward c_proj"),
    ("wgmma_gemm_kernel<__nv_bfloat16, float, 1, 0, 0, 256, 1>", "fused MLP backward dln"),
    ("fused_dq_kernel<(anonymous namespace)::FusedDqOps<64, 64, 1, 1> >", "block backward dQ"),
    ("fused_dkv_kernel<(anonymous namespace)::FusedDkvOps<128, 1, 0> >", "block backward dK/dV"),
    ("fused_dq_kernel<(anonymous namespace)::FusedDqOps<64, 64, 0, 0> >",
     "fused attention backward dQ"),
    ("fused_dkv_kernel<(anonymous namespace)::FusedDkvOps<64, 0, 0> >",
     "fused attention backward dK/dV"),
    ("ln_rows_bf16_kernel", "LN-fold launches"),
])
def test_profile_step_tells_the_block_kernels_from_the_mlp_and_fused(kernel, family):
    """The step profiler's families: a wgmma GEMM with three operand sets is the block kernels',
    with one the fused MLP's; a dQ or dK/dV kernel in its block form (its Ops' form argument 1)
    is the block backward's, in the fused form (0) the fused attention's."""
    from multimodal_tpu_torch.ops._build import gemm_sets
    from multimodal_tpu_torch.profile_step import family_of

    name = f"void (anonymous namespace)::{kernel}((anonymous namespace)::WgmmaGemmArgs)"
    assert family_of(name).startswith(family), family_of(name)
    assert gemm_sets(name) == (3 if kernel.endswith(", 3>") else 1)
