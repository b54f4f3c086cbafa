"""The fused MLP branch of the PyTorch port: ``block_mlp`` / ``BlockMLP`` (forward and all
seven gradients; the plain versions on a CPU tensor) against the JAX package's ``block_mlp``
(its Pallas kernels in interpret mode on the CPU, as tests/test_block_mlp.py runs them), and
the hand-written CUDA kernels against the plain versions on the card.

Inputs come from a seeded numpy generator and go through both sides. The JAX kernel pads a
ragged token count to its tile; the ragged cases force a 16-row tile there, as the JAX
package's own padding test does, while the port has no tile to pad to.

Tolerances. float32, the JAX package's own (tests/test_block_mlp.py): values atol = rtol =
1e-4; gradients atol = 2e-4 x max(1, max|g|), rtol = 2e-3; the two sides differ only in
summation order. bfloat16: both sides round at the same points, so they agree except where a
sum taken in another order flips one rounding: every output within 2e-2 x max(1, max|value|),
and closer to the JAX kernel (in mean absolute error) than the plain LayerNorm -> MLP -> add
composition is, which rounds at other points. float64: the plain backward is the exact
derivative of the plain forward (atol = rtol = 1e-9). On the card, kernel against plain:
every output within 1e-4 x max|plain| in float32 and 2e-2 x max|plain| in bfloat16.

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_block_mlp.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import block_mlp as bm
from multimodal_tpu_torch.ops import launches
from multimodal_tpu_torch.ops.block_attention import LN_EPS, _ln_stats, ln_rows

torch.set_num_threads(1)

NAMES = ["dx", "dgamma", "dbeta", "dw1", "db1", "dw2", "db2"]
# (x shape, hidden, act, residual, ragged)
CASES = [
    ((4, 50, 256), 1024, "quick_gelu", True, False),
    ((2, 77, 128), 512, "gelu", True, False),
    ((150, 128), 512, "quick_gelu", False, False),
    ((39, 128), 512, "gelu", False, True),
    ((3, 13, 128), 512, "quick_gelu", True, True),
]
IDS = ["3d-quick_gelu-res", "3d-gelu-res", "2d-quick_gelu-nores", "2d-gelu-nores-ragged",
       "3d-quick_gelu-res-ragged"]


def _inputs(shape, hidden, seed=0):
    """x, gamma, beta (float32 parameters), w1, b1, w2, b2 and a cotangent dy, float32 numpy."""
    rng = np.random.default_rng(seed)
    w = shape[-1]
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    x = n(*shape)
    gamma, beta = 1 + 0.1 * n(w), 0.1 * n(w)
    w1, b1 = n(w, hidden) * w ** -0.5, 0.02 * n(hidden)
    w2, b2 = n(hidden, w) * hidden ** -0.5, 0.02 * n(w)
    return [x, gamma, beta, w1, b1, w2, b2], n(*shape)


@functools.lru_cache(maxsize=None)
def _jax_run(shape, hidden, act, residual, dtype_name):
    """(y, the seven gradients) of the JAX operator, float32 numpy."""
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_mlp import block_mlp

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    args, dy = _inputs(shape, hidden)
    cast = [dt, jnp.float32, jnp.float32, dt, dt, dt, dt]  # gamma, beta stay float32
    args = [jnp.asarray(a, c) for a, c in zip(args, cast)]

    def fn(x, gamma, beta, w1, b1, w2, b2):
        return block_mlp(x, w1, b1, w2, b2, ln_scale=gamma, ln_bias=beta, act=act,
                         residual=residual)

    y, vjp = jax.vjp(fn, *args)
    grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, dt))]
    return np.asarray(y.astype(jnp.float32)), grads


def _leaves(shape, hidden, dtype, device="cpu"):
    args, dy = _inputs(shape, hidden)
    dts = [dtype, torch.float32, torch.float32, dtype, dtype, dtype, dtype]
    leaves = [torch.from_numpy(a).to(device=device, dtype=d).requires_grad_()
              for a, d in zip(args, dts)]
    return leaves, torch.from_numpy(dy).to(device=device, dtype=dtype)


def _port_run(shape, hidden, act, residual, dtype, device="cpu", fn=None):
    """(y, the seven gradients) of the port's operator (or of ``fn``), float32 numpy."""
    (x, gamma, beta, w1, b1, w2, b2), dy = _leaves(shape, hidden, dtype, device)
    leaves = [x, gamma, beta, w1, b1, w2, b2]
    fn = fn or bm.block_mlp
    y = fn(x, w1, b1, w2, b2, ln_scale=gamma, ln_bias=beta, act=act, residual=residual)
    y.backward(dy)
    return y.detach().float().cpu().numpy(), [t.grad.float().cpu().numpy() for t in leaves]


def _composition(x, w1, b1, w2, b2, *, ln_scale, ln_bias, act, residual):
    """The block's MLP half without the operator: LayerNorm, MLP and add as separate steps
    in the compute dtype (what ``MLP`` runs with the switch off)."""
    y = bm.act_fwd(ln_rows(x, ln_scale, ln_bias, LN_EPS) @ w1 + b1, act) @ w2 + b2
    return x + y if residual else y


def _force_jax_tile(monkeypatch, ragged):
    if ragged:
        monkeypatch.setenv("MMTPU_BLOCK_MLP_M_FWD", "16")
        monkeypatch.setenv("MMTPU_BLOCK_MLP_M_BWD", "16")


@pytest.mark.parametrize("shape,hidden,act,residual,ragged", CASES, ids=IDS)
def test_forward_matches_jax_f32(shape, hidden, act, residual, ragged, monkeypatch):
    _force_jax_tile(monkeypatch, ragged)
    want, _ = _jax_run(shape, hidden, act, residual, "float32")
    got, _ = _port_run(shape, hidden, act, residual, torch.float32)
    assert got.shape == tuple(shape)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape,hidden,act,residual,ragged", CASES, ids=IDS)
def test_all_seven_grads_match_jax_f32(shape, hidden, act, residual, ragged, monkeypatch):
    _force_jax_tile(monkeypatch, ragged)
    _, want = _jax_run(shape, hidden, act, residual, "float32")
    _, got = _port_run(shape, hidden, act, residual, torch.float32)
    assert len(got) == len(want) == len(NAMES)
    for name, g, r in zip(NAMES, got, want):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-4 * scale, rtol=2e-3, err_msg=name)


@pytest.mark.parametrize("act", bm.ACTS)
def test_bf16_rounding_points_follow_the_jax_kernel(act):
    """bfloat16: the operator rounds h once from the f32 sum, evaluates the activation in
    f32 from the rounded h, rounds g @ W2 + b2 + x once, and builds the backward's LN from
    the f32 xhat. With the same rounding points the two sides give the same bits except
    where a sum taken in another order flips one rounding: y, dx, dW2 and db1 differ in
    under 1% of their elements (measured: under 0.2%), where the composition, which rounds
    elsewhere, differs in over half. dW1 agrees less tightly, because XLA's CPU backend
    keeps excess precision there: it hands ``round(xhat) * gamma + beta`` to the product
    without rounding the add (a TPU's bf16 operand is rounded, as the program text says); it
    still sits closer to the JAX kernel than the composition or the forward's LN form do."""
    shape, hidden = (4, 50, 256), 1024
    want_y, want = _jax_run(shape, hidden, act, True, "bfloat16")
    got_y, got = _port_run(shape, hidden, act, True, torch.bfloat16)
    far_y, far = _port_run(shape, hidden, act, True, torch.bfloat16, fn=_composition)
    mae = lambda a, b: float(np.abs(a - b).mean())  # noqa: E731
    differ = lambda a, b: float((a != b).mean())  # noqa: E731
    np.testing.assert_allclose(got_y, want_y, atol=2e-2 * max(1.0, np.abs(want_y).max()), rtol=0)
    assert differ(got_y, want_y) < 0.01 < 0.3 < differ(far_y, want_y)
    for name, g, f, r in zip(NAMES, got, far, want):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-2 * scale, rtol=0, err_msg=name)
        if name in ("dx", "dw2", "db1"):
            assert differ(g, r) < 0.01 < 0.3 < differ(f, r), name
        if name == "dw1":
            assert mae(g, r) < 0.5 * mae(f, r), name


@pytest.mark.parametrize("act", bm.ACTS)
@pytest.mark.parametrize("residual", [False, True])
def test_function_matches_autograd_of_plain_forward_f64(act, residual):
    """In float64 no rounding point rounds, so ``BlockMLP``'s backward (the plain backward
    on the CPU) equals torch's autograd of the plain forward."""
    leaves, dy = _leaves((39, 128), 256, torch.float64)
    leaves = [t.detach().double().requires_grad_() for t in leaves]
    y = bm.BlockMLP.apply(*leaves, act, residual)
    got = torch.autograd.grad(y, leaves, dy)
    y_plain, _ = bm.block_mlp_reference(*leaves, act=act, residual=residual)
    want = torch.autograd.grad(y_plain, leaves, dy)
    torch.testing.assert_close(y, y_plain, atol=0, rtol=0)
    for name, g, r in zip(NAMES, got, want):
        torch.testing.assert_close(g, r, atol=1e-9, rtol=1e-9, msg=name)


def test_function_gradcheck_f64():
    rng = np.random.default_rng(3)
    t, w, hid = 7, 16, 32
    n = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
    args = [n(t, w), 1 + 0.1 * n(w), 0.1 * n(w), n(w, hid) * w ** -0.5, 0.1 * n(hid),
            n(hid, w) * hid ** -0.5, 0.1 * n(w)]
    args = [a.requires_grad_() for a in args]
    for act in bm.ACTS:
        fn = lambda *a: bm.BlockMLP.apply(*a, act, True)  # noqa: E731, B023
        assert torch.autograd.gradcheck(fn, args)


def test_unknown_act_raises():
    (x, gamma, beta, w1, b1, w2, b2), _ = _leaves((2, 8, 128), 512, torch.float32)
    with pytest.raises(ValueError, match="act must be one of"):
        bm.block_mlp(x, w1, b1, w2, b2, ln_scale=gamma, ln_bias=beta, act="relu")


def test_supported_shapes_equal_the_jax_rule():
    from multimodal_tpu.ops.block_mlp import ACTS, block_mlp_supported

    assert tuple(ACTS) == bm.ACTS
    for width in (64, 96, 128, 192, 256, 384, 512, 640, 768, 1024, 1280):
        for ratio in (1.0, 2.0, 2.5, 4.0, 4.3637):
            for act in ("quick_gelu", "gelu", "relu", None):
                hidden = int(width * ratio)
                assert (bm.block_mlp_supported(width, hidden, act)
                        == block_mlp_supported(width, hidden, act)), (width, hidden, act)


def test_grads_keep_parameter_dtypes_and_a_cpu_tensor_launches_nothing():
    """bfloat16 compute with float32 LayerNorm parameters: dgamma and dbeta come back in
    float32, the weight and bias gradients in the compute dtype."""
    launches.reset_launch_counts()
    (x, gamma, beta, w1, b1, w2, b2), dy = _leaves((3, 20, 128), 256, torch.bfloat16)
    y = bm.block_mlp(x, w1, b1, w2, b2, ln_scale=gamma, ln_bias=beta)
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    y.backward(dy)
    assert gamma.grad.dtype == beta.grad.dtype == torch.float32
    assert all(t.grad.dtype == torch.bfloat16 for t in (x, w1, b1, w2, b2))
    counts = launches.launch_counts()
    assert counts["block_mlp_fwd"] == 0 and counts["block_mlp_bwd"] == 0


def test_h_is_kept_only_when_a_gradient_is_asked_for():
    """The forward saves the pre-activation for the backward; without grad mode no graph
    node exists to hold it (the reference's ``save_h=False``)."""
    (x, gamma, beta, w1, b1, w2, b2), _ = _leaves((10, 128), 256, torch.float32)
    y = bm.BlockMLP.apply(x, gamma, beta, w1, b1, w2, b2, "quick_gelu", True)
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved][-1] == (10, 256)
    _, h = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2)
    torch.testing.assert_close(saved[-1], h, atol=0, rtol=0)
    with torch.no_grad():
        assert bm.block_mlp(x, w1, b1, w2, b2, ln_scale=gamma, ln_bias=beta).grad_fn is None


def test_db1_sums_the_unrounded_dh():
    """bfloat16: db1 is the column sum of the f32 dh32, not of the rounded dh that feeds the
    products; the two differ by far more than float32 noise."""
    (x, gamma, beta, w1, b1, w2, b2), dy = _leaves((200, 128), 256, torch.bfloat16)
    args = [t.detach() for t in (x, gamma, beta, w1, b1, w2, b2)]
    _, h = bm.block_mlp_reference(*args)
    x, gamma, beta, w1, b1, w2, b2 = args
    db1 = bm.block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2)[3]
    dg = dy.float() @ w2.float().T
    dh32 = dg * bm.act_bwd(h.float(), "quick_gelu")
    torch.testing.assert_close(db1, dh32.sum(0), atol=1e-5, rtol=1e-5)
    assert (db1 - dh32.bfloat16().float().sum(0)).abs().max() > 1e-3


def _db1_partials_in_kernel_order(dh32: torch.Tensor, gemm: str = "wgmma") -> torch.Tensor:
    """The act' store's column sums of the unrounded dh32 [T, H], one row per 128-token tile,
    in the kernel's order. bfloat16 (``wgmma``, wgmma_gemm.cuh): each of the tile's eight warps
    owns 16 rows, a lane (g = 0..7) its rows g and g + 8, added in that order; a butterfly adds
    lane g ^ 1, g ^ 2, g ^ 4; then the eight warps' sums are added in row order. float32
    (``mma``, mma_gemm.cuh): a lane of one of two row-warps of 64 rows sums its rows g, g + 8,
    ..., g + 56 in order, the same butterfly, then the two row-warps' sums. Rows past T add
    nothing."""
    t, hid = dh32.shape
    rows = []
    for m0 in range(0, t, 128):
        tile = torch.zeros(128, hid)
        tile[:min(128, t - m0)] = dh32[m0:m0 + 128]
        if gemm == "wgmma":
            warp_rows = [[[16 * wp + g, 16 * wp + g + 8] for g in range(8)] for wp in range(8)]
        else:
            warp_rows = [[[wm + 16 * mt + g + 8 * h for mt in range(4) for h in range(2)]
                          for g in range(8)] for wm in (0, 64)]
        warps = []
        for lane_rows in warp_rows:
            lanes = [functools.reduce(torch.add, [tile[r] for r in rows_g])
                     for rows_g in lane_rows]
            for off in (1, 2, 4):
                lanes = [lanes[g] + lanes[g ^ off] for g in range(8)]
            warps.append(lanes[0])
        rows.append(functools.reduce(torch.add, warps))
    return torch.stack(rows)


def test_db1_fixed_order_column_sums_sum_the_unrounded_dh():
    """bfloat16, T = 200 (a full 128-token tile and a ragged one): the kernel's fixed-order
    column sums of dh32, summed over the tiles, are db1 of the plain backward (the sum of the
    unrounded dh32, up to float32 order), and not the sum of the rounded dh."""
    (x, gamma, beta, w1, b1, w2, b2), dy = _leaves((200, 128), 256, torch.bfloat16)
    args = [t.detach() for t in (x, gamma, beta, w1, b1, w2, b2)]
    _, h = bm.block_mlp_reference(*args)
    x, gamma, beta, w1, b1, w2, b2 = args
    db1 = bm.block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2)[3]
    dh32 = (dy.float() @ w2.float().T) * bm.act_bwd(h.float(), "quick_gelu")
    for gemm in ("wgmma", "mma"):  # the bfloat16 kernel's order, and float32's
        parts = _db1_partials_in_kernel_order(dh32, gemm)
        assert parts.shape == (2, 256)
        torch.testing.assert_close(parts.sum(0), db1, atol=1e-5, rtol=1e-5)
        assert (parts.sum(0) - dh32.bfloat16().float().sum(0)).abs().max() > 1e-3


def _tn_dw1(x, dh, gamma, beta, *, mask: bool, stale_b: bool) -> torch.Tensor:
    """dW1 = ln_b^T dh as the TN form walks it (both GEMMs: K-steps of 64 token rows, one f32
    sum). A tile: x's rows, zero past T, then the LN-b transform (xhat32 rounded, times gamma,
    plus beta, rounding to x.dtype) on the rows below T (``mask``) or on all 64 (statistics past
    T read as 0). B tile: dh's rows, past T zeros as cp.async (float32) and TMA (bfloat16) write
    them, or (``stale_b``) other values, as a tile would hold without that fill."""
    t, w = x.shape
    dt, hid = x.dtype, dh.shape[1]
    mean, inv = _ln_stats(x, LN_EPS)
    gen = torch.Generator().manual_seed(0)
    acc = torch.zeros(w, hid)
    for k0 in range(0, t, 64):
        live = min(64, t - k0)
        a, mu, iv = torch.zeros(64, w), torch.zeros(64, 1), torch.zeros(64, 1)
        a[:live], mu[:live], iv[:live] = x[k0:k0 + live].float(), mean[k0:k0 + live], inv[k0:k0 + live]
        rows = slice(0, live if mask else 64)
        a[rows] = (((a[rows] - mu[rows]) * iv[rows]).to(dt) * gamma + beta).float()
        b = torch.randn(64, hid, generator=gen) if stale_b else torch.zeros(64, hid)
        b[:live] = dh[k0:k0 + live].float()
        acc = acc + a.T @ b
    return acc


def test_tn_weight_gradient_masks_the_padded_rows_after_the_ln_b_transform():
    """dW1 in bfloat16 at T = 200 (no multiple of the 64-row K-step) with beta != 0: LN-b of a
    zero row is beta, so the TN form's A tile is zero past T only because the transform skips
    those rows (their statistics lie past their buffer too). With the mask, the K-step walk
    gives the plain dW1 whatever the padded B rows hold; without it, only while they are zero."""
    (x, gamma, beta, w1, b1, w2, b2), dy = _leaves((200, 128), 256, torch.bfloat16)
    x, gamma, beta = x.detach(), gamma.detach().bfloat16(), beta.detach().bfloat16()
    assert beta.abs().min() > 0
    dh = torch.from_numpy(np.random.default_rng(3).standard_normal((200, 256), dtype=np.float32))
    dh = dh.bfloat16()
    mean, inv = _ln_stats(x, LN_EPS)
    ln = ((x.float() - mean) * inv).bfloat16() * gamma + beta  # block_mlp_bwd_reference's ln
    want = ln.float().T @ dh.float()
    rel = lambda got: ((got - want).abs().max() / want.abs().max()).item()  # noqa: E731
    for stale_b in (False, True):
        assert rel(_tn_dw1(x, dh, gamma, beta, mask=True, stale_b=stale_b)) <= 1e-5
    assert rel(_tn_dw1(x, dh, gamma, beta, mask=False, stale_b=False)) <= 1e-5
    assert rel(_tn_dw1(x, dh, gamma, beta, mask=False, stale_b=True)) > 1e-2


# ----------------------------------------------------------------------------- the bf16 walk
# wgmma_gemm.cuh, the bfloat16 GEMM under the operator: 128 x 128 tiles of C, K-steps of 64 (four
# k16 products each, f32 sums), TMA boxes that land zeros past a tensor's extent, the load
# transforms on the landed A tile, the weight gradients split over the token rows
WG_TILE, WG_KSTEP = 128, 64


def _tma_box(mat: torch.Tensor, r0: int, c0: int, rows: int, cols: int) -> torch.Tensor:
    """rows x cols of ``mat`` from (r0, c0), zeros past either extent, as TMA lands a box."""
    box = torch.zeros(rows, cols, dtype=mat.dtype)
    part = mat[r0:r0 + rows, c0:c0 + cols]
    box[:part.shape[0], :part.shape[1]] = part
    return box


def _wgmma_walk(a, b, form: str, *, transform=None, splits: int = 1, k_per_split=None):
    """The f32 sums of ``wgmma_gemm_kernel`` before its store, tile by tile and K-step by K-step:
    [splits, M, N] for NN (a [M, K], b [K, N]), NT (a [M, K], b [N, K]) and TN (a [K, M], b [K, N];
    split z sums the token rows [z kps, min(K, (z + 1) kps))). ``transform(tile, r0, c0, k_end)``
    is the load transform of a landed A box whose first element is a[r0, c0] as A lies in
    memory."""
    k, m = a.shape if form == "TN" else a.shape[::-1]
    n = b.shape[0] if form == "NT" else b.shape[1]
    kps = k_per_split or k
    out = torch.zeros(splits, -(-m // WG_TILE) * WG_TILE, n)
    for z in range(splits):
        k_begin, k_end = z * kps, min(k, (z + 1) * kps)
        for m0 in range(0, m, WG_TILE):
            for n0 in range(0, n, WG_TILE):
                acc = torch.zeros(WG_TILE, WG_TILE)
                for k0 in range(k_begin, k_end, WG_KSTEP):
                    if form == "TN":  # [64 token rows][128 of M], transformed, read transposed
                        at = _tma_box(a, k0, m0, WG_KSTEP, WG_TILE)
                        at = (transform(at, k0, m0, k_end) if transform else at).T
                    else:
                        at = _tma_box(a, m0, k0, WG_TILE, WG_KSTEP)
                        at = transform(at, m0, k0, k_end) if transform else at
                    if form == "NT":
                        bt = _tma_box(b, n0, k0, WG_TILE, WG_KSTEP).T
                    else:
                        bt = _tma_box(b, k0, n0, WG_KSTEP, WG_TILE)
                    for kk in range(0, WG_KSTEP, 16):
                        acc = acc + at[:, kk:kk + 16].float() @ bt[kk:kk + 16].float()
                out[z, m0:m0 + WG_TILE, n0:n0 + WG_TILE] = acc
    return out[:, :m]


def _wgmma_splits(t: int, w: int, hid: int):
    """(splits, token rows a split owns, splits that hold rows) of the weight gradients."""
    splits = bm._wgrad_splits(t, w, hid, torch.bfloat16)
    kps = -(-(-(-t // splits)) // WG_KSTEP) * WG_KSTEP
    return splits, kps, -(-t // kps)


def wgmma_walk_fwd(x, gamma, beta, w1, b1, w2, b2, *, act, residual):
    """(y, h) of the bfloat16 forward as its launches form them: the row statistics, c_fc (NN,
    the LN load with each row's statistics rounded to bf16 and every step rounding, rows past
    T on statistics of 0; the round+act store), c_proj (NN on g; the bias-residual store). The
    walk's activation is the plain ``act_fwd``; the kernel's, on the special-function unit, is
    a few f32 ulp from it before the bf16 rounding."""
    dt, t = x.dtype, x.shape[0]
    gamma, beta = gamma.to(dt), beta.to(dt)
    mean, inv = _ln_stats(x, LN_EPS)

    def ln(tile, r0, c0, k_end):
        st = torch.zeros(WG_TILE, 2)
        live = min(WG_TILE, t - r0)
        st[:live] = torch.cat([mean, inv], dim=1)[r0:r0 + live]
        st = st.to(dt)
        return ((tile - st[:, :1]) * st[:, 1:]) * gamma[c0:c0 + WG_KSTEP] + beta[c0:c0 + WG_KSTEP]

    h = (_wgmma_walk(x, w1, "NN", transform=ln)[0] + b1.float()).to(dt)
    g = bm.act_fwd(h.float(), act).to(dt)
    y = _wgmma_walk(g, w2, "NN")[0] + b2.float()
    if residual:
        y = y + x.float()
    return y.to(dt), h


def wgmma_walk_bwd(x, dy, h, gamma, beta, w1, w2, *, act, residual):
    """(dx, dW1, dW2, db1, db2, dgamma, dbeta) of the bfloat16 backward as its launches form
    them: dh (NT, the act' store, db1 from the fixed-order partials), dln (NT, f32), the LN
    vjp rows (the plain version's f32 arithmetic), dW2 (TN, the act load) and dW1 (TN, the LN-b
    load, token rows past T left zero) split over the token rows, one f32 partial each, the
    splits past the last row zero."""
    dt, (t, w), hid = x.dtype, x.shape, w1.shape[1]
    gamma32 = gamma.float()
    gamma, beta = gamma.to(dt), beta.to(dt)
    mean, inv = _ln_stats(x, LN_EPS)
    h32 = h.float()
    dh32 = _wgmma_walk(dy, w2, "NT")[0] * bm.act_bwd(h32, act)
    dh = dh32.to(dt)
    db1 = _db1_partials_in_kernel_order(dh32).sum(dim=0)
    dln = _wgmma_walk(dh, w1, "NT")[0]
    x32, dy32 = x.float(), dy.float()
    xhat = (x32 - mean) * inv
    dxhat = dln * gamma32
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    if residual:
        dx = dx + dy32
    splits, kps, used = _wgmma_splits(t, w, hid)

    def act_load(tile, k0, c0, k_end):
        return bm.act_fwd(tile.float(), act).to(dt)

    def ln_b(tile, k0, c0, k_end):
        live = max(0, min(WG_KSTEP, k_end - k0))  # token rows past T stay zero
        rows = slice(k0, k0 + live)
        xh = ((tile[:live].float() - mean[rows]) * inv[rows]).to(dt)
        tile = tile.clone()
        tile[:live] = xh * gamma[c0:c0 + WG_TILE] + beta[c0:c0 + WG_TILE]
        return tile

    parts = []
    for a, b, load, rows_out, cols_out in ((h, dy, act_load, hid, w), (x, dh, ln_b, w, hid)):
        part = torch.zeros(splits, rows_out, cols_out)
        part[:used] = _wgmma_walk(a, b, "TN", transform=load, splits=used, k_per_split=kps)
        parts.append(part.sum(dim=0).to(dt))
    dw2, dw1 = parts
    return (dx.to(dt), dw1, dw2, db1, dy32.sum(dim=0), (dln * xhat).sum(dim=0),
            dln.sum(dim=0))


# ragged T across the walk's 128-row tiles and 64-row K-steps, several N tiles and K-steps; the
# third at W = H = 128 (one output tile, so T // 512 splits of the token rows) with a split that
# holds no row; 3x13 rows short of one tile
WALK_CASES = [((129, 128), 256, "quick_gelu", True), ((191, 256), 512, "gelu", False),
              ((5121, 128), 128, "quick_gelu", True), ((3, 13, 128), 512, "gelu", True)]
WALK_IDS = ["T129", "T191", "T5121-split", "T39"]


def _walk_outputs(shape, hidden, act, residual):
    """The walk's y and its seven gradients (NAMES' order), float32 numpy, from _inputs."""
    (x, gamma, beta, w1, b1, w2, b2), dy = _leaves(shape, hidden, torch.bfloat16)
    x, gamma, beta, w1, b1, w2, b2 = (a.detach() for a in (x, gamma, beta, w1, b1, w2, b2))
    w = shape[-1]
    x2, dy2 = x.reshape(-1, w), dy.reshape(-1, w)
    y, h = wgmma_walk_fwd(x2, gamma, beta, w1, b1, w2, b2, act=act, residual=residual)
    dx, dw1, dw2, db1, db2, dgamma, dbeta = wgmma_walk_bwd(
        x2, dy2, h, gamma, beta, w1, w2, act=act, residual=residual)
    grads = [dx.reshape(shape), dgamma, dbeta, dw1, db1, dw2, db2]
    return y.reshape(shape).float().numpy(), [g.float().numpy() for g in grads]


def test_wgmma_walk_splits_cover_the_token_rows():
    """The walk's splits: k_per_split a multiple of the K-step, the used splits cover T and
    each holds rows; at T = 5121 with one output tile ten splits are asked and nine hold rows."""
    for t, w, hid in ((129, 128, 256), (5121, 128, 128), (4609, 128, 128), (256 * 197, 768, 3072)):
        splits, kps, used = _wgmma_splits(t, w, hid)
        assert kps % WG_KSTEP == 0 and (used - 1) * kps < t <= used * kps <= splits * kps + kps
        assert used <= splits
    assert _wgmma_splits(5121, 128, 128) == (10, 576, 9)
    assert _wgmma_splits(4609, 128, 128) == (9, 576, 9)  # the last split holds one row


@pytest.mark.parametrize("shape,hidden,act,residual", WALK_CASES, ids=WALK_IDS)
def test_wgmma_walk_matches_plain_bf16(shape, hidden, act, residual):
    """The bfloat16 kernels' schedule in plain torch against the plain versions: every output
    within 2e-2 x max(1, max|value|), as bfloat16 is held against the JAX kernel."""
    got_y, got = _walk_outputs(shape, hidden, act, residual)
    want_y, want = _port_run(shape, hidden, act, residual, torch.bfloat16)
    np.testing.assert_allclose(got_y, want_y, atol=2e-2 * max(1.0, np.abs(want_y).max()), rtol=0)
    for name, g, r in zip(NAMES, got, want):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-2 * scale, rtol=0, err_msg=name)


@pytest.mark.parametrize("shape,hidden,act,residual",
                         [c for c in WALK_CASES if c[0][0] != 5121],
                         ids=[i for i, c in zip(WALK_IDS, WALK_CASES) if c[0][0] != 5121])
def test_wgmma_walk_matches_jax_bf16(shape, hidden, act, residual, monkeypatch):
    """The same walk against the JAX operator (its Pallas kernels in interpret mode, a 16-row
    tile so that it pads the ragged T): every output within 2e-2 x max(1, max|value|)."""
    _force_jax_tile(monkeypatch, True)
    want_y, want = _jax_run(shape, hidden, act, residual, "bfloat16")
    got_y, got = _walk_outputs(shape, hidden, act, residual)
    np.testing.assert_allclose(got_y, want_y, atol=2e-2 * max(1.0, np.abs(want_y).max()), rtol=0)
    for name, g, r in zip(NAMES, got, want):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-2 * scale, rtol=0, err_msg=name)


def test_wgmma_walk_ln_b_masks_the_token_rows_past_t():
    """dW1 at T = 129 with beta != 0: the LN-b transform leaves the token rows past T the zeros
    TMA landed, so the walk's partial is the plain ln^T dh whatever the B box holds there; LN-b
    on those rows (beta) only vanishes while B's rows past T are zero."""
    (x, gamma, beta, *_), _ = _leaves((129, 128), 256, torch.bfloat16)
    x, gamma, beta = x.detach(), gamma.detach().bfloat16(), beta.detach().bfloat16()
    dh = torch.from_numpy(np.random.default_rng(5).standard_normal((129, 256), dtype=np.float32))
    dh = dh.bfloat16()
    mean, inv = _ln_stats(x, LN_EPS)
    want = (((x.float() - mean) * inv).bfloat16() * gamma + beta).float().T @ dh.float()
    rel = lambda got: ((got - want).abs().max() / want.abs().max()).item()  # noqa: E731

    def ln_b(mask):
        def load(tile, k0, c0, k_end):
            live = max(0, min(WG_KSTEP, k_end - k0)) if mask else WG_KSTEP
            st = torch.zeros(WG_KSTEP, 2)
            n = max(0, min(WG_KSTEP, 129 - k0))
            st[:n] = torch.cat([mean, inv], dim=1)[k0:k0 + n]
            tile = tile.clone()
            xh = ((tile[:live].float() - st[:live, :1]) * st[:live, 1:]).bfloat16()
            tile[:live] = xh * gamma[c0:c0 + WG_TILE] + beta[c0:c0 + WG_TILE]
            return tile
        return load

    stale = torch.cat([dh, torch.randn(63, 256).bfloat16()])  # a B box without the zero fill
    assert rel(_wgmma_walk(x, dh, "TN", transform=ln_b(True))[0]) <= 1e-5
    assert rel(_wgmma_walk(x, dh, "TN", transform=ln_b(False))[0]) <= 1e-5
    x_pad = torch.cat([x, torch.zeros(63, 128, dtype=x.dtype)])
    masked = _wgmma_walk(x_pad, stale, "TN", transform=ln_b(True), k_per_split=129)[0]
    assert rel(masked) <= 1e-5
    unmasked = _wgmma_walk(x_pad, stale, "TN", transform=ln_b(False), k_per_split=129)[0]
    assert rel(unmasked) > 1e-2


def _c_proj_store(acc, b2, x, store: str) -> torch.Tensor:
    """The c_proj GEMM's store of its f32 sum acc [T, W] in x.dtype: ``bias-residual``,
    (acc + b2) + x in f32 and one rounding; ``round``, acc + b2 and one rounding (the branch
    without the residual); ``residual``, the block forward's order, acc + b2 rounded, then + x
    and rounded again."""
    dt = x.dtype
    lo = acc + b2.float()
    if store == "round":
        return lo.to(dt)
    if store == "residual":
        lo = lo.to(dt).float()
    return (lo + x.float()).to(dt)


@pytest.mark.parametrize("act", bm.ACTS)
def test_bf16_c_proj_store_rounds_once_as_the_plain_forward(act):
    """bfloat16: c_proj's bias-residual store, the f32 sum g @ W2 plus b2 plus x rounded once,
    is the plain forward's y bit for bit (and the round store its branch value); the
    two-rounding order of the block forward's residual store differs from it in over a fifth
    of the elements (measured: 26% at this shape, both activations), where a sum taken in
    another order flips under 1% (``test_bf16_rounding_points_follow_the_jax_kernel``)."""
    (x, gamma, beta, w1, b1, w2, b2), _ = _leaves((4, 50, 256), 1024, torch.bfloat16)
    x, gamma, beta, w1, b1, w2, b2 = (a.detach() for a in (x, gamma, beta, w1, b1, w2, b2))
    x = x.reshape(-1, 256)
    y, h = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act)
    branch, _ = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act, residual=False)
    g = bm.act_fwd(h.float(), act).to(torch.bfloat16)  # the act load transform's g
    acc = g.float() @ w2.float()
    assert torch.equal(_c_proj_store(acc, b2, x, "bias-residual"), y)
    assert torch.equal(_c_proj_store(acc, b2, x, "round"), branch)
    differ = (_c_proj_store(acc, b2, x, "residual") != y).float().mean().item()
    assert differ > 0.2, differ


def _c_proj_walk(g, w2, b2, x, *, pad: str) -> torch.Tensor:
    """y = g @ W2 + b2 + x as the NN form walks it: 128-row blocks of g [T, H] (c_fc's store
    wrote its T rows), the rows past T ``zeros`` as cp.async fills them or ``stale`` values,
    K-steps of 64 into one f32 sum, the bias-residual store on the rows below T. Returns the
    [blocks x 128, W] output buffer, NaN where the store wrote nothing."""
    t, hid = g.shape
    rows = -(-t // 128) * 128
    out = torch.full((rows, w2.shape[1]), float("nan"), dtype=x.dtype)
    gen = torch.Generator().manual_seed(0)
    for m0 in range(0, t, 128):
        live = min(128, t - m0)
        a = torch.zeros(128, hid) if pad == "zeros" else torch.randn(128, hid, generator=gen)
        a = a.to(g.dtype)
        a[:live] = g[m0:m0 + live]
        acc = torch.zeros(128, w2.shape[1])
        for k0 in range(0, hid, 64):
            acc = acc + a[:, k0:k0 + 64].float() @ w2[k0:k0 + 64].float()
        out[m0:m0 + live] = _c_proj_store(acc[:live], b2, x[m0:m0 + live], "bias-residual")
    return out


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_c_proj_walk_keeps_rows_past_t_out_of_y(dtype, tol):
    """T = 3 x 197 = 591 token rows, no multiple of the 128-row block: the last block has 79
    live rows. On g = round(act(f32(h))) as c_fc's store writes it, the NN walk's y equals the
    plain forward's on the T rows (within tol x max|plain|: the K-steps sum in another order)
    and the store writes no row past T. A row of y reads only its own row of g, so whatever the
    padded rows hold, the T rows come out the same bits."""
    (x, gamma, beta, w1, b1, w2, b2), _ = _leaves((3 * 197, 128), 512, dtype)
    x, gamma, beta, w1, b1, w2, b2 = (a.detach() for a in (x, gamma, beta, w1, b1, w2, b2))
    for act in bm.ACTS:
        y, h = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act)
        g = bm.act_fwd(h.float(), act).to(dtype)
        got = _c_proj_walk(g, w2, b2, x, pad="zeros")
        assert got.shape[0] == 640 and torch.isnan(got[591:].float()).all()
        err = (got[:591].float() - y.float()).abs().max().item()
        assert err <= tol * y.float().abs().max().item(), (act, err)
        assert torch.equal(got[:591], _c_proj_walk(g, w2, b2, x, pad="stale")[:591])


def test_forward_bench_names_each_launch():
    """``bench_block_mlp --forward`` splits the forward's device time by launch: the GEMM
    instantiation with the LN load is c_fc, the plain NN one c_proj (with or without the
    residual), any other kernel "other"."""
    from multimodal_tpu_torch.bench_block_mlp import launch_of

    gemm = "void (anonymous namespace)::mma_gemm_kernel<{}>((anonymous namespace)::MmaGemmArgs)"
    assert launch_of(gemm.format("float, float, 0, 1, 4")) == "c_fc"
    assert launch_of(gemm.format("__nv_bfloat16, __nv_bfloat16, 0, 0, 3")) == "c_proj"
    assert launch_of(gemm.format("float, float, 0, 0, 0")) == "c_proj"
    assert launch_of("void (anonymous namespace)::ln_stats_kernel<float>(...)") == "other"


# the bfloat16 GEMM's seven instantiations as nvcc 12 mangles them (the SASS, ptxas) and the
# (T, TOut, form, load, store) each stands for
WGMMA_KERNELS = {  # ... and the tile width, the last template argument
    "S1_Li0ELi1ELi4ELi128E": ("bfloat16", "bfloat16", "NN", "LN", "round+act"),  # c_fc
    "S1_Li0ELi0ELi3ELi128E": ("bfloat16", "bfloat16", "NN", "plain", "bias-residual"),  # c_proj
    "S1_Li0ELi0ELi0ELi128E": ("bfloat16", "bfloat16", "NN", "plain", "round"),  # the branch
    "S1_Li1ELi0ELi2ELi128E": ("bfloat16", "bfloat16", "NT", "plain", "act'"),   # dh
    "fLi1ELi0ELi0ELi256E": ("bfloat16", "float", "NT", "plain", "round"),       # dln
    "fLi2ELi2ELi0ELi256E": ("bfloat16", "float", "TN", "act", "round"),         # dW2
    "fLi2ELi3ELi0ELi256E": ("bfloat16", "float", "TN", "LN-b", "round"),        # dW1
}


@pytest.mark.parametrize("args", sorted(WGMMA_KERNELS))
def test_gemm_signature_reads_the_wgmma_kernel_names(args):
    """The step profiler, chip_smoke.py's phase 2 and bench_block_mlp name the bfloat16 GEMM's
    launches by their template arguments, from the mangled name and from the demangled one;
    bench_block_mlp counts the LN-load instantiation as c_fc, any other as c_proj."""
    from multimodal_tpu_torch.bench_block_mlp import launch_of
    from multimodal_tpu_torch.ops._build import GEMM_FORMS, GEMM_LOADS, GEMM_STORES, gemm_signature

    mangled = ("_ZN45_GLOBAL__N__032e4a30_12_block_mlp_cu_142b870417wgmma_gemm_kernelI13__nv_"
               f"bfloat16{args}EEv14CUtensorMap_stS2_NS_13WgmmaGemmArgsE")
    want = WGMMA_KERNELS[args]
    assert gemm_signature(mangled) == want
    types = ", ".join("__nv_bfloat16" if t == "bfloat16" else t for t in want[:2])
    ints = [GEMM_FORMS.index(want[2]), GEMM_LOADS.index(want[3]), GEMM_STORES.index(want[4]),
            int(args[-4:-1])]
    demangled = (f"void (anonymous namespace)::wgmma_gemm_kernel<{types}, "
                 f"{', '.join(map(str, ints))}>(CUtensorMap_st, CUtensorMap_st, "
                 "(anonymous namespace)::WgmmaGemmArgs)")
    assert gemm_signature(demangled) == want
    assert launch_of(demangled) == ("c_fc" if want[3] == "LN" else "c_proj")


def test_bench_block_mlp_refuses_without_a_card(monkeypatch):
    """``python -m multimodal_tpu_torch.bench_block_mlp [--root DIR]`` times the kernels on the
    card only: without one it exits before importing anything from the tree it was given."""
    from multimodal_tpu_torch import bench_block_mlp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--forward"], ["--root", "/nonexistent", "--tag", "parent"]):
        with pytest.raises(SystemExit, match="needs an NVIDIA GPU"):
            bench_block_mlp.main(argv)


@pytest.mark.parametrize("t,w,hid", [(256 * 50, 768, 3072), (256 * 197, 768, 3072),
                                     (64 * 257, 1024, 4096), (3 * 197, 768, 3072), (7, 128, 512)])
def test_float32_weight_gradient_splits_stay_under_the_row_cap(t, w, hid):
    """A float32 split of the weight-gradient products sums at most WGRAD_F32_MAX_ROWS token
    rows, rounded up to the 64-row K-step, whatever WGRAD_BLOCKS asks; bfloat16 keeps the
    block target's split."""
    splits32 = bm._wgrad_splits(t, w, hid, torch.float32)
    splits16 = bm._wgrad_splits(t, w, hid, torch.bfloat16)
    rows = -(-(-(-t // splits32)) // 64) * 64  # the kernel's k_per_split
    assert rows <= bm.WGRAD_F32_MAX_ROWS or splits32 == 1 and t <= bm.WGRAD_F32_MAX_ROWS
    assert 1 <= splits16 <= splits32 <= 65535
    tiles = (w // 128) * (hid // 128)
    assert splits16 == max(1, min(-(-bm.WGRAD_BLOCKS // tiles), t // 512))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (T or (B, S), width, hidden, act)
CUDA_SHAPES = [((3, 197), 768, 3072, "quick_gelu"), ((150,), 128, 512, "gelu"),
               ((2, 257), 1024, 4096, "gelu"), ((256,), 512, 2048, "quick_gelu"),
               ((3, 61), 640, 2560, "gelu"), ((61,), 1408, 1536, "quick_gelu"),
               # the bfloat16 GEMM's edges: T = 1, one short of and one past its 128-row tiles
               # and 64-row K-steps, and around a weight-gradient split (W = H = 128: T // 512
               # splits; 4609 leaves the last one row, 5121 a split with none)
               ((1,), 128, 128, "quick_gelu"), ((63,), 512, 128, "gelu"),
               ((65,), 512, 3072, "quick_gelu"), ((127,), 768, 3072, "quick_gelu"),
               ((129,), 1024, 3072, "gelu"), ((4609,), 128, 128, "gelu"),
               ((5121,), 128, 128, "quick_gelu")]


def _cuda_args(tokens, w, hid, dtype, device):
    t = int(np.prod(tokens))
    (x, gamma, beta, w1, b1, w2, b2), dy = _leaves((t, w), hid, dtype, device)
    return [a.detach() for a in (x, gamma, beta, w1, b1, w2, b2)], dy


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tokens,w,hid,act", CUDA_SHAPES)
def test_cuda_fwd_kernel_matches_plain(cuda_device, tokens, w, hid, act, dtype, tol, residual):
    args, _ = _cuda_args(tokens, w, hid, dtype, cuda_device)
    launches.reset_launch_counts()
    got = bm.block_mlp_fwd(*args, act=act, residual=residual)
    torch.cuda.synchronize()
    assert launches.launch_counts()["block_mlp_fwd"] == 1
    want = bm.block_mlp_reference(*args, act=act, residual=residual)
    for name, g, r in zip(("y", "h"), got, want):
        err = (g.float() - r.float()).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.float().abs().max().item(), (name, err)


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("tokens,w,hid,act", CUDA_SHAPES)
def test_cuda_bwd_kernel_matches_plain(cuda_device, tokens, w, hid, act, dtype, tol, residual):
    (x, gamma, beta, w1, b1, w2, b2), dy = _cuda_args(tokens, w, hid, dtype, cuda_device)
    _, h = bm.block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act, residual=residual)
    launches.reset_launch_counts()
    got = bm.block_mlp_bwd(x, dy, h, gamma, beta, w1, w2, act=act, residual=residual)
    torch.cuda.synchronize()
    assert launches.launch_counts()["block_mlp_bwd"] == 1
    want = bm.block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2, act=act, residual=residual)
    for name, g, r in zip(("dx", "dw1", "dw2", "db1", "db2", "dgamma", "dbeta"), got, want):
        g, r = g.float(), r.float()
        err = (g - r).abs().max().item()
        assert torch.isfinite(g).all() and err <= tol * r.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_cuda_backward_runs_the_kernels_and_repeats(cuda_device):
    """loss.backward() on the card goes through both kernels, agrees with the same Function
    on the CPU, and gives the same bits when run again (no float atomics)."""
    runs = {}
    for key, dev in (("cpu", "cpu"), ("cuda", cuda_device), ("again", cuda_device)):
        launches.reset_launch_counts()
        runs[key] = _port_run((3, 197, 256), 1024, "quick_gelu", True, torch.float32, device=dev)
        counts = launches.launch_counts()
    assert counts["block_mlp_fwd"] == 1 and counts["block_mlp_bwd"] == 1
    for name, g, again, r in zip(NAMES, runs["cuda"][1], runs["again"][1], runs["cpu"][1]):
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(g, r, atol=2e-4 * scale, rtol=2e-3, err_msg=name)
        np.testing.assert_array_equal(g, again, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_repeat_bit_for_bit(cuda_device, dtype):
    """No float atomics, one owner and a fixed order for every sum: a second launch of each
    kernel gives the same bits, every output, at T = 3 x 197 (a ragged last tile and split)."""
    (x, gamma, beta, w1, b1, w2, b2), dy = _cuda_args((3, 197), 768, 3072, dtype, cuda_device)
    fwd = lambda: bm.block_mlp_fwd(x, gamma, beta, w1, b1, w2, b2)  # noqa: E731
    for a, b in zip(fwd(), fwd()):
        assert torch.equal(a, b)
    h = fwd()[1]
    bwd = lambda: bm.block_mlp_bwd(x, dy, h, gamma, beta, w1, w2)  # noqa: E731
    for a, b in zip(bwd(), bwd()):
        assert torch.equal(a, b)
