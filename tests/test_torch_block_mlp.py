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


def _db1_partials_in_kernel_order(dh32: torch.Tensor) -> torch.Tensor:
    """The act' store's column sums of the unrounded dh32 [T, H], one row per 128-token tile,
    in the kernel's order: each lane (g = 0..7 of a row-warp's 64 rows) sums its rows g, g + 8,
    ..., g + 56 in order, a butterfly adds lane g ^ 1, g ^ 2, g ^ 4, then the two row-warps'
    sums are added. Rows past T are not summed."""
    t, hid = dh32.shape
    rows = []
    for m0 in range(0, t, 128):
        tile = torch.zeros(128, hid)
        tile[:min(128, t - m0)] = dh32[m0:m0 + 128]
        warps = []
        for wm in (0, 64):
            lanes = [functools.reduce(torch.add, [tile[wm + 16 * mt + g + 8 * h]
                                                  for mt in range(4) for h in range(2)])
                     for g in range(8)]
            for off in (1, 2, 4):
                lanes = [lanes[g] + lanes[g ^ off] for g in range(8)]
            warps.append(lanes[0])
        rows.append(warps[0] + warps[1])
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
    parts = _db1_partials_in_kernel_order(dh32)
    assert parts.shape == (2, 256)
    torch.testing.assert_close(parts.sum(0), db1, atol=1e-5, rtol=1e-5)
    assert (parts.sum(0) - dh32.bfloat16().float().sum(0)).abs().max() > 1e-3


def _tn_dw1(x, dh, gamma, beta, *, mask: bool, stale_b: bool) -> torch.Tensor:
    """dW1 = ln_b^T dh as the TN form walks it: K-steps of 64 token rows, one f32 sum. A tile:
    x's rows, zero past T, then the LN-b transform (xhat32 rounded, times gamma, plus beta,
    rounding to x.dtype) on the rows below T (``mask``) or on all 64 (statistics past T read
    as 0). B tile: dh's rows, past T zeros as cp.async writes them, or (``stale_b``) other
    values, as a tile would hold without that fill."""
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
               ((3, 61), 640, 2560, "gelu"), ((61,), 1408, 1536, "quick_gelu")]


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
