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
from multimodal_tpu_torch.ops.block_attention import LN_EPS, ln_rows

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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# (T or (B, S), width, hidden, act)
CUDA_SHAPES = [((3, 197), 768, 3072, "quick_gelu"), ((150,), 128, 512, "gelu"),
               ((2, 257), 1024, 4096, "gelu"), ((256,), 512, 2048, "quick_gelu")]


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
