"""The block-attention operator's weight gradients in the PyTorch port: the split walk
(``attn_wgrad_walk``, the arithmetic of the bfloat16 weight-gradient kernel in plain torch: f32
products over splits of the token rows, summed in split order, rounded once) and its planner
(``wgrad_plan``) against the JAX package's ``_attn_wgrad``; the bias sums without a widened copy
against the reference's ``jnp.sum(dz.astype(f32), axis=(0, 1))``; the whole bfloat16 backward of
``BlockAttention`` and ``BlockAttentionLN`` on the CPU against ``jax.vjp`` of the JAX operator
(``_block_attention_bwd``, ``_block_attention_ln_bwd``, its Pallas kernels in interpret mode),
all eight weight and bias gradients; and, on the card, the kernel against the split walk.

Tolerances. bfloat16 within 2e-2 x max(1, max|reference|), the block tests' limit: both sides sum
in f32 and round once, in another order. float32 within 3e-4 x max(1, max|reference|) and rtol
1e-3, the JAX package's own VJP test (tests/test_block_attention.py). On the card the kernel
against the split walk: 2e-2 x max|walk|, and a second launch the same bits.

JAX is imported inside the helpers, so the CUDA cases also run where JAX is absent:
    python -m pytest tests/test_torch_block_attention_wgrad.py -m cuda
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu_torch.ops import block_attention as ba
from multimodal_tpu_torch.ops import launches

torch.set_num_threads(1)

NAMES = ["dx", "dwq", "dbq", "dwk", "dbk", "dwv", "dbv", "dwo", "dbo"]
LN_NAMES = ["dx", "dgamma", "dbeta"] + NAMES[1:]
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LIMITS = {"bfloat16": (2e-2, 0.0), "float32": (3e-4, 1e-3)}  # (atol x max(1, max|ref|), rtol)
WIDTHS = [256, 512, 768]
RAGGED = [(3, 50), (2, 77)]  # T = 150 and 154: no multiple of the 64-row K-step


def _operands(b, s, w, seed=0):
    """a, dq, dk, dv, attnpre, dy: [B, S, W] float32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, w), dtype=np.float32) for _ in range(6)]


def _close(got, want, name, dtype_name):
    rel, rtol = LIMITS[dtype_name]
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=rtol, err_msg=name)


@functools.lru_cache(maxsize=None)
def _jax_wgrads(b, s, w, dtype_name):
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_attention import _attn_wgrad

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    a, dq, dk, dv, attnpre, dy = (jnp.asarray(t, dt) for t in _operands(b, s, w))
    return [np.asarray(_attn_wgrad(lhs, rhs, dt).astype(jnp.float32))
            for lhs, rhs in ((a, dq), (a, dk), (a, dv), (attnpre, dy))]


def _port_operands(b, s, w, dtype):
    return [torch.from_numpy(t).to(dtype) for t in _operands(b, s, w)]


# ----------------------------------------------------------------------------- (a) the split walk
@pytest.mark.parametrize("splits", [1, 2, None], ids=["one", "two", "planned"])
@pytest.mark.parametrize("b,s", RAGGED)
@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_split_walk_matches_jax_attn_wgrad(dtype_name, w, b, s, splits):
    """dWq, dWk, dWv, dWo of the split walk (one split, two, the planner's) against the JAX
    package's ``_attn_wgrad`` on the same numpy operands, at a ragged T."""
    got = ba.attn_wgrad_walk(*_port_operands(b, s, w, DTYPES[dtype_name]), DTYPES[dtype_name],
                             splits=splits)
    for name, g, r in zip(("dwq", "dwk", "dwv", "dwo"), got, _jax_wgrads(b, s, w, dtype_name)):
        assert g.dtype == DTYPES[dtype_name] and g.shape == (w, w)
        _close(g, r, name, dtype_name)


def test_split_walk_sums_every_split_in_order():
    """Three splits of T = 150 at 64 rows: the walk's result is ((p0 + p1) + p2) rounded once, the
    kernel's order, and not the one-product form's bits."""
    ops = _port_operands(3, 50, 256, torch.bfloat16)
    a, dq = (t.reshape(150, 256).float() for t in ops[:2])
    parts = [a[r:r + 64].T @ dq[r:r + 64] for r in (0, 64, 128)]
    want = ((parts[0] + parts[1]) + parts[2]).to(torch.bfloat16)
    got = ba.attn_wgrad_walk(*ops, torch.bfloat16, splits=3)[0]
    assert ba.wgrad_plan(150, 256, 3) == (3, 64)
    assert torch.equal(got, want)


# ----------------------------------------------------------------------------- (b) the planner
PLAN_SHAPES = [(1, 128), (63, 256), (64, 256), (65, 384), (150, 256), (154, 512), (640, 768),
               (12800, 768), (19712, 512), (19712, 768), (50432, 768), (37120, 768), (514, 1408)]


@pytest.mark.parametrize("splits", [None, 1, 2, 3, 7, 11, 10 ** 6])
@pytest.mark.parametrize("tokens,width", PLAN_SHAPES)
def test_plan_covers_the_rows_in_k_steps(tokens, width, splits):
    """The splits cover T exactly, every split but the last a multiple of the 64-row K-step, the
    last holding at least one row; never more splits than asked for; the same plan twice."""
    n, rows = ba.wgrad_plan(tokens, width, splits)
    assert n >= 1 and rows % ba.WGRAD_K_STEP == 0 and rows > 0
    assert (n - 1) * rows < tokens <= n * rows
    if splits is not None:
        assert n <= splits
    assert ba.wgrad_plan(tokens, width, splits) == (n, rows)


@pytest.mark.parametrize("tokens,width", PLAN_SHAPES)
def test_plan_is_the_least_cost_split_count(tokens, width):
    """The planner's own count is the one of least ``wgrad_cost`` (the fewest on a tie) among
    1..``WGRAD_MAX_SPLITS``, and that cost is the rounds of 132 tiles times a split's rows plus
    ``WGRAD_SPLIT_ROWS`` a split."""
    n, rows = ba.wgrad_plan(tokens, width)
    costs = {k: ba.wgrad_cost(tokens, width, k) for k in range(1, ba.WGRAD_MAX_SPLITS + 1)}
    assert costs[n] == min(costs.values())
    assert all(costs[k] > costs[n] for k in range(1, n))
    tiles = ba.wgrad_tiles(width)
    assert tiles == 4 * (width // 128) * -(-width // 256)
    assert costs[n] == (-(-n * tiles // ba.WGRAD_SMS) * min(rows, tokens)
                        + ba.WGRAD_SPLIT_ROWS * n)


@pytest.mark.parametrize("tokens,width,splits", [
    (256 * 50, 768, 3), (256 * 77, 512, 4), (256 * 77, 768, 3), (32 * 20, 768, 1),
    (64 * 257, 1024, 1), (3 * 50, 256, 1)])
def test_plan_picks_the_measured_split_counts(tokens, width, splits):
    """At the shapes whose split counts were swept on the H100 (PERF.md), the plan takes the
    fastest count the sweep found."""
    assert ba.wgrad_plan(tokens, width)[0] == splits


# ----------------------------------------------------------------------------- (c) the bias sums
@pytest.mark.parametrize("b,s,w", [(3, 50, 256), (2, 77, 512), (4, 197, 768)])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float32"])
def test_bias_sum_matches_the_reference_sum(dtype_name, b, s, w):
    """``_bias_sum`` (dz read as it lies, summed in f32) against the reference's
    ``jnp.sum(dz.astype(f32), axis=(0, 1)).astype(dtype)``, and against the widened plain form."""
    import jax.numpy as jnp

    dt = jnp.float32 if dtype_name == "float32" else jnp.bfloat16
    dz = _operands(b, s, w, seed=3)[0]
    want = np.asarray(jnp.sum(jnp.asarray(dz, dt).astype(jnp.float32), axis=(0, 1)).astype(dt)
                      .astype(jnp.float32))
    got = ba._bias_sum(torch.from_numpy(dz).to(DTYPES[dtype_name]), DTYPES[dtype_name])
    assert got.dtype == DTYPES[dtype_name] and got.shape == (w,)
    _close(got, want, "bias", dtype_name)
    plain = ba._bias_grad(torch.from_numpy(dz).to(DTYPES[dtype_name]), DTYPES[dtype_name])
    _close(got, plain.float().numpy(), "bias vs plain", dtype_name)


# ----------------------------------------------------------------------------- dispatch
def test_attn_wgrad_on_the_cpu_is_the_plain_product():
    """On a CPU tensor ``attn_wgrad`` is ``_attn_wgrad`` for each product, bit for bit, and
    launches nothing; ``_param_grads`` there is the plain products and the widened sums."""
    ops = _port_operands(3, 50, 256, torch.bfloat16)
    launches.reset_launch_counts()
    got = ba.attn_wgrad(*ops, torch.bfloat16)
    assert launches.launch_counts()["block_attention_wgrad"] == 0
    a, dq, dk, dv, attnpre, dy = ops
    for g, (lhs, rhs) in zip(got, ((a, dq), (a, dk), (a, dv), (attnpre, dy))):
        assert torch.equal(g, ba._attn_wgrad(lhs, rhs, torch.bfloat16))
    wb = [torch.zeros(256, 256, dtype=torch.bfloat16), torch.zeros(256, dtype=torch.bfloat16)] * 4
    grads = ba._param_grads(a, dq, dk, dv, attnpre, dy, *wb)
    assert all(torch.equal(x, y) for x, y in zip(grads[::2], got))
    for g, dz in zip(grads[1::2], (dq, dk, dv, dy)):
        assert torch.equal(g, ba._bias_grad(dz, torch.bfloat16))


def test_attn_wgrad_refuses_another_device():
    ops = [torch.empty(150, 256, dtype=torch.bfloat16, device="meta") for _ in range(6)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ba.attn_wgrad(*ops, torch.bfloat16)


# ----------------------------------------------------------------------------- (d) whole backward
def _block_inputs(b, s, w, seed=0):
    """x, the eight weights and biases, gamma, beta and a cotangent dy, as float32 numpy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, w), dtype=np.float32)
    ws = []
    for _ in range(4):
        ws.append(rng.standard_normal((w, w), dtype=np.float32) * w ** -0.5)
        ws.append(rng.standard_normal((w,), dtype=np.float32) * 0.02)
    gamma = 1 + 0.1 * rng.standard_normal(w, dtype=np.float32)
    beta = 0.1 * rng.standard_normal(w, dtype=np.float32)
    dy = rng.standard_normal((b, s, w), dtype=np.float32)
    return x, ws, gamma, beta, dy


@functools.lru_cache(maxsize=None)
def _jax_block_grads(b, s, w, heads, causal, ln):
    import jax
    import jax.numpy as jnp

    from multimodal_tpu.ops.block_attention import block_attention

    x, ws, gamma, beta, dy = _block_inputs(b, s, w)
    bf = lambda t: jnp.asarray(t, jnp.bfloat16)  # noqa: E731
    if ln:
        fn = lambda x_, g_, b_, *p: block_attention(  # noqa: E731
            x_, *p, heads=heads, causal=causal, ln_scale=g_, ln_bias=b_, residual=True)
        args = [bf(x), bf(gamma), bf(beta), *(bf(t) for t in ws)]
    else:
        fn = lambda *a: block_attention(*a, heads=heads, causal=causal)  # noqa: E731
        args = [bf(x), *(bf(t) for t in ws)]
    _, vjp = jax.vjp(fn, *args)
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(bf(dy))]


@pytest.mark.parametrize("b,s,w,heads,causal,ln", [
    (3, 50, 256, 4, False, False), (2, 77, 512, 8, True, False), (2, 145, 256, 4, False, True)],
    ids=["vision-like", "text-like", "ln-S145"])
def test_bf16_backward_matches_jax_every_gradient(b, s, w, heads, causal, ln):
    """loss.backward() through ``BlockAttention`` (S <= 128) or ``BlockAttentionLN`` (S = 145, the
    LayerNorm and the residual folded) in bfloat16 on the CPU against ``jax.vjp`` of the JAX
    operator: dx (and dgamma, dbeta) and all eight weight and bias gradients."""
    x, ws, gamma, beta, dy = _block_inputs(b, s, w)
    bf = lambda t: torch.from_numpy(t).to(torch.bfloat16).requires_grad_()  # noqa: E731
    leaves = [bf(x)] + ([bf(gamma), bf(beta)] if ln else []) + [bf(t) for t in ws]
    if ln:
        y = ba.block_attention(leaves[0], *leaves[3:], heads=heads, causal=causal,
                               ln_scale=leaves[1], ln_bias=leaves[2], residual=True)
    else:
        y = ba.block_attention(*leaves, heads=heads, causal=causal)
    y.backward(torch.from_numpy(dy).to(torch.bfloat16))
    want = _jax_block_grads(b, s, w, heads, causal, ln)
    names = LN_NAMES if ln else NAMES
    assert len(want) == len(leaves) == len(names)
    for name, leaf, r in zip(names, leaves, want):
        # the key-bias gradient is zero in exact arithmetic: both sides hold rounding noise,
        # summed over every row; it is held on the scale of the query-bias gradient
        scale = float(np.abs(want[names.index("dbq")]).max()) if name == "dbk" else 1.0
        rel, _ = LIMITS["bfloat16"]
        np.testing.assert_allclose(leaf.grad.float().numpy(), r,
                                   atol=rel * max(scale, float(np.abs(r).max())), err_msg=name)


# ----------------------------------------------------------------------------- (e) on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


CUDA_SHAPES = [(150, 256), (154, 512), (150, 768), (640, 768), (448, 256), (514, 1024),
               (514, 1408), (12800, 768), (19712, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("tokens,width", CUDA_SHAPES)
def test_cuda_wgrad_kernel_matches_the_split_walk(cuda_device, tokens, width, splits):
    """The kernel against its split walk on the same bf16 operands, every product within 2e-2 x
    max|walk|; a second launch the same bits; one count a call."""
    g = torch.Generator(device=cuda_device).manual_seed(tokens + width)
    ops = [torch.randn(tokens, width, generator=g, device=cuda_device).to(torch.bfloat16)
           for _ in range(6)]
    launches.reset_launch_counts()
    got = ba.attn_wgrad(*ops, torch.bfloat16, splits=splits)
    again = ba.attn_wgrad(*ops, torch.bfloat16, splits=splits)
    torch.cuda.synchronize()
    assert launches.launch_counts()["block_attention_wgrad"] == 2
    want = ba.attn_wgrad_walk(*ops, torch.bfloat16, splits=splits)
    for name, k, k2, r in zip(("dwq", "dwk", "dwv", "dwo"), got, again, want):
        assert k.dtype == torch.bfloat16 and k.shape == (width, width)
        assert torch.equal(k, k2), name
        err, ref = (k.float() - r.float()).abs().max().item(), r.float().abs().max().item()
        assert torch.isfinite(k.float()).all() and err <= 2e-2 * ref, (name, err, ref)


@pytest.mark.cuda
def test_cuda_wgrad_refuses_what_it_does_not_take(cuda_device):
    ops = [torch.zeros(150, 256, dtype=torch.bfloat16, device=cuda_device) for _ in range(6)]
    with pytest.raises(TypeError):
        ba.attn_wgrad(*ops, torch.float32)
    with pytest.raises(TypeError):
        ba.attn_wgrad(*(t.float() for t in ops), torch.bfloat16)
    with pytest.raises(ValueError):
        ba.attn_wgrad(*(t[:, :192] for t in ops), torch.bfloat16)
    with pytest.raises(ValueError):
        ba.attn_wgrad(ops[0], ops[1].t(), *ops[2:], torch.bfloat16)


class _MatmulShapes:
    """The operand shapes of every aten mm / matmul dispatched while active, and the name of
    every op, the backward's included (autograd hands its thread-local dispatch modes to its
    worker threads; ``ops`` shows that it did)."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        shapes, ops = self.shapes, self.ops = [], []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                ops.append(func.overloadpacket.__name__)
                if func.overloadpacket in (torch.ops.aten.mm, torch.ops.aten.matmul):
                    shapes.append([list(a.shape) for a in args[:2]])
                return func(*args, **(kwargs or {}))

        self.mode = Mode()


def test_matmul_shapes_see_the_plain_products_of_a_cpu_backward():
    """The recorder the card's test relies on: on the CPU the plain backward's weight gradients
    are [W, T] x [T, W] products, and it sees them."""
    b, s, w, heads = 3, 50, 256, 4
    x, ws, _, _, dy = _block_inputs(b, s, w, seed=4)
    leaves = [torch.from_numpy(t).to(torch.bfloat16).requires_grad_() for t in [x, *ws]]
    y = ba.block_attention(*leaves, heads=heads)
    rec = _MatmulShapes()
    with rec.mode:
        y.backward(torch.from_numpy(dy).to(torch.bfloat16))
    assert sum(shapes == [[w, b * s], [b * s, w]] for shapes in rec.shapes) == 4, rec.shapes


@pytest.mark.cuda
@pytest.mark.parametrize("ln", [False, True])
def test_cuda_bf16_backward_runs_the_wgrad_kernel(cuda_device, ln):
    """A bfloat16 backward on the card launches the weight-gradient kernel once and no
    [W, T] x [T, W] matrix product, and its eight weight and bias gradients agree with the plain
    versions on the CPU (``_param_grads``) over the same per-token gradients: the card's backward
    kernel run on the same inputs (it gives the same bits every launch), copied over."""
    b, s, w, heads = (2, 145, 256, 4) if ln else (3, 50, 256, 4)
    x, ws, gamma, beta, dy = _block_inputs(b, s, w, seed=4)
    bf = lambda t: torch.from_numpy(t).to(cuda_device, torch.bfloat16)  # noqa: E731
    x, dy, gamma, beta, ws = bf(x), bf(dy), bf(gamma), bf(beta), [bf(t) for t in ws]
    if ln:
        outs = ba.block_attention_ln_bwd(x, dy, gamma, beta, *ws, heads=heads, residual=True)
        a = outs[5]
    else:
        outs = ba.block_attention_bwd(x, dy, *ws, heads=heads)
        a = x
    leaves = [t.clone().requires_grad_() for t in ws]
    kw = dict(ln_scale=gamma, ln_bias=beta, residual=True) if ln else {}
    y = ba.block_attention(x.clone().requires_grad_(), *leaves, heads=heads, **kw)
    launches.reset_launch_counts()
    rec = _MatmulShapes()
    with rec.mode:
        y.backward(dy)
    torch.cuda.synchronize()
    counts = launches.launch_counts()
    assert counts["block_attention_wgrad"] == 1
    assert counts["block_attention_ln_bwd" if ln else "block_attention_bwd"] == 1
    t = b * s
    assert "sum" in rec.ops, rec.ops  # the bias sums: the recorder saw the backward's ops
    assert [w, t] not in [shapes[0] for shapes in rec.shapes], rec.shapes
    cpu = lambda v: v.detach().cpu()  # noqa: E731
    want = ba._param_grads(cpu(a), *(cpu(v) for v in outs[1:5]), cpu(dy), *(cpu(v) for v in ws))
    for name, leaf, r in zip(NAMES[1:], leaves, want):
        g, r = leaf.grad.float().cpu(), r.float()
        scale = max(1.0, r.abs().max().item())
        torch.testing.assert_close(g, r, atol=2e-2 * scale, rtol=0, msg=name)
