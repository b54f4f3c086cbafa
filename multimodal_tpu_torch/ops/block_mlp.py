"""The MLP half of a pre-LN residual block as one differentiable operator:
``y = x + act(LN(x) @ W1 + b1) @ W2 + b2`` with the LayerNorm, the activation and the
residual add inside it.

Port of ``multimodal_tpu/ops/block_mlp.py``: ``block_mlp`` and its custom VJP. ``BlockMLP``
is a ``torch.autograd.Function`` that saves x, gamma, beta, W1, W2 and the pre-activation
``h`` (when nothing asks for a gradient autograd keeps no node, so ``h`` is freed with the
call). On a CUDA tensor its forward and backward launch the hand-written Hopper kernels
(``ops/csrc/block_mlp.cu``) and nothing else; on a CPU tensor they run
``block_mlp_reference`` and ``block_mlp_bwd_reference``, the plain PyTorch versions of the
same math, which are also what the on-card comparison holds the kernels to. The operator is
opt-in (``MLP(block_mlp=True)``, ``create_model(..., block_mlp=True)``), as it is in the
reference.

Numerics kept from the TPU kernels, where the plain ``MLP`` rounds differently: ``h`` is the
f32 sum plus the f32 bias rounded once; the activation is evaluated in f32 from the rounded
``h`` and rounded; ``g @ W2 + b2 + x`` is one f32 sum rounded once. The backward rebuilds
LN(x) as ``round(xhat32) * gamma + beta`` from the f32 ``xhat32 = (x32 - mean) * inv`` (in
bfloat16 not bit for bit the forward's), rounds ``dh`` before the two products that read it
but sums ``db1`` from the unrounded values, and forms dx, dgamma and dbeta in f32 with the
f32 gamma (see ``block_mlp_bwd_reference``). On the card every product runs a tensor-core
GEMM: bfloat16 the ``wgmma`` GEMM fed by TMA (``ops/csrc/wgmma_gemm.cuh``, the activation and
its derivative on the special-function unit, a few f32 ulp from the plain version's before the
bf16 rounding), float32 3xTF32 on ``mma.sync`` (about 2^-20 relative a product); c_fc's store
writes g beside h to a scratch that c_proj reads, by the same device code that forms g again in
the backward's dW2, so the two g are the same bits.
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.ops import launches
from multimodal_tpu_torch.ops.block_attention import LN_EPS, _acc, _ln_stats, ln_rows

ACTS = ("quick_gelu", "gelu")
_SQRT_2_OVER_PI = 0.7978845608028654
_GELU_C = 0.044715
# blocks the backward's weight-gradient launches aim for, counted in 128 x 128 output tiles
# (python -m multimodal_tpu_torch.bench_block_mlp: the best at every B=256 shape in bfloat16 on
# the wgmma GEMM, ViT-L/14's B=64 within 7% of its best; float32 within 0.5% at every target)
WGRAD_BLOCKS = 8 * 132
# token rows one float32 weight-gradient split may sum: the tensor cores' float32 accumulation
# loses a little with every add, so the error of one partial grows with its rows (1.1e-5 x
# max|plain| at 896 rows, 1.07e-4 at 12,800 on the H100, over the 1e-4 limit)
WGRAD_F32_MAX_ROWS = 2048

launches.register("block_mlp_fwd", "block_mlp_bwd")


def block_mlp_supported(width: int, hidden: int, act: str) -> bool:
    return width % 128 == 0 and hidden % 128 == 0 and act in ACTS


def act_fwd(h: torch.Tensor, act: str) -> torch.Tensor:
    """The activation on the pre-activation, in h's dtype: quick_gelu or tanh-gelu."""
    if act == "quick_gelu":
        return h * torch.sigmoid(1.702 * h)
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    return 0.5 * h * (1.0 + torch.tanh(u))


def act_bwd(h: torch.Tensor, act: str) -> torch.Tensor:
    """d(act)/dh at the pre-activation."""
    if act == "quick_gelu":
        s = torch.sigmoid(1.702 * h)
        return s + h * 1.702 * s * (1.0 - s)
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * h * h)
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du


def block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, *, act: str = "quick_gelu",
                        residual: bool = True):
    """Plain PyTorch version of the forward kernel: (y [T,W], h [T,H]) for x [T,W], W1
    [W,H], W2 [H,W] ([in,out]), step by step with the TPU kernel's rounding points."""
    dt, f32 = x.dtype, _acc(x.dtype)
    ln = ln_rows(x, gamma, beta, LN_EPS)
    h = (ln.to(f32) @ w1.to(f32) + b1.to(f32)).to(dt)
    g = act_fwd(h.to(f32), act).to(dt)
    y = g.to(f32) @ w2.to(f32) + b2.to(f32)
    if residual:
        y = y + x.to(f32)
    return y.to(dt), h


def block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2, *, act: str = "quick_gelu",
                            residual: bool = True):
    """Plain PyTorch version of the backward kernel: (dx [T,W], dW1 [W,H], dW2 [H,W]) in
    x.dtype and (db1 [H], db2, dgamma, dbeta [W]) in f32.

    Step by step the TPU kernel's ``_bwd_kernel``: the LN statistics recomputed in f32;
    ln = round(xhat32) * gamma + beta in x.dtype from the f32 xhat32; g = act(h32) rounded;
    dg = dy W2^T in f32; dh32 = dg act'(h32); dh = round(dh32) feeds dln = dh W1^T (f32) and
    dW1 = ln^T dh; dW2 = g^T dy; db1 sums the unrounded dh32; dx is the LN vjp in f32 with
    the f32 gamma, plus dy with ``residual``, rounded once. The weight gradients are f32
    sums rounded to x.dtype, as the reference casts them to the weights' dtype."""
    dt, f32 = x.dtype, _acc(x.dtype)
    mean, inv = _ln_stats(x, LN_EPS)
    x32, dy32, h32 = x.to(f32), dy.to(f32), h.to(f32)
    xhat = (x32 - mean) * inv
    ln = xhat.to(dt) * gamma.to(dt) + beta.to(dt)
    g = act_fwd(h32, act).to(dt)
    dg = dy32 @ w2.to(f32).T
    dh32 = dg * act_bwd(h32, act)
    dh = dh32.to(dt).to(f32)
    dln = dh @ w1.to(f32).T
    dw1 = (ln.to(f32).T @ dh).to(dt)
    dw2 = (g.to(f32).T @ dy32).to(dt)
    db1, db2 = dh32.sum(dim=0), dy32.sum(dim=0)
    dgamma, dbeta = (dln * xhat).sum(dim=0), dln.sum(dim=0)
    dxhat = dln * gamma.to(f32)
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True))
    if residual:
        dx = dx + dy32
    return dx.to(dt), dw1, dw2, db1, db2, dgamma, dbeta


def _check_kernel_operands(x, w1, w2, act: str, *, rows_w=(), rows_h=(), vecs_w=(), vecs_h=()):
    """What the CUDA kernels take: x [T,W] float32 or bfloat16, W1 [W,H], W2 [H,W], further
    [T,W] and [T,H] tensors and [W] and [H] vectors, all of x's dtype and device, contiguous
    and 16-byte aligned, at a supported shape. Raises otherwise."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_mlp kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"block_mlp kernel takes x [T, W] and w1 [W, H], got "
                         f"{tuple(x.shape)} and {tuple(w1.shape)}")
    t, w = x.shape
    hid = w1.shape[1]
    if t < 1 or not block_mlp_supported(w, hid, act):
        raise ValueError(f"block_mlp kernel does not take T={t} W={w} H={hid} act={act!r}")
    expected = [(x, (t, w)), (w1, (w, hid)), (w2, (hid, w))]
    for group, shape in ((rows_w, (t, w)), (rows_h, (t, hid)), (vecs_w, (w,)), (vecs_h, (hid,))):
        expected += [(tensor, shape) for tensor in group]
    for tensor, shape in expected:
        if tensor.device != x.device or tensor.dtype != x.dtype or tuple(tensor.shape) != shape:
            raise ValueError(
                f"block_mlp operand {tuple(tensor.shape)} {tensor.dtype} on {tensor.device}: "
                f"expected {shape} {x.dtype} on {x.device}")
        if not tensor.is_contiguous() or tensor.data_ptr() % 16:
            raise ValueError("block_mlp operands must be contiguous and 16-byte aligned")


def _block_mlp_fwd_cuda(x, gamma, beta, w1, b1, w2, b2, *, act: str, residual: bool):
    from multimodal_tpu_torch.ops import _build

    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    _check_kernel_operands(x, w1, w2, act, vecs_w=(gamma, beta, b2), vecs_h=(b1,))
    t, w = x.shape
    hid = w1.shape[1]
    lib = _build.load()
    ln_stats = torch.empty((2, t), dtype=torch.float32, device=x.device)
    g = torch.empty((t, hid), dtype=x.dtype, device=x.device)  # act(h), read by c_proj
    h = torch.empty_like(g)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_mlp_fwd(
            0 if x.dtype == torch.float32 else 1,
            *(a.data_ptr() for a in (x, gamma, beta, w1, b1, w2, b2, ln_stats, g, h, y)),
            t, w, hid, ACTS.index(act), int(residual), LN_EPS, stream)
    _build.check(lib, err, "block_mlp_fwd launch")
    launches.count("block_mlp_fwd")
    return y, h


def _wgrad_splits(t: int, w: int, hid: int, dtype: torch.dtype) -> int:
    """Into how many runs of token rows the backward kernel splits its two weight-gradient
    products: enough blocks (output tiles x splits) for about ``WGRAD_BLOCKS`` over the card's
    132 SMs, so that the last round's idle SMs cost little, with at least 512 rows to a split;
    in float32 also at most ``WGRAD_F32_MAX_ROWS`` rows to a split."""
    tiles = (w // 128) * (hid // 128)
    splits = max(1, min(-(-WGRAD_BLOCKS // tiles), t // 512))
    if dtype == torch.float32:
        splits = max(splits, -(-t // WGRAD_F32_MAX_ROWS))
    return splits


def _block_mlp_bwd_cuda(x, dy, h, gamma, beta, w1, w2, *, act: str, residual: bool):
    from multimodal_tpu_torch.ops import _build

    gamma32 = gamma.to(torch.float32).contiguous()
    gamma, beta = gamma.to(x.dtype), beta.to(x.dtype)
    _check_kernel_operands(x, w1, w2, act, rows_w=(dy,), rows_h=(h,), vecs_w=(gamma, beta))
    t, w = x.shape
    hid = w1.shape[1]
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=x.device)
    ln_stats = torch.empty((2, t), **f32)
    dh = torch.empty_like(h)  # round(dh32), read by the dln and dW1 products
    dln = torch.empty((t, w), **f32)
    dx = torch.empty_like(x)
    # partial sums, each formed in a fixed order: one [W,H] and one [H,W] per split of the
    # token rows, one row per 128-token tile (db1) and per 32-token tile (dgamma, dbeta, db2)
    splits = _wgrad_splits(t, w, hid, x.dtype)
    dw1_part = torch.empty((splits, w, hid), **f32)
    dw2_part = torch.empty((splits, hid, w), **f32)
    db1_part = torch.empty((lib.mmt_block_mlp_db1_partial_rows(t), hid), **f32)
    col_part = torch.empty((3, lib.mmt_ln_bwd_partial_rows(t), w), **f32)
    with torch.cuda.device(x.device):
        # the stream autograd made current for this backward, never one cached earlier
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_mlp_bwd(
            0 if x.dtype == torch.float32 else 1,
            *(a.data_ptr() for a in (x, dy, h, gamma, beta, gamma32, w1, w2, ln_stats, dh, dln,
                                     dx, dw1_part, dw2_part, db1_part, col_part)),
            t, w, hid, ACTS.index(act), int(residual), splits, LN_EPS, stream)
    _build.check(lib, err, "block_mlp_bwd launch")
    launches.count("block_mlp_bwd")
    # the plain sums over the partials, the weight gradients rounded once
    dgamma, dbeta, db2 = col_part.sum(dim=1)
    return (dx, dw1_part.sum(dim=0).to(x.dtype), dw2_part.sum(dim=0).to(x.dtype),
            db1_part.sum(dim=0), db2, dgamma, dbeta)


def block_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, *, act: str = "quick_gelu",
                  residual: bool = True):
    """(y, h) of the operator over x [T,W]: on a CUDA tensor the forward kernel (a build or
    launch error raises), on a CPU tensor its plain version."""
    if x.is_cuda:
        return _block_mlp_fwd_cuda(x, gamma, beta, w1, b1, w2, b2, act=act, residual=residual)
    if x.device.type == "cpu":
        return block_mlp_reference(x, gamma, beta, w1, b1, w2, b2, act=act, residual=residual)
    raise ValueError(f"block_mlp runs on cuda or cpu tensors, not {x.device}")


def block_mlp_bwd(x, dy, h, gamma, beta, w1, w2, *, act: str = "quick_gelu",
                  residual: bool = True):
    """(dx, dW1, dW2, db1, db2, dgamma, dbeta) of the operator: on a CUDA tensor the backward
    kernel (a build or launch error raises), on a CPU tensor its plain version. dx, dW1 and
    dW2 come back in x.dtype, the four vector sums in f32."""
    if x.is_cuda:
        return _block_mlp_bwd_cuda(x, dy, h, gamma, beta, w1, w2, act=act, residual=residual)
    if x.device.type == "cpu":
        return block_mlp_bwd_reference(x, dy, h, gamma, beta, w1, w2, act=act,
                                       residual=residual)
    raise ValueError(f"block_mlp runs on cuda or cpu tensors, not {x.device}")


class BlockMLP(torch.autograd.Function):
    """The operator over x [T,W] with its gradient, as the reference's ``_block_mlp`` custom
    VJP: the forward saves x, gamma, beta, W1, W2 and the pre-activation h; the backward
    takes all seven gradients from the backward kernel (its plain version on a CPU tensor)
    and casts the vector sums to their parameters' dtypes."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w1, b1, w2, b2, act: str, residual: bool):
        y, h = block_mlp_fwd(x, gamma, beta, w1, b1, w2, b2, act=act, residual=residual)
        ctx.save_for_backward(x, gamma, beta, w1, w2, h)
        ctx.act, ctx.residual = act, residual
        ctx.bias_dtypes = b1.dtype, b2.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, w1, w2, h = ctx.saved_tensors
        dx, dw1, dw2, db1, db2, dgamma, dbeta = block_mlp_bwd(
            x, dy.contiguous(), h, gamma, beta, w1, w2, act=ctx.act, residual=ctx.residual)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype), dw1.to(w1.dtype),
                db1.to(ctx.bias_dtypes[0]), dw2.to(w2.dtype), db2.to(ctx.bias_dtypes[1]),
                None, None)


def block_mlp(x, w1, b1, w2, b2, *, ln_scale, ln_bias, act: str = "quick_gelu",
              residual: bool = True) -> torch.Tensor:
    """Fused pre-LN MLP residual branch: ``x + act(LN(x) @ w1 + b1) @ w2 + b2``.

    x: [B, S, W] or [T, W] (raw, pre-LN); w1 [W, H], w2 [H, W]; weights in x.dtype;
    ``ln_scale`` and ``ln_bias`` [W] in any float dtype (the blocks hand in their float32
    parameters). ``act``: "quick_gelu" (CLIP) or "gelu" (the tanh approximation). With
    ``residual=False`` returns the branch value alone. A CUDA tensor goes to the
    hand-written kernels, forward and backward (a build or launch error raises), a CPU
    tensor to their plain versions."""
    if act not in ACTS:
        raise ValueError(f"act must be one of {ACTS}")
    shape = x.shape
    y = BlockMLP.apply(x.reshape(-1, shape[-1]).contiguous(), ln_scale, ln_bias, w1, b1, w2, b2,
                       act, residual)
    return y.reshape(shape)
