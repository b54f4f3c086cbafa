"""Whole-block attention for short-to-medium sequences (S <= 320): QKV projections +
per-head softmax(QK^T)V + output projection in one differentiable operator, with the
pre-attention LayerNorm and the residual add folded in at S > 128.

Port of ``multimodal_tpu/ops/block_attention.py``: ``_block_attention`` and
``_block_attention_ln`` with their custom VJPs, and the dispatch of ``block_attention``.
``BlockAttention`` and ``BlockAttentionLN`` are ``torch.autograd.Function``s. On a CUDA
tensor their forwards launch the hand-written Hopper kernels
(``ops/csrc/block_attention_fwd.cu``) and their backwards the backward kernels
(``ops/csrc/block_attention_bwd.cu``), and nothing else; on a CPU tensor they run the plain
PyTorch versions of the same math (``block_attention[_ln][_bwd]_reference``), which are also
what the on-card comparison holds the kernels to. In bfloat16 the kernels' projections run
``ops/csrc/wgmma_gemm.cuh``'s ``wgmma`` GEMM fed by TMA, and their attention halves at head dims
32, 64 and 128 ``ops/csrc/fused_attention.cu``'s ``wgmma`` kernels (the forward core at S >= 128;
the backward's dQ and dK/dV in their block form, ``attention_half_reference``); in float32 the
projections run 3xTF32 on ``mma.sync`` (``mma_gemm.cuh``). The backward's four weight gradients
are whole-batch products outside the kernels, as the reference leaves them to XLA: in bfloat16 on
the card one launch of a ``wgmma`` kernel of their own (``attn_wgrad``: the bf16 operands as they
lie, f32 sums over splits of the token rows added in split order, one rounding), in float32 and
on the CPU ``torch.matmul`` in full float32 (``_attn_wgrad``). As in the reference, the LayerNorm is
folded into the kernel only at S > 128, where the [B,S,W] round trips it saves are large;
at S <= 128 it runs as the ``ln_rows`` pre-pass and the residual add after the operator,
both in torch's autograd.

Numerics kept from the TPU kernels: projections accumulate in f32 with the bias added in
f32 before one rounding to the compute dtype; logits and softmax in f32 with the finite
-1e30 causal mask (col <= row); probabilities and the attention output rounded to the
compute dtype before their next product; the backward rounds exactly where ``_bwd_kernel``
does (see ``block_attention_bwd_reference``). The folded LayerNorm takes f32 statistics,
casts them to the compute dtype and rounds after every operation (``ln_rows``); its
backward keeps the gradient of the LN output in f32 and applies the LN vjp in f32 with one
rounding (see ``block_attention_ln_bwd_reference``).
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.ops import launches

NEG_INF = -1e30
MAX_BLOCK_SEQ = 320
LN_FOLD_MIN_SEQ = 128  # the LayerNorm and the residual ride the kernel above this S
LN_EPS = 1e-5

# the weight-gradient kernel's plan (wgrad_plan): its blocks run one an SM on the card's 132, and
# every split adds about as much time as this many token rows of a tile's products (the serial
# store's chain: a split waits for the one before it, then reads and writes the running sum;
# fitted to a sweep of split counts on the H100, PERF.md)
WGRAD_SMS = 132
WGRAD_SPLIT_ROWS = 832
WGRAD_K_STEP = 64  # the kernel's K-step: every split but the last holds a multiple of it
WGRAD_MAX_SPLITS = 64

launches.register("block_attention_fwd", "block_attention_bwd",
                  "block_attention_ln_fwd", "block_attention_ln_bwd", "block_attention_wgrad")


def block_attn_supported(batch: int, seq: int, width: int, heads: int) -> bool:
    """The reference's dispatch rule: head_dim in {32, 64, 128} or an 8-multiple below 128,
    width a multiple of 128, S <= 320."""
    head_dim = width // heads
    dim_ok = head_dim in (32, 64, 128) or (head_dim % 8 == 0 and head_dim < 128)
    return dim_ok and width % 128 == 0 and seq <= MAX_BLOCK_SEQ


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: float32 for float32 and bfloat16 (float64 stays float64, so
    the plain versions can be gradient-checked)."""
    return torch.promote_types(dtype, torch.float32)


def _ln_stats(x: torch.Tensor, eps: float):
    """Row mean and rsqrt(var + eps) in f32, var = max(E[x^2] - mean^2, 0); each [..., 1]."""
    x32 = x.to(_acc(x.dtype))
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp(x32.square().mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


def ln_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """Row-wise LayerNorm with f32 statistics and compute-dtype arithmetic — the reference's
    ``_ln_rows``, which ``F.layer_norm`` does not reproduce in bf16: the mean and the inverse
    deviation are cast to x.dtype and every operation rounds."""
    mean, inv = _ln_stats(x, eps)
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return y * gamma.to(x.dtype) + beta.to(x.dtype)


def _proj(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., W] @ [W, N] + b with f32 accumulation and f32 bias, rounded to a.dtype."""
    f32 = _acc(a.dtype)
    return (a.to(f32) @ w.to(f32) + b.to(f32)).to(a.dtype)


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, W] -> [B, H, S, D]."""
    b, s, w = t.shape
    return t.view(b, s, heads, w // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, W]."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _probs(q: torch.Tensor, k: torch.Tensor, causal: bool) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) per head in f32 with the finite -1e30 causal mask, rounded
    to q.dtype. q, k: [B, H, S, D]."""
    s, d = q.shape[-2], q.shape[-1]
    f32 = _acc(q.dtype)
    logits = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * d ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def block_attention_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [B,S,W], weights [W,W] ([in,out]), biases [W]."""
    dt, f32 = x.dtype, _acc(x.dtype)
    q, k, v = (_split_heads(_proj(x, w_, b_), heads) for w_, b_ in ((wq, bq), (wk, bk), (wv, bv)))
    p = _probs(q, k, causal)
    attn = (p.to(f32) @ v.to(f32)).to(dt)
    return _proj(_merge_heads(attn), wo, bo)


def block_attention_ln_reference(x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, *,
                                 heads: int, causal: bool = False,
                                 residual: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the LN-fold forward kernel: attn(LN(x)), plus x with
    ``residual`` (the projection rounds to x.dtype first, the add rounds again)."""
    y = block_attention_reference(ln_rows(x, gamma, beta, LN_EPS), wq, bq, wk, bk, wv, bv, wo,
                                  bo, heads=heads, causal=causal)
    return y + x if residual else y


def attention_half_reference(q, k, v, do, *, heads: int, causal: bool):
    """The backward's attention half over the recomputed q, k, v and do = dy Wo^T ([B, S, W]
    in the compute dtype): (attnpre, dq, dk, dv), each [B, S, W] in that dtype.

    Step by step the TPU kernel's ``_bwd_kernel``, with its rounding points: p rounded (p32 is
    the rounded p widened); attnpre = p v and dv = p^T do, each rounded once; dp = do v^T in
    f32; ds = p32 (dp - rowsum(dp p32)) rounded; dq = (ds k) scale and dk = (ds^T q) scale,
    scaled in f32 before the rounding."""
    f32, dt = _acc(q.dtype), q.dtype
    scale = (q.shape[-1] // heads) ** -0.5
    q, k, v, do = (_split_heads(t, heads) for t in (q, k, v, do))
    p32 = _probs(q, k, causal).to(f32)
    q32, k32, v32, do32 = (t.to(f32) for t in (q, k, v, do))
    attnpre = (p32 @ v32).to(dt)
    dv = (p32.transpose(-1, -2) @ do32).to(dt)
    dp = do32 @ v32.transpose(-1, -2)
    ds32 = (p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))).to(dt).to(f32)
    dq = ((ds32 @ k32) * scale).to(dt)
    dk = ((ds32.transpose(-1, -2) @ q32) * scale).to(dt)
    return tuple(_merge_heads(t) for t in (attnpre, dq, dk, dv))


def _bwd_core(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, heads: int, causal: bool):
    """The backward up to the last product: (g, dq, dk, dv, attnpre) with g = d(x) still in
    f32, the per-token gradients in x.dtype.

    Step by step the TPU kernel's ``_bwd_kernel``, with its rounding points: q/k/v
    recomputed as in the forward; do = dy Wo^T accumulated in f32 and rounded; the attention
    half (``attention_half_reference``); g = dq Wq^T + dk Wk^T + dv Wv^T as ONE product over
    the concatenated [dq | dk | dv] and [Wq; Wk; Wv]^T."""
    f32, dt = _acc(x.dtype), x.dtype
    q, k, v = (_proj(x, w_, b_) for w_, b_ in ((wq, bq), (wk, bk), (wv, bv)))
    do = (dy.to(f32) @ wo.to(f32).T).to(dt)
    attnpre, dq, dk, dv = attention_half_reference(q, k, v, do, heads=heads, causal=causal)
    dqkv = torch.cat([dq, dk, dv], dim=-1).to(f32)
    wqkv_t = torch.cat([wq.T, wk.T, wv.T], dim=0).to(f32)  # [3W, W]
    return dqkv @ wqkv_t, dq, dk, dv, attnpre


def block_attention_bwd_reference(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                                  causal: bool = False):
    """Plain PyTorch version of the backward kernel: per-token (dx, dq, dk, dv, attnpre),
    each [B, S, W] in x.dtype; dx is ``_bwd_core``'s K = 3W product rounded once."""
    g, dq, dk, dv, attnpre = _bwd_core(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, heads, causal)
    return g.to(x.dtype), dq, dk, dv, attnpre


def block_attention_ln_bwd_reference(x, dy, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, *,
                                     heads: int, causal: bool = False, residual: bool = False):
    """Plain PyTorch version of the LN-form backward kernel: (dx, dq, dk, dv, attnpre,
    ln_out) in x.dtype and (dgamma, dbeta) [W] in f32.

    Step by step ``_bwd_kernel``'s LN branch: the LayerNorm recomputed as in the forward
    (f32 mean and inv kept) and emitted as ``ln_out``; ``_bwd_core`` on ln_out, whose
    product g = d(ln_out) stays in f32; xhat32 = (x32 - mean) inv in f32 (not the
    forward's compute-dtype xhat); dgamma = sum(g xhat32) and dbeta = sum(g) over every
    token; dx = inv (g gamma - mean(g gamma) - xhat32 mean(g gamma xhat32)) in f32, plus
    dy with ``residual``, rounded once."""
    f32, dt = _acc(x.dtype), x.dtype
    mean, inv = _ln_stats(x, LN_EPS)
    ln_out = (x - mean.to(dt)) * inv.to(dt) * gamma.to(dt) + beta.to(dt)
    g, dq, dk, dv, attnpre = _bwd_core(ln_out, dy, wq, bq, wk, bk, wv, bv, wo, bo, heads, causal)
    xhat32 = (x.to(f32) - mean) * inv
    dgamma, dbeta = (g * xhat32).sum(dim=(0, 1)), g.sum(dim=(0, 1))
    dxhat = g * gamma.to(f32)
    dx = inv * (dxhat - dxhat.mean(dim=-1, keepdim=True)
                - xhat32 * (dxhat * xhat32).mean(dim=-1, keepdim=True))
    if residual:
        dx = dx + dy.to(f32)
    return dx.to(dt), dq, dk, dv, attnpre, ln_out, dgamma, dbeta


def _check_kernel_operands(args, heads: int, ln: bool = False):
    """What the CUDA kernels take: (x, [dy,] [gamma, beta,] wq, bq, wk, bk, wv, bv, wo, bo)
    of one dtype (float32 or bfloat16) on one device, contiguous and 16-byte aligned (the
    kernels load 16 bytes at a time), at a supported shape. Raises otherwise, naming the
    operand."""
    x = args[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_attention kernel takes float32 or bfloat16, got {x.dtype}")
    b, s, w = x.shape
    if not block_attn_supported(b, s, w, heads):
        raise ValueError(f"block_attention kernel does not take B={b} S={s} W={w} H={heads}")
    n_ln = 2 if ln else 0
    n_act = len(args) - 8 - n_ln
    names = (("x", "dy")[:n_act] + ("gamma", "beta")[:n_ln]
             + ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo"))
    shapes = [(b, s, w)] * n_act + [(w,)] * n_ln + [(w, w), (w,)] * 4
    for name, t, shape in zip(names, args, shapes):
        if t.device != x.device or t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"block_attention operand {name} {tuple(t.shape)} {t.dtype} on {t.device}: "
                f"expected {shape} {x.dtype} on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"block_attention operand {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"block_attention operand {name} must be 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")


def _dtype_code(x: torch.Tensor) -> int:
    return 0 if x.dtype == torch.float32 else 1


def _qkv_scratch(x: torch.Tensor, qkv: torch.Tensor | None) -> torch.Tensor:
    """The [3, B*S, W] q, k, v scratch of the four CUDA entries: new, or the caller's (checked),
    so that a check can read what the projection GEMM wrote (the backward's recompute repeats
    the forward's q, k and v bit for bit)."""
    b, s, w = x.shape
    if qkv is None:
        return torch.empty((3, b * s, w), dtype=x.dtype, device=x.device)
    if (tuple(qkv.shape) != (3, b * s, w) or qkv.dtype != x.dtype or qkv.device != x.device
            or not qkv.is_contiguous()):
        raise ValueError(f"qkv scratch {tuple(qkv.shape)} {qkv.dtype} on {qkv.device}: expected "
                         f"a contiguous {(3, b * s, w)} {x.dtype} on {x.device}")
    return qkv


def _block_attention_cuda(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                          causal: bool, qkv: torch.Tensor | None = None) -> torch.Tensor:
    from multimodal_tpu_torch.ops import _build

    args = (x, wq, bq, wk, bk, wv, bv, wo, bo)
    _check_kernel_operands(args, heads)
    b, s, w = x.shape
    lib = _build.load()
    qkv = _qkv_scratch(x, qkv)
    attn = torch.empty((b * s, w), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_attention_fwd(
            _dtype_code(x), *(t.data_ptr() for t in args),
            qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
            b, s, w, heads, int(causal), stream)
    _build.check(lib, err, "block_attention_fwd launch")
    launches.count("block_attention_fwd")
    return y


def _block_attention_ln_cuda(x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                             causal: bool, residual: bool,
                             qkv: torch.Tensor | None = None) -> torch.Tensor:
    from multimodal_tpu_torch.ops import _build

    args = (x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo)
    _check_kernel_operands(args, heads, ln=True)
    b, s, w = x.shape
    lib = _build.load()
    ln_stats = torch.empty((2, b * s), dtype=torch.float32, device=x.device)
    qkv = _qkv_scratch(x, qkv)
    attn = torch.empty((b * s, w), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_attention_ln_fwd(
            _dtype_code(x), *(t.data_ptr() for t in args),
            ln_stats.data_ptr(), qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
            b, s, w, heads, int(causal), int(residual), LN_EPS, stream)
    _build.check(lib, err, "block_attention_ln_fwd launch")
    launches.count("block_attention_ln_fwd")
    return y


def _block_attention_bwd_cuda(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                              causal: bool, qkv: torch.Tensor | None = None):
    from multimodal_tpu_torch.ops import _build

    args = (x, dy, wq, bq, wk, bk, wv, bv, wo, bo)
    _check_kernel_operands(args, heads)
    b, s, w = x.shape
    lib = _build.load()
    qkv = _qkv_scratch(x, qkv)
    do = torch.empty((b * s, w), dtype=x.dtype, device=x.device)
    # each query row's statistics between the dQ and dK/dV launches: three rows for the mma.sync
    # and float32 passes, the first two for the wgmma kernels (lse, delta)
    stats = torch.empty((3, b * heads * s), dtype=torch.float32, device=x.device)
    outs = tuple(torch.empty_like(x) for _ in range(5))  # dx, dq, dk, dv, attnpre
    with torch.cuda.device(x.device):
        # the stream autograd made current for this backward, never one cached earlier
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_attention_bwd(
            _dtype_code(x), *(t.data_ptr() for t in args),
            qkv.data_ptr(), do.data_ptr(), stats.data_ptr(), *(t.data_ptr() for t in outs),
            b, s, w, heads, int(causal), stream)
    _build.check(lib, err, "block_attention_bwd launch")
    launches.count("block_attention_bwd")
    return outs


def _block_attention_ln_bwd_cuda(x, dy, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, *,
                                 heads: int, causal: bool, residual: bool,
                                 qkv: torch.Tensor | None = None):
    from multimodal_tpu_torch.ops import _build

    args = (x, dy, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo)
    _check_kernel_operands(args, heads, ln=True)
    b, s, w = x.shape
    lib = _build.load()
    f32 = dict(dtype=torch.float32, device=x.device)
    ln_stats = torch.empty((2, b * s), **f32)
    qkv = _qkv_scratch(x, qkv)
    do = torch.empty((b * s, w), dtype=x.dtype, device=x.device)
    stats = torch.empty((3, b * heads * s), **f32)
    g32 = torch.empty((b * s, w), **f32)
    outs = tuple(torch.empty_like(x) for _ in range(6))  # dx, dq, dk, dv, attnpre, ln_out
    # one row of partial sums per block of token rows, each block summed in a fixed order
    parts = torch.empty((2, lib.mmt_ln_bwd_partial_rows(b * s), w), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_attention_ln_bwd(
            _dtype_code(x), *(t.data_ptr() for t in args),
            ln_stats.data_ptr(), qkv.data_ptr(), do.data_ptr(), stats.data_ptr(),
            g32.data_ptr(), *(t.data_ptr() for t in outs), parts[0].data_ptr(),
            parts[1].data_ptr(), b, s, w, heads, int(causal), int(residual), LN_EPS, stream)
    _build.check(lib, err, "block_attention_ln_bwd launch")
    launches.count("block_attention_ln_bwd")
    dgamma, dbeta = parts.sum(dim=1)  # the reference's plain sum over the partials
    return (*outs, dgamma, dbeta)


def block_attention_bwd(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                        causal: bool = False):
    """Per-token (dx, dq, dk, dv, attnpre) of the operator: on a CUDA tensor the backward
    kernel (a build or launch error raises), on a CPU tensor its plain version."""
    if x.is_cuda:
        return _block_attention_bwd_cuda(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads,
                                         causal=causal)
    if x.device.type == "cpu":
        return block_attention_bwd_reference(x, dy, wq, bq, wk, bk, wv, bv, wo, bo,
                                             heads=heads, causal=causal)
    raise ValueError(f"block_attention runs on cuda or cpu tensors, not {x.device}")


def block_attention_ln_bwd(x, dy, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                           causal: bool = False, residual: bool = False):
    """(dx, dq, dk, dv, attnpre, ln_out, dgamma, dbeta) of the LN-fold operator: on a CUDA
    tensor the LN-form backward kernel (a build or launch error raises), on a CPU tensor
    its plain version. gamma and beta are of x.dtype; dgamma and dbeta come back in f32."""
    if x.is_cuda:
        return _block_attention_ln_bwd_cuda(x, dy, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo,
                                            heads=heads, causal=causal, residual=residual)
    if x.device.type == "cpu":
        return block_attention_ln_bwd_reference(x, dy, gamma, beta, wq, bq, wk, bk, wv, bv, wo,
                                                bo, heads=heads, causal=causal,
                                                residual=residual)
    raise ValueError(f"block_attention runs on cuda or cpu tensors, not {x.device}")


def _attn_wgrad(a: torch.Tensor, dz: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a^T dz over every token of the batch ([B*S, W]^T [B*S, W]) in f32, rounded once."""
    f32, w = _acc(a.dtype), a.shape[-1]
    return (a.reshape(-1, w).to(f32).T @ dz.reshape(-1, dz.shape[-1]).to(f32)).to(dtype)


def _bias_grad(dz: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return dz.to(_acc(dz.dtype)).sum(dim=(0, 1)).to(dtype)


def _bias_sum(dz: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``_bias_grad`` without the widened copy of dz: the f32 column sums of dz read as it lies
    (on a CUDA tensor torch's reduction widens each element as it reads it), rounded to dtype."""
    return dz.sum(dim=(0, 1), dtype=_acc(dz.dtype)).to(dtype)


def wgrad_tiles(width: int) -> int:
    """Output tiles of one split of the weight-gradient kernel: 128 x 256 tiles of the four
    [W, W] products."""
    return 4 * (width // 128) * -(-width // 256)


def _rows_per_split(tokens: int, splits: int) -> tuple[int, int]:
    """(splits, rows) for ``splits`` asked of ``tokens`` rows: the rows rounded up to the K-step,
    and as many splits as then hold rows."""
    splits = max(1, min(splits, -(-tokens // WGRAD_K_STEP)))
    rows = -(-tokens // splits)
    rows = -(-rows // WGRAD_K_STEP) * WGRAD_K_STEP
    return -(-tokens // rows), rows


def wgrad_cost(tokens: int, width: int, splits: int) -> int:
    """The planner's model of the kernel's time, in token rows of one tile's products: the rounds
    of tiles the card's SMs run (``wgrad_tiles`` a split) times a split's rows, plus
    ``WGRAD_SPLIT_ROWS`` a split."""
    n, rows = _rows_per_split(tokens, splits)
    return -(-n * wgrad_tiles(width) // WGRAD_SMS) * min(rows, tokens) + WGRAD_SPLIT_ROWS * n


def wgrad_plan(tokens: int, width: int, splits: int | None = None) -> tuple[int, int]:
    """(splits, rows a split) of the weight-gradient kernel over ``tokens`` rows at ``width``: the
    split count of least ``wgrad_cost`` up to ``WGRAD_MAX_SPLITS`` (the fewest on a tie), or the
    ``splits`` a caller asks for (a sweep). Every split but the last holds ``rows``, a multiple of
    the 64-row K-step; the last holds the rest, at least one row. Rounding the rows up may leave
    fewer splits than asked for."""
    if splits is None:
        splits = min(range(1, WGRAD_MAX_SPLITS + 1),
                     key=lambda n: (wgrad_cost(tokens, width, n), n))
    return _rows_per_split(tokens, splits)


def attn_wgrad_walk(a, dq, dk, dv, attnpre, dy, dtype: torch.dtype,
                    splits: int | None = None) -> tuple:
    """Plain PyTorch version of the weight-gradient kernel, its arithmetic step by step:
    (dWq, dWk, dWv, dWo) = (a^T dq, a^T dk, a^T dv, attnpre^T dy) over the token rows, each the
    f32 product of every split of ``wgrad_plan`` added in split order (the running sum, then the
    split's), rounded once to ``dtype``."""
    w = a.shape[-1]
    t = a.numel() // w
    n, rows = wgrad_plan(t, w, splits)
    f32 = _acc(a.dtype)
    grads = []
    for lhs, rhs in ((a, dq), (a, dk), (a, dv), (attnpre, dy)):
        lhs, rhs = lhs.reshape(t, w), rhs.reshape(t, w)
        total = None
        for z in range(n):
            part = lhs[z * rows:(z + 1) * rows].to(f32).T @ rhs[z * rows:(z + 1) * rows].to(f32)
            total = part if total is None else total + part
        grads.append(total.to(dtype))
    return tuple(grads)


def _attn_wgrad_cuda(a, dq, dk, dv, attnpre, dy, dtype: torch.dtype, splits: int | None = None):
    from multimodal_tpu_torch.ops import _build

    operands = dict(a=a, dq=dq, dk=dk, dv=dv, attnpre=attnpre, dy=dy)
    if a.dtype != torch.bfloat16 or dtype != torch.bfloat16:
        raise TypeError(f"the weight-gradient kernel takes bfloat16 operands and gives bfloat16 "
                        f"gradients, got {a.dtype} -> {dtype}")
    w = a.shape[-1]
    if w < 128 or w % 128 or a.numel() < w:
        raise ValueError(f"the weight-gradient kernel does not take {tuple(a.shape)}: W a "
                         "multiple of 128, at least one token row")
    t = a.numel() // w
    for name, op in operands.items():
        if op.device != a.device or op.dtype != a.dtype or op.shape[-1] != w or op.numel() != t * w:
            raise ValueError(f"weight-gradient operand {name} {tuple(op.shape)} {op.dtype} on "
                             f"{op.device}: expected [{t}, {w}] tokens {a.dtype} on {a.device}")
        if not op.is_contiguous() or op.data_ptr() % 16:
            raise ValueError(f"weight-gradient operand {name} must be contiguous and 16-byte "
                             "aligned")
    n, rows = wgrad_plan(t, w, splits)
    lib = _build.load()
    sums = torch.empty((4, w, w), dtype=torch.float32, device=a.device)  # the running sums
    flags = torch.empty(lib.mmt_block_wgrad_flag_count(w), dtype=torch.int32, device=a.device)
    out = torch.empty((4, w, w), dtype=dtype, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_attention_wgrad(
            *(op.data_ptr() for op in operands.values()), sums.data_ptr(), flags.data_ptr(),
            out.data_ptr(), t, w, n, rows, stream)
    _build.check(lib, err, "block_attention_wgrad launch")
    launches.count("block_attention_wgrad")
    return tuple(out.unbind(0))


def attn_wgrad(a, dq, dk, dv, attnpre, dy, dtype: torch.dtype, *, splits: int | None = None):
    """The operator's four weight gradients, (a^T dq, a^T dk, a^T dv, attnpre^T dy) over every
    token row of [B, S, W] (or [T, W]) operands, each an f32 sum rounded once to ``dtype``, the
    reference's ``_attn_wgrad``: on a CUDA tensor the weight-gradient kernel (bfloat16 operands
    and gradients; one launch; a build or launch error, another dtype or a shape it does not take
    raises), on a CPU tensor its plain versions (``_attn_wgrad``). ``splits`` overrides the
    kernel's plan (a sweep)."""
    if a.is_cuda:
        return _attn_wgrad_cuda(a, dq, dk, dv, attnpre, dy, dtype, splits)
    if a.device.type == "cpu":
        return tuple(_attn_wgrad(lhs, rhs, dtype)
                     for lhs, rhs in ((a, dq), (a, dk), (a, dv), (attnpre, dy)))
    raise ValueError(f"block_attention runs on cuda or cpu tensors, not {a.device}")


def _param_grads(a, dq, dk, dv, attnpre, dy, wq, bq, wk, bk, wv, bv, wo, bo) -> tuple:
    """(dWq, dbq, dWk, dbk, dWv, dbv, dWo, dbo) of the operator from the per-token gradients, as
    the reference's backward forms them outside its kernel: in bfloat16 on the card the
    weight-gradient kernel and the bias sums read as they lie; in float32 on the card the f32
    products (``torch.matmul``, TF32 off) and sums; on the CPU the plain versions."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        dwq, dwk, dwv, dwo = attn_wgrad(a, dq, dk, dv, attnpre, dy, wq.dtype)
    else:
        dwq, dwk, dwv = (_attn_wgrad(a, dz, w_.dtype) for dz, w_ in ((dq, wq), (dk, wk), (dv, wv)))
        dwo = _attn_wgrad(attnpre, dy, wo.dtype)
    bias_grad = _bias_sum if a.is_cuda else _bias_grad
    dbq, dbk, dbv, dbo = (bias_grad(dz, b_.dtype)
                          for dz, b_ in ((dq, bq), (dk, bk), (dv, bv), (dy, bo)))
    return dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo


class BlockAttention(torch.autograd.Function):
    """The operator with its gradient, as the reference's ``_block_attention`` custom VJP:
    the forward saves the inputs; the backward recomputes everything else, takes the
    per-token gradients from the backward kernel (its plain version on a CPU tensor) and
    forms the weight gradients as whole-batch products and the bias gradients as sums
    (``_param_grads``)."""

    @staticmethod
    def forward(ctx, x, wq, bq, wk, bk, wv, bv, wo, bo, heads: int, causal: bool):
        if x.is_cuda:
            y = _block_attention_cuda(x, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads,
                                      causal=causal)
        elif x.device.type == "cpu":
            y = block_attention_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads,
                                          causal=causal)
        else:
            raise ValueError(f"block_attention runs on cuda or cpu tensors, not {x.device}")
        ctx.save_for_backward(x, wq, bq, wk, bk, wv, bv, wo, bo)
        ctx.heads, ctx.causal = heads, causal
        return y

    @staticmethod
    def backward(ctx, dy):
        x, wq, bq, wk, bk, wv, bv, wo, bo = ctx.saved_tensors
        dy = dy.contiguous()
        dx, dq, dk, dv, attnpre = block_attention_bwd(x, dy, wq, bq, wk, bk, wv, bv, wo, bo,
                                                      heads=ctx.heads, causal=ctx.causal)
        return (dx, *_param_grads(x, dq, dk, dv, attnpre, dy, wq, bq, wk, bk, wv, bv, wo, bo),
                None, None)


class BlockAttentionLN(torch.autograd.Function):
    """The LN-fold operator with its gradient, as the reference's ``_block_attention_ln``
    custom VJP: x is the pre-LN residual stream; the forward normalizes inside the kernel
    and, with ``residual``, adds x there too. The backward takes dx (LN vjp and residual
    cotangent included), the per-token gradients, ``ln_out`` and the summed dgamma/dbeta
    from the LN-form backward kernel; the weight gradients are whole-batch products with
    ``ln_out`` (not x), the bias gradients sums."""

    @staticmethod
    def forward(ctx, x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, heads: int,
                causal: bool, residual: bool):
        g_, b_ = gamma.to(x.dtype), beta.to(x.dtype)
        if x.is_cuda:
            y = _block_attention_ln_cuda(x, g_, b_, wq, bq, wk, bk, wv, bv, wo, bo,
                                         heads=heads, causal=causal, residual=residual)
        elif x.device.type == "cpu":
            y = block_attention_ln_reference(x, g_, b_, wq, bq, wk, bk, wv, bv, wo, bo,
                                             heads=heads, causal=causal, residual=residual)
        else:
            raise ValueError(f"block_attention runs on cuda or cpu tensors, not {x.device}")
        ctx.save_for_backward(x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo)
        ctx.heads, ctx.causal, ctx.residual = heads, causal, residual
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo = ctx.saved_tensors
        dy = dy.contiguous()
        dx, dq, dk, dv, attnpre, ln_out, dgamma, dbeta = block_attention_ln_bwd(
            x, dy, gamma.to(x.dtype), beta.to(x.dtype), wq, bq, wk, bk, wv, bv, wo, bo,
            heads=ctx.heads, causal=ctx.causal, residual=ctx.residual)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(beta.dtype),
                *_param_grads(ln_out, dq, dk, dv, attnpre, dy, wq, bq, wk, bk, wv, bv, wo, bo),
                None, None, None)


def block_attention_ln(x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                       causal: bool = False, residual: bool = False) -> torch.Tensor:
    """The LN-fold operator at any supported S: attn(LN(x)), plus x with ``residual``."""
    return BlockAttentionLN.apply(x, gamma, beta, wq, bq, wk, bk, wv, bv, wo, bo, heads, causal,
                                  residual)


def block_attention(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int, causal: bool = False,
                    ln_scale=None, ln_bias=None, residual: bool = False) -> torch.Tensor:
    """Fused QKV projection + multi-head attention + output projection, differentiable.

    x: [B, S, W]; weights [W, W] in the [in, out] layout, biases [W], all in x.dtype.
    With ``ln_scale``/``ln_bias``, x is the pre-LN residual stream; with ``residual=True``
    (requires them) the result is ``x + attn(LN(x))``. At S > 128 the LayerNorm and the
    residual add are folded into the kernels (``BlockAttentionLN``); at S <= 128 the
    LayerNorm runs first as ``ln_rows`` and the add after the operator, as the reference
    measured best. A CUDA tensor goes to the hand-written kernels, forward and backward (a
    build or launch error raises), a CPU tensor to their plain versions."""
    if residual and ln_scale is None:
        raise ValueError("residual=True requires the pre-LN form (ln_scale)")
    if ln_scale is not None and x.shape[1] > LN_FOLD_MIN_SEQ:
        return block_attention_ln(x, ln_scale, ln_bias, wq, bq, wk, bk, wv, bv, wo, bo,
                                  heads=heads, causal=causal, residual=residual)
    x_raw = x
    if ln_scale is not None:
        x = ln_rows(x, ln_scale, ln_bias, LN_EPS)
    out = BlockAttention.apply(x, wq, bq, wk, bk, wv, bv, wo, bo, heads, causal)
    return x_raw + out if residual else out
