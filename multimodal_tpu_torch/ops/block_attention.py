"""Whole-block attention for short-to-medium sequences (S <= 320): QKV projections +
per-head softmax(QK^T)V + output projection in one differentiable operator.

Port of ``multimodal_tpu/ops/block_attention.py`` (non-LN form: ``_block_attention`` and
its custom VJP). ``BlockAttention`` is a ``torch.autograd.Function``. On a CUDA tensor its
forward launches the hand-written Hopper kernel (``ops/csrc/block_attention_fwd.cu``) and
its backward the backward kernel (``ops/csrc/block_attention_bwd.cu``), and nothing else;
on a CPU tensor they run ``block_attention_reference`` and
``block_attention_bwd_reference``, the plain PyTorch versions of the same math, which are
also what the on-card comparison holds the kernels to. The pre-attention LayerNorm runs as
the ``ln_rows`` pre-pass and the residual add after the operator, both in torch's
autograd, as the reference does at S<=128.

Numerics kept from the TPU kernels: projections accumulate in f32 with the bias added in
f32 before one rounding to the compute dtype; logits and softmax in f32 with the finite
-1e30 causal mask (col <= row); probabilities and the attention output rounded to the
compute dtype before their next product; the backward rounds exactly where ``_bwd_kernel``
does (see ``block_attention_bwd_reference``).
"""

from __future__ import annotations

import threading

import torch

NEG_INF = -1e30
MAX_BLOCK_SEQ = 320
LN_EPS = 1e-5

_count_lock = threading.Lock()
_launches = {"block_attention_fwd": 0, "block_attention_bwd": 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel name (plain-version calls excluded)."""
    with _count_lock:
        return dict(_launches)


def reset_launch_counts():
    with _count_lock:
        for name in _launches:
            _launches[name] = 0


def block_attn_supported(batch: int, seq: int, width: int, heads: int) -> bool:
    """The reference's dispatch rule: head_dim in {32, 64, 128} or an 8-multiple below 128,
    width a multiple of 128, S <= 320."""
    head_dim = width // heads
    dim_ok = head_dim in (32, 64, 128) or (head_dim % 8 == 0 and head_dim < 128)
    return dim_ok and width % 128 == 0 and seq <= MAX_BLOCK_SEQ


def ln_rows(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float):
    """Row-wise LayerNorm with f32 statistics (var = max(E[x^2] - mean^2, 0), rsqrt in f32)
    and compute-dtype arithmetic — the reference's ``_ln_rows``, which ``F.layer_norm`` does
    not reproduce in bf16."""
    x32 = x.to(torch.float32)
    mean = x32.mean(dim=-1, keepdim=True)
    var = torch.clamp(x32.square().mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
    inv = torch.rsqrt(var + eps)
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype)
    return y * gamma.to(x.dtype) + beta.to(x.dtype)


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The accumulation dtype: float32 for float32 and bfloat16 (float64 stays float64, so
    the plain versions can be gradient-checked)."""
    return torch.promote_types(dtype, torch.float32)


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


def block_attention_bwd_reference(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                                  causal: bool = False):
    """Plain PyTorch version of the backward kernel: per-token (dx, dq, dk, dv, attnpre),
    each [B, S, W] in x.dtype.

    Step by step the TPU kernel's ``_bwd_kernel`` (non-LN form), with its rounding points:
    q/k/v recomputed as in the forward; do = dy Wo^T accumulated in f32 and rounded; p
    rounded (p32 is the rounded p widened); attnpre = p v and dv = p^T do, each rounded
    once; dp = do v^T in f32; ds = p32 (dp - rowsum(dp p32)) rounded; dq = (ds k) scale and
    dk = (ds^T q) scale, scaled in f32 before the rounding; dx = dq Wq^T + dk Wk^T + dv Wv^T
    as ONE product over the concatenated [dq | dk | dv] and [Wq; Wk; Wv]^T, rounded once."""
    f32, dt = _acc(x.dtype), x.dtype
    scale = (x.shape[-1] // heads) ** -0.5
    q, k, v = (_split_heads(_proj(x, w_, b_), heads) for w_, b_ in ((wq, bq), (wk, bk), (wv, bv)))
    do = _split_heads((dy.to(f32) @ wo.to(f32).T).to(dt), heads)
    p32 = _probs(q, k, causal).to(f32)
    q32, k32, v32, do32 = (t.to(f32) for t in (q, k, v, do))
    attnpre = (p32 @ v32).to(dt)
    dv = (p32.transpose(-1, -2) @ do32).to(dt)
    dp = do32 @ v32.transpose(-1, -2)
    ds32 = (p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))).to(dt).to(f32)
    dq = ((ds32 @ k32) * scale).to(dt)
    dk = ((ds32.transpose(-1, -2) @ q32) * scale).to(dt)
    dq, dk, dv, attnpre = (_merge_heads(t) for t in (dq, dk, dv, attnpre))
    dqkv = torch.cat([dq, dk, dv], dim=-1).to(f32)
    wqkv_t = torch.cat([wq.T, wk.T, wv.T], dim=0).to(f32)  # [3W, W]
    dx = (dqkv @ wqkv_t).to(dt)
    return dx, dq, dk, dv, attnpre


def _check_kernel_operands(args, heads: int):
    """What the CUDA kernels take: (x, [dy,] wq, bq, wk, bk, wv, bv, wo, bo) of one dtype
    (float32 or bfloat16) on one device, contiguous and 16-byte aligned, at a supported
    shape. Raises otherwise."""
    x = args[0]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_attention kernel takes float32 or bfloat16, got {x.dtype}")
    b, s, w = x.shape
    if not block_attn_supported(b, s, w, heads):
        raise ValueError(f"block_attention kernel does not take B={b} S={s} W={w} H={heads}")
    shapes = [(b, s, w)] * (len(args) - 8) + [(w, w), (w,)] * 4
    for t, shape in zip(args, shapes):
        if t.device != x.device or t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"block_attention operand {tuple(t.shape)} {t.dtype} on {t.device}: expected "
                f"{shape} {x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("block_attention operands must be contiguous and 16-byte aligned")


def _block_attention_cuda(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                          causal: bool) -> torch.Tensor:
    from multimodal_tpu_torch.ops import _build

    args = (x, wq, bq, wk, bk, wv, bv, wo, bo)
    _check_kernel_operands(args, heads)
    b, s, w = x.shape
    lib = _build.load()
    qkv = torch.empty((3, b * s, w), dtype=x.dtype, device=x.device)
    attn = torch.empty((b * s, w), dtype=x.dtype, device=x.device)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_attention_fwd(
            0 if x.dtype == torch.float32 else 1, *(t.data_ptr() for t in args),
            qkv.data_ptr(), attn.data_ptr(), y.data_ptr(),
            b, s, w, heads, int(causal), stream)
    _build.check(lib, err, "block_attention_fwd launch")
    with _count_lock:
        _launches["block_attention_fwd"] += 1
    return y


def _block_attention_bwd_cuda(x, dy, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                              causal: bool):
    from multimodal_tpu_torch.ops import _build

    args = (x, dy, wq, bq, wk, bk, wv, bv, wo, bo)
    _check_kernel_operands(args, heads)
    b, s, w = x.shape
    lib = _build.load()
    qkv = torch.empty((3, b * s, w), dtype=x.dtype, device=x.device)
    do = torch.empty((b * s, w), dtype=x.dtype, device=x.device)
    stats = torch.empty((3, b * heads * s), dtype=torch.float32, device=x.device)
    outs = tuple(torch.empty_like(x) for _ in range(5))  # dx, dq, dk, dv, attnpre
    with torch.cuda.device(x.device):
        # the stream autograd made current for this backward, never one cached earlier
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_block_attention_bwd(
            0 if x.dtype == torch.float32 else 1, *(t.data_ptr() for t in args),
            qkv.data_ptr(), do.data_ptr(), stats.data_ptr(), *(t.data_ptr() for t in outs),
            b, s, w, heads, int(causal), stream)
    _build.check(lib, err, "block_attention_bwd launch")
    with _count_lock:
        _launches["block_attention_bwd"] += 1
    return outs


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


def _attn_wgrad(a: torch.Tensor, dz: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """a^T dz over every token of the batch ([B*S, W]^T [B*S, W]) in f32, rounded once."""
    f32, w = _acc(a.dtype), a.shape[-1]
    return (a.reshape(-1, w).to(f32).T @ dz.reshape(-1, dz.shape[-1]).to(f32)).to(dtype)


def _bias_grad(dz: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return dz.to(_acc(dz.dtype)).sum(dim=(0, 1)).to(dtype)


class BlockAttention(torch.autograd.Function):
    """The operator with its gradient, as the reference's ``_block_attention`` custom VJP:
    the forward saves the inputs; the backward recomputes everything else, takes the
    per-token gradients from the backward kernel (its plain version on a CPU tensor) and
    forms the weight gradients as whole-batch products and the bias gradients as sums."""

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
        dwq, dwk, dwv = (_attn_wgrad(x, dz, w_.dtype) for dz, w_ in ((dq, wq), (dk, wk), (dv, wv)))
        dwo = _attn_wgrad(attnpre, dy, wo.dtype)
        dbq, dbk, dbv, dbo = (_bias_grad(dz, b_.dtype)
                              for dz, b_ in ((dq, bq), (dk, bk), (dv, bv), (dy, bo)))
        return dx, dwq, dbq, dwk, dbk, dwv, dbv, dwo, dbo, None, None


def block_attention(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int, causal: bool = False,
                    ln_scale=None, ln_bias=None, residual: bool = False) -> torch.Tensor:
    """Fused QKV projection + multi-head attention + output projection, differentiable.

    x: [B, S, W]; weights [W, W] in the [in, out] layout, biases [W], all in x.dtype.
    With ``ln_scale``/``ln_bias``, x is the pre-LN residual stream and the LayerNorm runs
    first (``ln_rows``); with ``residual=True`` (requires them) the result is
    ``x + attn(LN(x))``. A CUDA tensor goes to the hand-written kernels, forward and
    backward (a build or launch error raises), a CPU tensor to their plain versions."""
    if residual and ln_scale is None:
        raise ValueError("residual=True requires the pre-LN form (ln_scale)")
    x_raw = x
    if ln_scale is not None:
        x = ln_rows(x, ln_scale, ln_bias, LN_EPS)
    out = BlockAttention.apply(x, wq, bq, wk, bk, wv, bv, wo, bo, heads, causal)
    return x_raw + out if residual else out
