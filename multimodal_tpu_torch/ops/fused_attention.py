"""Fused whole-sequence attention for CLIP-scale lengths (128 <= S <= 512): the attention
core alone, over separate q, k and v in the packed [B, S, H*D] layout the dense projections
produce, differentiable.

Port of ``multimodal_tpu/ops/fused_attention.py``. ``FusedAttention`` is a
``torch.autograd.Function`` that saves (q, k, v) and recomputes the probabilities in its
backward, as the reference's custom VJP does. On a CUDA tensor the forward and the backward
launch the hand-written Hopper kernels (``ops/csrc/fused_attention.cu``: in bfloat16 the
forward is ``fused_fwd_kernel``, ``wgmma`` fed by TMA, persistent over the (image, head)
items; the backward and the float32 forward are the passes of ``attention_passes.cuh``) and
nothing else;
on a CPU tensor they run ``fused_attention_reference`` and
``fused_attention_bwd_reference``, the plain PyTorch versions of the same math, which are
also what the on-card comparison holds the kernels to. ``ops.attention.attention`` reaches
this operator for self-attention whenever the block-attention operator does not take the
call (``scale_heads``, or a width it rejects).

Numerics kept from the TPU kernels: logits in f32 times ``sm_scale`` with the finite -1e30
causal mask (col <= row); probabilities rounded to the compute dtype before p @ v (the
kernels round them against a running max and normalise the f32 sum at the end, single bf16
steps of out from the plain version; the bfloat16 forward also folds ``sm_scale`` into its
exponent, p = 2^(t c - max(t) c) for the unscaled logit t and c = sm_scale log2(e)). In the
backward dv uses those rounded probabilities, while rowsum(dp * p) and ds use the exact f32
ones — unlike the block-attention backward, which uses the rounded ones for both. The
reference's pad of S to 16 rows is TPU tiling and is not ported.
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.ops import launches

MIN_FUSED_SEQ = 128
MAX_FUSED_SEQ = 512
NEG_INF = -1e30

launches.register("fused_attention_fwd", "fused_attention_bwd")


def fused_supported(seq_len: int, head_dim: int) -> bool:
    return head_dim in (32, 64, 128) and MIN_FUSED_SEQ <= seq_len <= MAX_FUSED_SEQ


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, S, H*D] -> [B, H, S, D]."""
    b, s, w = t.shape
    return t.view(b, s, heads, w // heads).transpose(1, 2)


def _pack(t: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> [B, S, H*D]."""
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _exact_probs(q, k, causal: bool, sm_scale: float) -> torch.Tensor:
    """softmax(q k^T sm_scale) per head in f32, not rounded. q, k: [B, H, S, D]."""
    f32, s = _acc(q.dtype), q.shape[-2]
    logits = (q.to(f32) @ k.to(f32).transpose(-1, -2)) * sm_scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return p / p.sum(dim=-1, keepdim=True)


def fused_attention_reference(q, k, v, *, heads: int, causal: bool = False,
                              sm_scale: float | None = None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel over packed [B, S, H*D]."""
    sm_scale = (q.shape[-1] // heads) ** -0.5 if sm_scale is None else sm_scale
    f32 = _acc(q.dtype)
    qh, kh, vh = (_heads(t, heads) for t in (q, k, v))
    p = _exact_probs(qh, kh, causal, sm_scale).to(q.dtype)
    return _pack((p.to(f32) @ vh.to(f32)).to(v.dtype))


def fused_attention_bwd_reference(q, k, v, do, *, heads: int, causal: bool = False,
                                  sm_scale: float | None = None):
    """Plain PyTorch version of the backward kernel: (dq, dk, dv), each [B, S, H*D].

    Step by step the TPU kernel's ``_bwd_kernel``: p32 the exact f32 probabilities, p their
    rounding to the compute dtype; dv = p^T do with the rounded p; dp = do v^T in f32;
    delta = rowsum(dp * p32) and ds = p32 (dp - delta) with the exact p32, ds rounded;
    dq = (ds k) sm_scale and dk = (ds^T q) sm_scale, scaled in f32 before the rounding."""
    sm_scale = (q.shape[-1] // heads) ** -0.5 if sm_scale is None else sm_scale
    f32, dt = _acc(q.dtype), q.dtype
    qh, kh, vh, doh = (_heads(t, heads).to(f32) for t in (q, k, v, do))
    p32 = _exact_probs(qh, kh, causal, sm_scale)
    p = p32.to(dt).to(f32)
    dv = (p.transpose(-1, -2) @ doh).to(dt)
    dp = doh @ vh.transpose(-1, -2)
    ds = (p32 * (dp - (dp * p32).sum(dim=-1, keepdim=True))).to(dt).to(f32)
    dq = ((ds @ kh) * sm_scale).to(dt)
    dk = ((ds.transpose(-1, -2) @ qh) * sm_scale).to(dt)
    return _pack(dq), _pack(dk), _pack(dv)


def _check_kernel_operands(tensors, heads: int):
    """What the CUDA kernels take: packed [B, S, H*D] tensors (q, k, v and, in the backward,
    do) of one dtype (float32 or bfloat16), shape and device, contiguous and 16-byte aligned,
    with D a multiple of 8 up to 128 (the kernels load 16 bytes at a time) and S <= 512.
    Raises otherwise, naming the operand."""
    q = tensors[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, got {q.dtype}")
    b, s, w = q.shape
    if w % heads or w // heads > 128 or (w // heads) % 8 or s > MAX_FUSED_SEQ:
        raise ValueError(f"fused_attention kernel does not take S={s} W={w} H={heads}: it needs "
                         f"a head dim that is a multiple of 8 up to 128 and S <= {MAX_FUSED_SEQ}")
    for name, t in zip(("q", "k", "v", "do"), tensors):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"fused_attention operand {name} {tuple(t.shape)} {t.dtype} on {t.device}: "
                f"expected {tuple(q.shape)} {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_attention operand {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_attention operand {name} must be 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")


def _fused_cuda(q, k, v, *, heads: int, causal: bool, sm_scale: float) -> torch.Tensor:
    from multimodal_tpu_torch.ops import _build

    _check_kernel_operands((q, k, v), heads)
    b, s, w = q.shape
    lib = _build.load()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_fused_attention_fwd(
            0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, s, heads, w // heads, int(causal), sm_scale, stream)
    _build.check(lib, err, "fused_attention_fwd launch")
    launches.count("fused_attention_fwd")
    return out


def _fused_bwd_cuda(q, k, v, do, *, heads: int, causal: bool, sm_scale: float):
    from multimodal_tpu_torch.ops import _build

    _check_kernel_operands((q, k, v, do), heads)
    b, s, w = q.shape
    lib = _build.load()
    stats = torch.empty((3, b * heads * s), dtype=torch.float32, device=q.device)
    outs = tuple(torch.empty_like(q) for _ in range(3))  # dq, dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_fused_attention_bwd(
            0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            do.data_ptr(), stats.data_ptr(), *(t.data_ptr() for t in outs),
            b, s, heads, w // heads, int(causal), sm_scale, stream)
    _build.check(lib, err, "fused_attention_bwd launch")
    launches.count("fused_attention_bwd")
    return outs


def fused_attention_bwd(q, k, v, do, *, heads: int, causal: bool = False,
                        sm_scale: float | None = None):
    """(dq, dk, dv) of the operator: on a CUDA tensor the backward kernel (a build or launch
    error raises), on a CPU tensor its plain version."""
    sm_scale = (q.shape[-1] // heads) ** -0.5 if sm_scale is None else sm_scale
    if q.is_cuda:
        return _fused_bwd_cuda(q, k, v, do, heads=heads, causal=causal, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, do, heads=heads, causal=causal,
                                             sm_scale=sm_scale)
    raise ValueError(f"fused_attention runs on cuda or cpu tensors, not {q.device}")


class FusedAttention(torch.autograd.Function):
    """The operator with its gradient, as the reference's ``_fused`` custom VJP: the forward
    saves (q, k, v); the backward recomputes the probabilities and emits dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, causal: bool, sm_scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if q.is_cuda:
            out = _fused_cuda(q, k, v, heads=heads, causal=causal, sm_scale=sm_scale)
        elif q.device.type == "cpu":
            out = fused_attention_reference(q, k, v, heads=heads, causal=causal,
                                            sm_scale=sm_scale)
        else:
            raise ValueError(f"fused_attention runs on cuda or cpu tensors, not {q.device}")
        ctx.save_for_backward(q, k, v)
        ctx.heads, ctx.causal, ctx.sm_scale = heads, causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, do.to(v.dtype).contiguous(), heads=ctx.heads,
                                         causal=ctx.causal, sm_scale=ctx.sm_scale)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, *, heads: int, causal: bool = False,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Whole-sequence fused self-attention over [B, S, H*D] packed heads, differentiable.

    Returns [B, S, H*D] in v.dtype. A CUDA tensor goes to the hand-written kernels, forward
    and backward (a build or launch error raises), a CPU tensor to their plain versions."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // heads) ** -0.5
    return FusedAttention.apply(q, k, v, heads, causal, float(sm_scale))
