"""Fused whole-sequence attention for CLIP-scale lengths (128 <= S <= 512): the attention
core alone, over separate q, k and v in the packed [B, S, H*D] layout the dense projections
produce, differentiable.

Port of ``multimodal_tpu/ops/fused_attention.py``. ``FusedAttention`` is a
``torch.autograd.Function`` that saves (q, k, v) and recomputes the probabilities in its
backward, as the reference's custom VJP does (in float32 on the card it also keeps ``out``,
which the out projection keeps alive anyway, and each row's log-sum-exp). On a CUDA tensor the
forward and the backward launch the hand-written Hopper kernels (``ops/csrc/fused_attention.cu``)
and nothing else: in bfloat16 the forward ``fused_fwd_kernel`` and the backward
``fused_dq_kernel`` then ``fused_dkv_kernel``, ``wgmma`` fed by TMA, persistent over the (image,
head) items with each item's inputs resident (the dQ kernel forms each query row's log-sum-exp
and exact delta in a first sweep over the keys and the dK/dV kernel reads them back); in
float32 the forward core of ``attention_passes.cuh`` (which also writes the log-sum-exp) and
the backward through the same C entry: ``fused_delta_kernel`` (delta = rowsum(do * out) of each
query row), then the flash dQ and dK/dV kernels (3xTF32 on the tensor cores) on the packed
tensors read as [B, S, H, D] with the forward's log-sum-exp. On a CPU tensor they run ``fused_attention_reference`` and
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
ones — unlike the block-attention backward, which uses the rounded ones for both. In float32
the backward takes delta as rowsum(do * out) from the forward's out, equal to rowsum(dp * p) up
to the order of the sums; bfloat16 keeps the exact rowsum(dp * p). The
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
    do and, in float32, out) of one dtype (float32 or bfloat16), shape and device, contiguous and 16-byte aligned,
    with D a multiple of 8 up to 128 (the kernels load 16 bytes at a time) and S <= 512.
    Raises otherwise, naming the operand."""
    q = tensors[0]
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused_attention kernel takes float32 or bfloat16, got {q.dtype}")
    b, s, w = q.shape
    if w % heads or w // heads > 128 or (w // heads) % 8 or s > MAX_FUSED_SEQ:
        raise ValueError(f"fused_attention kernel does not take S={s} W={w} H={heads}: it needs "
                         f"a head dim that is a multiple of 8 up to 128 and S <= {MAX_FUSED_SEQ}")
    for name, t in zip(("q", "k", "v", "do", "out"), tensors):
        if t.device != q.device or t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"fused_attention operand {name} {tuple(t.shape)} {t.dtype} on {t.device}: "
                f"expected {tuple(q.shape)} {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_attention operand {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"fused_attention operand {name} must be 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")


def _fused_cuda(q, k, v, *, heads: int, causal: bool, sm_scale: float):
    """The forward kernel: (out, lse), lse each row's log-sum-exp [B*H*S] (float32; None in
    bfloat16, whose backward forms its own)."""
    from multimodal_tpu_torch.ops import _build

    _check_kernel_operands((q, k, v), heads)
    b, s, w = q.shape
    lib = _build.load()
    out = torch.empty_like(q)
    lse = (torch.empty(b * heads * s, dtype=torch.float32, device=q.device)
           if q.dtype == torch.float32 else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_fused_attention_fwd(
            0 if q.dtype == torch.float32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr(), b, s, heads, w // heads,
            int(causal), sm_scale, stream)
    _build.check(lib, err, "fused_attention_fwd launch")
    launches.count("fused_attention_fwd")
    return out, lse


def _fused_bwd_cuda(q, k, v, do, out, lse, *, heads: int, causal: bool, sm_scale: float):
    """The backward kernels; ``out`` and ``lse`` (the forward's) are read in float32 only."""
    from multimodal_tpu_torch.ops import _build

    f32 = q.dtype == torch.float32
    _check_kernel_operands((q, k, v, do) + ((out,) if f32 else ()), heads)
    b, s, w = q.shape
    if f32:
        if (lse.dtype != torch.float32 or lse.numel() != b * heads * s
                or not lse.is_contiguous() or lse.device != q.device):
            raise ValueError("fused_attention lse must be the forward's float32 [B*H*S] on q's "
                             "device")
    # scratch: in bfloat16 each row's lse and delta, which the dQ kernel writes and the dK/dV
    # kernel reads; in float32 each row's delta = rowsum(do * out)
    stats = torch.empty((1 if f32 else 2, b * heads * s), dtype=torch.float32, device=q.device)
    lib = _build.load()
    outs = tuple(torch.empty_like(q) for _ in range(3))  # dq, dk, dv
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.mmt_fused_attention_bwd(
            0 if f32 else 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            out.data_ptr() if f32 else None, lse.data_ptr() if f32 else None, stats.data_ptr(),
            *(t.data_ptr() for t in outs),
            b, s, heads, w // heads, int(causal), sm_scale, stream)
    _build.check(lib, err, "fused_attention_bwd launch")
    launches.count("fused_attention_bwd")
    return outs


def fused_attention_fwd(q, k, v, *, heads: int, causal: bool = False,
                        sm_scale: float | None = None):
    """(out, lse): on a CUDA tensor the forward kernel, lse each row's log-sum-exp of the
    scaled logits [B*H*S] in float32 and None in bfloat16; on a CPU tensor the plain forward
    and None. The pair is what the float32 backward kernels take (``fused_attention_bwd``)."""
    sm_scale = (q.shape[-1] // heads) ** -0.5 if sm_scale is None else sm_scale
    if q.is_cuda:
        return _fused_cuda(q, k, v, heads=heads, causal=causal, sm_scale=sm_scale)
    if q.device.type == "cpu":
        return fused_attention_reference(q, k, v, heads=heads, causal=causal,
                                         sm_scale=sm_scale), None
    raise ValueError(f"fused_attention runs on cuda or cpu tensors, not {q.device}")


def fused_attention_bwd(q, k, v, do, *, heads: int, causal: bool = False,
                        sm_scale: float | None = None, out=None, lse=None):
    """(dq, dk, dv) of the operator: on a CUDA tensor the backward kernels (a build or launch
    error raises), on a CPU tensor its plain version. ``out`` and ``lse`` are the forward's
    (``fused_attention_fwd``), which the float32 kernels read for delta and the probabilities:
    a float32 call on the card without them raises. The bfloat16 kernels form their own."""
    sm_scale = (q.shape[-1] // heads) ** -0.5 if sm_scale is None else sm_scale
    if q.is_cuda:
        if q.dtype == torch.float32 and (out is None or lse is None):
            raise ValueError("the float32 fused_attention backward on the card takes the "
                             "forward's out and lse (fused_attention_fwd)")
        return _fused_bwd_cuda(q, k, v, do, out, lse, heads=heads, causal=causal,
                               sm_scale=sm_scale)
    if q.device.type == "cpu":
        return fused_attention_bwd_reference(q, k, v, do, heads=heads, causal=causal,
                                             sm_scale=sm_scale)
    raise ValueError(f"fused_attention runs on cuda or cpu tensors, not {q.device}")


class FusedAttention(torch.autograd.Function):
    """The operator with its gradient, as the reference's ``_fused`` custom VJP: the forward
    saves (q, k, v) and, in float32 on the card, out and lse (the kernels' delta and
    probabilities); the backward recomputes the probabilities and emits dq, dk and dv."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, causal: bool, sm_scale: float):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = fused_attention_fwd(q, k, v, heads=heads, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out if lse is not None else None, lse)
        ctx.heads, ctx.causal, ctx.sm_scale = heads, causal, sm_scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, do.to(v.dtype).contiguous(), heads=ctx.heads,
                                         causal=ctx.causal, sm_scale=ctx.sm_scale, out=out,
                                         lse=lse)
        return dq, dk, dv, None, None, None


def fused_attention(q, k, v, *, heads: int, causal: bool = False,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Whole-sequence fused self-attention over [B, S, H*D] packed heads, differentiable.

    Returns [B, S, H*D] in v.dtype. A CUDA tensor goes to the hand-written kernels, forward
    and backward (a build or launch error raises), a CPU tensor to their plain versions."""
    if sm_scale is None:
        sm_scale = (q.shape[-1] // heads) ** -0.5
    return FusedAttention.apply(q, k, v, heads, causal, float(sm_scale))
