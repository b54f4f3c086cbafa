"""Blocked online-softmax (flash) attention for long sequences, full and causal,
differentiable: the [B, H, Sq, Sk] matrix reaches device memory in neither direction.

Port of ``multimodal_tpu/ops/flash_attention.py``. ``FlashAttention`` is a
``torch.autograd.Function`` that saves (q, k, v, out, lse), as the reference's custom VJP
does, and rebuilds the probability tiles from ``lse`` in its backward. On a CUDA tensor the
forward launches the hand-written forward kernel and the backward the dQ and the dK/dV
kernels (``ops/csrc/flash_attention.cu``; all three multiply on the tensor cores, bf16
operands in bfloat16 and 3xTF32 in float32), which read the ``[B, S, H, D]`` tensors in
place; on a CPU tensor they run ``flash_attention_reference`` and ``flash_attention_bwd_reference``,
the plain PyTorch versions of the same math, which are also what the on-card comparison holds
the kernels to. ``ops.attention.attention`` reaches this operator for causal self-attention
from ``MIN_FLASH_SEQ`` tokens up.

Numerics kept from the TPU kernels: masked logits take the finite -1e30 and the running max
starts there, so a fully masked tile adds exactly 0 and nothing becomes NaN (key tiles are
walked in rising order, and tile 0 always holds a live column); the causal mask is top-left
aligned (key <= query), unlike the plain attention path's bottom-right one, and the two agree
only for sq == sk. Rounding points: the row sum ``l`` takes the unrounded p = exp(s - m) while
the accumulator takes round(p) @ v, and the division by ``l`` comes last; in the backward
``delta`` comes from the rounded ``out``, dv from round(P), ds = round(P (dp - delta)), and dq
and dk are scaled by ``sm_scale`` per key or query tile in f32 before they are summed (the
kernels scale once at the store: a difference of summation order only). The
reference's transposes to [B, H, S, D], its pads of Sq and Sk and its 128-lane copies of lse
and delta are TPU tiling and are not ported. The kernels take head dims that are multiples of
8; on a CUDA tensor ``FlashAttention`` zero-pads any other D up to the next one (zero columns
add nothing to q k^T, and give zero columns of out, dq, dk and dv, which are sliced off),
with ``sm_scale`` taken from the true D, so the operator takes every D up to 128, as the
reference's does.
"""

from __future__ import annotations

import torch

from multimodal_tpu_torch.ops import launches

MAX_HEAD_DIM = 128
HEAD_DIM_STEP = 8  # the kernels' head dims are multiples of this
# the reference's dispatch rule (causal self-attention from this many keys up), kept so that
# both packages take the same path at the same shape; where the crossover lies on this card
# is measured in PERF.md
MIN_FLASH_SEQ = 2048
NEG_INF = -1e30
BLOCK_K = 256  # the plain versions' key tile: the reference kernels' own

launches.register("flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv")


def flash_supported(q_shape, k_shape, causal: bool = False) -> bool:
    """Gate for the automatic dispatch, the reference's: causal, equal lengths (the kernels'
    causal mask is top-left aligned, the plain path's bottom-right, so for sq != sk the
    dispatch would change semantics), long, and a head dimension the kernels take."""
    sq, d = q_shape[1], q_shape[3]
    return bool(causal) and d <= MAX_HEAD_DIM and k_shape[1] >= MIN_FLASH_SEQ and sq == k_shape[1]


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """[B, S, H, D] -> [B, H, S, D] (a view)."""
    return t.transpose(1, 2)


def _masked_logits(q, k, k0: int, causal: bool, sm_scale: float) -> torch.Tensor:
    """(q k^T) sm_scale in f32 for the key tile starting at key ``k0``, -1e30 where key >
    query under ``causal``. q [B, H, Sq, D], k [B, H, bk, D], both already widened."""
    s = (q @ k.transpose(-1, -2)) * sm_scale
    if causal:
        rows = torch.arange(q.shape[-2], device=q.device)[:, None]
        cols = k0 + torch.arange(k.shape[-2], device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, NEG_INF))
    return s


def _live_tiles(sq: int, sk: int, causal: bool, block_k: int):
    """Starts of the key tiles some query row sees, in rising order."""
    return range(0, min(sk, sq) if causal else sk, block_k)


def flash_attention_reference(q, k, v, *, causal: bool = False, sm_scale: float | None = None,
                              block_k: int = BLOCK_K):
    """Plain PyTorch version of the forward kernel over [B, S, H, D]: ``(out, lse)``, out
    [B, Sq, H, D] in v.dtype, lse [B, H, Sq] in f32 (f64 for f64 inputs). Walks the key tiles
    as the kernel does, so that its rounding points are the kernel's."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    f32, dt = _acc(q.dtype), q.dtype
    qh, kh, vh = (_heads_first(t).to(f32) for t in (q, k, v))
    b, h, sq, d = qh.shape
    sk = kh.shape[2]
    m = torch.full((b, h, sq, 1), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h, sq, d), dtype=f32, device=q.device)
    for k0 in _live_tiles(sq, sk, causal, block_k):
        s = _masked_logits(qh, kh[:, :, k0:k0 + block_k], k0, causal, sm_scale)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(dt).to(f32) @ vh[:, :, k0:k0 + block_k]
        m = m_new
    safe_l = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / safe_l).to(v.dtype).transpose(1, 2)
    return out, (m + torch.log(safe_l)).squeeze(-1)


def flash_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * out) in f32, [B, H, Sq]: elementwise work outside the kernels, as
    in the reference."""
    f32 = _acc(out.dtype)
    return (do.to(f32) * out.to(f32)).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_reference(q, k, v, out, lse, do, *, causal: bool = False,
                                  sm_scale: float | None = None, delta=None,
                                  block_k: int = BLOCK_K):
    """Plain PyTorch version of the two backward kernels: (dq, dk, dv) over [B, S, H, D].
    ``delta`` defaults to ``flash_delta(out, do)``; given, ``out`` is not read.

    Per key tile, step by step the TPU kernels: P = exp(s - lse) in f32; dv from P rounded to
    the compute dtype; dp = do v^T; ds = P (dp - delta) rounded; dq and dk take sm_scale times
    the tile's product in f32 and round once at the end."""
    sm_scale = q.shape[-1] ** -0.5 if sm_scale is None else sm_scale
    f32, dt = _acc(q.dtype), q.dtype
    qh, kh, vh, doh = (_heads_first(t).to(f32) for t in (q, k, v, do))
    sq, sk = qh.shape[2], kh.shape[2]
    delta = (flash_delta(out, do) if delta is None else delta)[..., None].to(f32)
    lse = lse[..., None].to(f32)
    dq, dk, dv = torch.zeros_like(qh), torch.zeros_like(kh), torch.zeros_like(vh)
    for k0 in _live_tiles(sq, sk, causal, block_k):
        tile = slice(k0, k0 + block_k)
        p = torch.exp(_masked_logits(qh, kh[:, :, tile], k0, causal, sm_scale) - lse)
        dv[:, :, tile] = p.to(dt).to(f32).transpose(-1, -2) @ doh
        dp = doh @ vh[:, :, tile].transpose(-1, -2)
        ds = (p * (dp - delta)).to(dt).to(f32)
        dq = dq + sm_scale * (ds @ kh[:, :, tile])
        dk[:, :, tile] = sm_scale * (ds.transpose(-1, -2) @ qh)
    return tuple(t.to(dt).transpose(1, 2) for t in (dq, dk, dv))


def _check_kernel_operands(q, k, v, like_q=(), rows=()):
    """What the CUDA kernels take: [B, S, H, D] tensors of one dtype (float32 or bfloat16) on
    one device, contiguous and 16-byte aligned (the kernels load them by 16-byte
    ``cp.async``), k and v of one shape that differs from q's in S at most, D a multiple of 8
    up to 128; ``like_q`` tensors (do) shaped as q, ``rows`` (lse, delta) float32 [B, H, Sq].
    Raises otherwise, naming the operand."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_attention takes [B, S, H, D], got {tuple(q.shape)}")
    b, sq, h, d = q.shape
    if d > MAX_HEAD_DIM or d % 8 or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"flash_attention kernel does not take q {tuple(q.shape)} with k "
                         f"{tuple(k.shape)} (D a multiple of 8 up to {MAX_HEAD_DIM})")
    named = [("q", q, q), ("k", k, k), ("v", v, k)] + [("do", t, q) for t in like_q]
    for name, t, want in named:
        if t.device != q.device or t.dtype != q.dtype or t.shape != want.shape:
            raise ValueError(
                f"flash_attention operand {name} {tuple(t.shape)} {t.dtype} on {t.device}: "
                f"expected {tuple(want.shape)} {q.dtype} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention operand {name} must be contiguous")
    for name, t in zip(("lse", "delta"), rows):
        if (t.device != q.device or t.dtype != torch.float32 or tuple(t.shape) != (b, h, sq)
                or not t.is_contiguous()):
            raise ValueError(f"flash_attention row statistics must be contiguous float32 "
                             f"[{b}, {h}, {sq}] on {q.device}, got {name} {tuple(t.shape)} "
                             f"{t.dtype}")
    for name, t, _ in named:
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention operand {name} must be 16-byte aligned "
                             f"(data_ptr {t.data_ptr():#x})")


def _launch(entry: str, kernel: str, q, k, pointers, causal: bool, sm_scale: float):
    from multimodal_tpu_torch.ops import _build

    b, sq, h, d = q.shape
    lib = _build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            0 if q.dtype == torch.float32 else 1, *(t.data_ptr() for t in pointers),
            b, sq, k.shape[1], h, d, int(causal), sm_scale, stream)
    _build.check(lib, err, f"{kernel} launch")
    launches.count(kernel)


def _scale(q, sm_scale):
    return float(q.shape[-1] ** -0.5 if sm_scale is None else sm_scale)


def _on_cuda(q: torch.Tensor) -> bool:
    if q.is_cuda:
        return True
    if q.device.type == "cpu":
        return False
    raise ValueError(f"flash_attention runs on cuda or cpu tensors, not {q.device}")


def flash_attention_fwd(q, k, v, *, causal: bool = False, sm_scale: float | None = None):
    """(out, lse): on a CUDA tensor the forward kernel (a build or launch error raises), on a
    CPU tensor its plain version."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return flash_attention_reference(q, k, v, causal=causal, sm_scale=sm_scale)
    _check_kernel_operands(q, k, v)
    b, sq, h, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _launch("mmt_flash_attention_fwd", "flash_attention_fwd", q, k, (q, k, v, out, lse), causal,
            sm_scale)
    return out, lse


def flash_attention_dq(q, k, v, do, lse, delta, *, causal: bool = False,
                       sm_scale: float | None = None):
    """dq from (q, k, v, do, lse, delta), the dQ kernel's own operands: on a CUDA tensor the
    kernel, on a CPU tensor the plain backward's dq."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return flash_attention_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                             sm_scale=sm_scale, delta=delta)[0]
    _check_kernel_operands(q, k, v, like_q=(do,), rows=(lse, delta))
    dq = torch.empty_like(q)
    _launch("mmt_flash_attention_dq", "flash_attention_dq", q, k, (q, k, v, do, lse, delta, dq),
            causal, sm_scale)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, *, causal: bool = False,
                        sm_scale: float | None = None):
    """(dk, dv) from the dK/dV kernel's own operands: on a CUDA tensor the kernel, on a CPU
    tensor the plain backward's."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda(q):
        return flash_attention_bwd_reference(q, k, v, None, lse, do, causal=causal,
                                             sm_scale=sm_scale, delta=delta)[1:]
    _check_kernel_operands(q, k, v, like_q=(do,), rows=(lse, delta))
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("mmt_flash_attention_dkv", "flash_attention_dkv", q, k,
            (q, k, v, do, lse, delta, dk, dv), causal, sm_scale)
    return dk, dv


def flash_attention_bwd(q, k, v, out, lse, do, *, causal: bool = False,
                        sm_scale: float | None = None):
    """(dq, dk, dv) of the operator. On a CUDA tensor ``delta`` is formed once and the dQ
    kernel and the dK/dV kernel run, one launch each; on a CPU tensor the plain backward."""
    kw = dict(causal=causal, sm_scale=sm_scale)
    if not _on_cuda(q):
        return flash_attention_bwd_reference(q, k, v, out, lse, do, **kw)
    delta = flash_delta(out, do)
    return (flash_attention_dq(q, k, v, do, lse, delta, **kw),
            *flash_attention_dkv(q, k, v, do, lse, delta, **kw))


def _pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` [B, S, H, D] zero-padded to head dim ``d`` >= D, contiguous."""
    t = t.contiguous()
    return t if t.shape[-1] == d else torch.nn.functional.pad(t, (0, d - t.shape[-1]))


class FlashAttention(torch.autograd.Function):
    """The operator with its gradient, as the reference's ``_flash_padded`` custom VJP: the
    forward saves (q, k, v, out, lse); the backward rebuilds the probability tiles from lse
    and emits dq, dk and dv. ``pad_head_dim`` (``flash_attention`` sets it for a CUDA tensor)
    zero-pads D up to a multiple of 8 for the kernels and slices the outputs back."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float, pad_head_dim: bool = False):
        d = q.shape[-1]
        padded = -(-d // HEAD_DIM_STEP) * HEAD_DIM_STEP if pad_head_dim else d
        q, k, v = (_pad_head_dim(t, padded) for t in (q, k, v))
        out, lse = flash_attention_fwd(q, k, v, causal=causal, sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale, ctx.head_dim = causal, sm_scale, d
        return out if padded == d else out[..., :d]

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        do = _pad_head_dim(do.to(v.dtype), q.shape[-1])
        grads = flash_attention_bwd(q, k, v, out, lse, do, causal=ctx.causal,
                                    sm_scale=ctx.sm_scale)
        dq, dk, dv = (g[..., :ctx.head_dim] for g in grads)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: float | None = None) -> torch.Tensor:
    """Flash attention over [B, S, H, D], differentiable; returns [B, Sq, H, D] in v.dtype.

    Any Sq and Sk (under ``causal`` the mask is top-left aligned: key <= query); head_dim at
    most 128 (on a CUDA tensor zero-padded to a multiple of 8 for the kernels, ``sm_scale``
    staying the true D's). A CUDA tensor goes to the hand-written kernels, forward and
    backward (a build or launch error raises), a CPU tensor to their plain versions."""
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {q.shape[-1]} > {MAX_HEAD_DIM} unsupported")
    return FlashAttention.apply(q, k, v, causal, _scale(q, sm_scale), _on_cuda(q))
