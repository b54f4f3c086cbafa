"""Whole-block attention for short-to-medium sequences (S <= 320): QKV projections +
per-head softmax(QK^T)V + output projection in one operator.

Port of ``multimodal_tpu/ops/block_attention.py`` (forward, non-LN form). On a CUDA tensor
``block_attention`` launches the hand-written Hopper kernel
(``ops/csrc/block_attention_fwd.cu``) and nothing else; on a CPU tensor it runs
``block_attention_reference``, the plain PyTorch version of the same math, which is also
what the on-card comparison holds the kernel to. The pre-attention LayerNorm runs as the
``ln_rows`` pre-pass and the residual add after the kernel, as the reference does at S<=128.

Numerics kept from the TPU kernel: projections accumulate in f32 with the bias added in f32
before one rounding to the compute dtype; logits and softmax in f32 with the finite -1e30
causal mask (col <= row); probabilities and the attention output rounded to the compute
dtype before their next product.
"""

from __future__ import annotations

import threading

import torch

NEG_INF = -1e30
MAX_BLOCK_SEQ = 320
LN_EPS = 1e-5

_count_lock = threading.Lock()
_launches = {"block_attention_fwd": 0}


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


def _proj(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., W] @ [W, N] + b with f32 accumulation and f32 bias, rounded to a.dtype."""
    return (a.to(torch.float32) @ w.to(torch.float32) + b.to(torch.float32)).to(a.dtype)


def block_attention_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the kernel: x [B,S,W], weights [W,W] ([in,out]), biases [W]."""
    b, s, w = x.shape
    d = w // heads
    dt = x.dtype

    def split(t):  # [B,S,W] -> [B,H,S,D]
        return t.view(b, s, heads, d).transpose(1, 2)

    q, k, v = split(_proj(x, wq, bq)), split(_proj(x, wk, bk)), split(_proj(x, wv, bv))
    logits = (q.to(torch.float32) @ k.to(torch.float32).transpose(-1, -2)) * d ** -0.5
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        logits = torch.where(keep, logits, torch.full_like(logits, NEG_INF))
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(dt)
    attn = (p.to(torch.float32) @ v.to(torch.float32)).to(dt)
    return _proj(attn.transpose(1, 2).reshape(b, s, w), wo, bo)


def _block_attention_cuda(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int,
                          causal: bool) -> torch.Tensor:
    from multimodal_tpu_torch.ops import _build

    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"block_attention kernel takes float32 or bfloat16, got {x.dtype}")
    b, s, w = x.shape
    if not block_attn_supported(b, s, w, heads):
        raise ValueError(f"block_attention kernel does not take B={b} S={s} W={w} H={heads}")
    args = (x, wq, bq, wk, bk, wv, bv, wo, bo)
    for t, shape in zip(args, [(b, s, w)] + [(w, w), (w,)] * 4):
        if t.device != x.device or t.dtype != x.dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"block_attention operand {tuple(t.shape)} {t.dtype} on {t.device}: expected "
                f"{shape} {x.dtype} on {x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("block_attention operands must be contiguous and 16-byte aligned")
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


def block_attention(x, wq, bq, wk, bk, wv, bv, wo, bo, *, heads: int, causal: bool = False,
                    ln_scale=None, ln_bias=None, residual: bool = False) -> torch.Tensor:
    """Fused QKV projection + multi-head attention + output projection.

    x: [B, S, W]; weights [W, W] in the [in, out] layout, biases [W], all in x.dtype.
    With ``ln_scale``/``ln_bias``, x is the pre-LN residual stream and the LayerNorm runs
    first (``ln_rows``); with ``residual=True`` (requires them) the result is
    ``x + attn(LN(x))``. A CUDA tensor goes to the hand-written kernel (a build or launch
    error raises), a CPU tensor to ``block_attention_reference``."""
    if residual and ln_scale is None:
        raise ValueError("residual=True requires the pre-LN form (ln_scale)")
    x_raw = x
    if ln_scale is not None:
        x = ln_rows(x, ln_scale, ln_bias, LN_EPS)
    if x.is_cuda:
        out = _block_attention_cuda(x, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads,
                                    causal=causal)
    elif x.device.type == "cpu":
        out = block_attention_reference(x, wq, bq, wk, bk, wv, bv, wo, bo, heads=heads,
                                        causal=causal)
    else:
        raise ValueError(f"block_attention runs on cuda or cpu tensors, not {x.device}")
    return x_raw + out if residual else out
