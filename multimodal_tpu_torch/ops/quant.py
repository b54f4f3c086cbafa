"""Int8 W8A8 products: the SwitchBack training GEMM and the serving path's quantized dense
(port of ``multimodal_tpu/ops/quant.py``).

Symmetric dynamic quantization, no calibration: a row of activations (or of the gradient
``g``) gets one float32 scale, ``max(amax, 1e-12) / 127``, and its codes are
``clip(round_half_even(x / scale), -127, 127)`` as int8; a weight gets one scale per output
column, the row quantization of its transpose. The int8 x int8 product accumulates in int32
and is rescaled in float32 as ``(acc * sx) * sw``, in that order, then rounded once; a bias
(the serving path's) joins the second multiply in one fused multiply-add, as XLA contracts
the reference's ``acc * sx * sw + bias``.

Two hand-written kernels (``ops/csrc/quant.cu``) carry the elementwise work: the row quantize
and the rescale. On a CUDA tensor the wrappers launch them (a build or launch error raises);
on a CPU tensor they run ``quantize_rows_reference`` and ``rescale_reference``, the plain
PyTorch versions, bit for bit the same arithmetic. The int8 product itself is a library call,
``torch._int_mm`` (cuBLASLt on the card), as the reference leaves its int32 ``dot_general`` to
XLA; so is the full-precision weight gradient of the training GEMM.

The scale has two forms, because the reference computes it in two ways. Under ``jax.jit``
XLA rewrites ``m / 127.0`` as ``m * float32(1/127)`` ("reciprocal", the train step and the
jitted encodes: every activation, gradient and weight quantize of ``int8_dense_train`` and the
activations of ``int8_matmul``); run op by op, as ``inference_quant.quantize_clip_params`` is
at load time, it stays a true division ("divide"). The two differ by an ulp at some rows,
which moves codes, so each call site names its form. The element step ``x / scale`` is a true
division in both.

Layouts: a quantized weight is ``[out, in]`` (K-contiguous, the "TN" operand cuBLASLt's int8
GEMM takes), the transpose of the reference's ``[in, out]`` ``kernel_q``.
"""

from __future__ import annotations

import numpy as np
import torch

from multimodal_tpu_torch.ops import launches

FORMS = ("reciprocal", "divide")
INV_127 = float(np.float32(1.0) / np.float32(127.0))  # float32(1/127), the jitted constant
SCALE_FLOOR = 1e-12
QMAX = 127
# torch._int_mm on the card takes M > 16 and K, N multiples of 8; M is padded with zero rows
# to a multiple of this and the rows sliced back out
PAD_ROWS = 32

launches.register("quantize_rows", "int8_rescale")


def _check_form(form: str):
    if form not in FORMS:
        raise ValueError(f"scale form must be one of {FORMS}, got {form!r}")


def row_scale(amax: torch.Tensor, form: str) -> torch.Tensor:
    """The float32 scale of rows whose largest magnitude is ``amax``: ``max(amax, 1e-12)``
    times float32(1/127) ("reciprocal") or divided by 127 ("divide"). The divisor is a tensor
    on amax's device: a Python-scalar divisor on a CUDA tensor becomes a reciprocal
    multiply."""
    _check_form(form)
    m = torch.clamp(amax, min=SCALE_FLOOR)
    if form == "reciprocal":
        return m * torch.full_like(m, INV_127)
    return m / torch.full_like(m, float(QMAX))


def quantize_rows_reference(x: torch.Tensor, form: str = "reciprocal"):
    """Plain version of the row-quantize kernel: x [..., C] float32 or bfloat16 -> (int8
    codes [..., C], float32 scales [...]), the reference's ``quantize_rows``."""
    x32 = x.to(torch.float32)
    scale = row_scale(x32.abs().amax(dim=-1), form)
    codes = torch.clamp(torch.round(x32 / scale[..., None]), -QMAX, QMAX).to(torch.int8)
    return codes, scale


def _check_rows(x: torch.Tensor, what: str):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} takes float32 or bfloat16, got {x.dtype}")
    if x.dim() < 1 or x.shape[-1] < 1 or x.numel() == 0:
        raise ValueError(f"{what} takes a non-empty [..., C] tensor, got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{what} operands must be contiguous and 16-byte aligned")


def _quantize_rows_cuda(x: torch.Tensor, form: str):
    from multimodal_tpu_torch.ops import _build

    _check_form(form)
    _check_rows(x, "quantize_rows kernel")
    cols = x.shape[-1]
    rows = x.numel() // cols
    codes = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    scale = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        err = lib.mmt_quantize_rows(0 if x.dtype == torch.float32 else 1, x.data_ptr(),
                                    codes.data_ptr(), scale.data_ptr(), rows, cols,
                                    FORMS.index(form), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "quantize_rows launch")
    launches.count("quantize_rows")
    return codes, scale


def quantize_rows(x: torch.Tensor, form: str = "reciprocal"):
    """x [..., C] -> (int8 codes [..., C], float32 scales [...]): on a CUDA tensor the
    row-quantize kernel (a build or launch error raises), on a CPU tensor its plain
    version."""
    if x.is_cuda:
        return _quantize_rows_cuda(x.contiguous(), form)
    if x.device.type == "cpu":
        return quantize_rows_reference(x, form)
    raise ValueError(f"quantize_rows runs on cuda or cpu tensors, not {x.device}")


def quantize_weight(w: torch.Tensor, form: str = "divide"):
    """[in, out] float weight -> (int8 [out, in], float32 [out] per-column scales): the row
    quantize of its transpose. The default form is the load-time one (the reference's
    ``quantize_clip_params`` runs eagerly)."""
    return quantize_rows(w.to(torch.float32).t().contiguous(), form)


def int8_product(aq: torch.Tensor, bq: torch.Tensor) -> torch.Tensor:
    """aq [M, K] @ bq [N, K]^T, int8 x int8 -> int32 [M, N], exact. ``torch._int_mm`` with
    the second operand column-major; on the card M is padded with zero rows to a multiple of
    ``PAD_ROWS`` (its kernel takes M > 16 only) and K and N must be multiples of 8."""
    m, k = aq.shape
    n = bq.shape[0]
    if aq.dtype != torch.int8 or bq.dtype != torch.int8 or bq.shape[1] != k:
        raise ValueError(f"int8_product takes int8 [M, K] and [N, K], got {aq.dtype} "
                         f"{tuple(aq.shape)} and {bq.dtype} {tuple(bq.shape)}")
    if aq.is_cuda:
        if k % 8 or n % 8:
            raise ValueError(f"the card's int8 product takes K and N multiples of 8, got "
                             f"K={k} N={n}")
        pad = -m % PAD_ROWS
        if pad:
            aq = torch.cat([aq, aq.new_zeros(pad, k)])
        return torch._int_mm(aq, bq.t())[:m]
    return torch._int_mm(aq, bq.t())


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a fused multiply-add gives it, in plain
    torch ops: the product is exact in float64, TwoSum keeps the sum's rounding error, and a
    rounding to odd in float64 (53 bits >= 24 + 2) makes the final rounding to float32 the
    one rounding of the exact value."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    hi = p + c
    t = hi - p
    lo = (p - (hi - t)) + (c - t)
    even = (hi.view(torch.int64) & 1) == 0
    toward = torch.where(lo > 0, torch.full_like(hi, float("inf")),
                         torch.full_like(hi, float("-inf")))
    hi = torch.where((lo != 0) & even, torch.nextafter(hi, toward), hi)
    return hi.to(torch.float32)


def rescale_reference(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
                      bias: torch.Tensor | None = None, *, out_dtype: torch.dtype):
    """Plain version of the rescale kernel: int32 acc [M, N], sx [M], sw [N] ->
    ``(float(acc) * sx) * sw`` in float32 rounded to ``out_dtype``; with a bias the second
    multiply and the bias add are one fused multiply-add, as XLA contracts the reference's
    ``acc * sx * sw + bias``."""
    y = acc.to(torch.float32) * sx[:, None]
    if bias is None:
        return (y * sw[None, :]).to(out_dtype)
    return fma_f32(y, sw[None, :].expand_as(y), bias.to(torch.float32).expand_as(y)).to(out_dtype)


def _rescale_cuda(acc, sx, sw, bias, out_dtype):
    from multimodal_tpu_torch.ops import _build

    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int8_rescale kernel writes float32 or bfloat16, not {out_dtype}")
    m, n = acc.shape
    operands = [(acc, torch.int32, (m, n)), (sx, torch.float32, (m,)),
                (sw, torch.float32, (n,))]
    if bias is not None:
        operands.append((bias, torch.float32, (n,)))
    for t, dtype, shape in operands:
        if t.device != acc.device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"int8_rescale operand {tuple(t.shape)} {t.dtype} on {t.device}: "
                             f"expected {shape} {dtype} on {acc.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("int8_rescale operands must be contiguous and 16-byte aligned")
    if n % 4:
        raise ValueError(f"int8_rescale kernel takes N a multiple of 4, got {n}")
    y = torch.empty((m, n), dtype=out_dtype, device=acc.device)
    lib = _build.load()
    with torch.cuda.device(acc.device):
        err = lib.mmt_int8_rescale(0 if out_dtype == torch.float32 else 1, acc.data_ptr(),
                                   sx.data_ptr(), sw.data_ptr(),
                                   None if bias is None else bias.data_ptr(), y.data_ptr(), m, n,
                                   torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "int8_rescale launch")
    launches.count("int8_rescale")
    return y


def rescale(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
            bias: torch.Tensor | None = None, *, out_dtype: torch.dtype) -> torch.Tensor:
    """int32 acc [M, N] -> ``(acc * sx) * sw [+ bias]`` in float32, rounded once to
    ``out_dtype``: on a CUDA tensor the rescale kernel, on a CPU tensor its plain version.
    ``bias`` may be any float dtype; it is added in float32 by one fused multiply-add with
    the ``sw`` multiply."""
    if bias is not None:
        bias = bias.to(torch.float32).contiguous()
    if acc.is_cuda:
        return _rescale_cuda(acc.contiguous(), sx.contiguous(), sw.contiguous(), bias,
                             out_dtype)
    if acc.device.type == "cpu":
        return rescale_reference(acc, sx, sw, bias, out_dtype=out_dtype)
    raise ValueError(f"int8_rescale runs on cuda or cpu tensors, not {acc.device}")


def _dense(xq, sx, wq, sw, bias, out_dtype):
    """The int8 product of flat codes and its rescale: [M, K] x [N, K] -> [M, N]."""
    return rescale(int8_product(xq, wq), sx, sw, bias, out_dtype=out_dtype)


def weight_grad(x2: torch.Tensor, g2: torch.Tensor) -> torch.Tensor:
    """dw = x2^T g2 over the token rows, summed and returned in float32 (never a bfloat16
    product rounded to bfloat16): bfloat16 operands go to ``torch.mm`` with a float32 output
    on the card and are widened exactly on the CPU."""
    if x2.dtype == torch.float32:
        return x2.t() @ g2.to(torch.float32)
    if x2.is_cuda:
        return torch.mm(x2.t(), g2, out_dtype=torch.float32)
    return x2.to(torch.float32).t() @ g2.to(torch.float32)


class Int8DenseTrain(torch.autograd.Function):
    """The SwitchBack GEMM (the reference's ``int8_dense_train`` custom VJP) with the bias the
    model adds after it: the forward and dx on the int8 path, every scale in the "reciprocal"
    (jitted) form; dw in full precision. Saves x and w."""

    @staticmethod
    def forward(ctx, x, w, b):
        k = x.shape[-1]
        xq, sx = quantize_rows(x.reshape(-1, k), "reciprocal")
        wq, sw = quantize_weight(w, "reciprocal")
        fused = b is not None and x.dtype == torch.float32
        y = _dense(xq, sx, wq, sw, b if fused else None, x.dtype)
        if b is not None and not fused:
            y = y + b.to(x.dtype)
        ctx.save_for_backward(x, w)
        ctx.bias_dtype = None if b is None else b.dtype
        return y.reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k, n = w.shape
        g2 = g.reshape(-1, n)
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            # g per row, w^T per column = w per row ([in, out]: the [N, K] operand of g @ w^T)
            gq, sg = quantize_rows(g2, "reciprocal")
            wq, swt = quantize_rows(w.to(torch.float32), "reciprocal")
            dx = _dense(gq, sg, wq, swt, None, x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = weight_grad(x.reshape(-1, k), g2).to(w.dtype)
        if ctx.bias_dtype is not None and ctx.needs_input_grad[2]:
            db = g2.sum(dim=0).to(ctx.bias_dtype)
        return dx, dw, db


def int8_dense_train(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor | None = None) -> torch.Tensor:
    """Training-path int8 GEMM, ``x @ w [+ b]``: x [..., in] float32 or bfloat16, w [in, out]
    float32 (the master weight, not a copy rounded to x's dtype) -> [..., out] in x.dtype. The
    product is rounded once from the float32 rescale; the bias follows it as the reference's
    jitted ``int8_dense_train(x, w) + b.astype(x.dtype)`` computes it: in bfloat16 added to
    the rounded product, in float32 (where that rounding is no rounding) contracted by XLA
    into the rescale's last multiply, one fused multiply-add. The backward gives dx in x.dtype
    from the int8 path, dw in float32 from the full-precision product over the flattened
    tokens, and db as the column sum of the incoming gradient."""
    return Int8DenseTrain.apply(x, w, b)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor, wscale: torch.Tensor,
                bias: torch.Tensor | None = None,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """y = x @ dequant(wq) [+ bias] on the int8 path, forward only: x [..., in], wq [out, in]
    int8 and wscale [out] float32 from ``quantize_weight``. The activations are quantized per
    row in the "reciprocal" form (the reference runs its encoders jitted); the bias is added
    in float32, fused with the weight-scale multiply (``rescale``), and the sum rounded once
    to ``out_dtype``."""
    k = x.shape[-1]
    xq, sx = quantize_rows(x.reshape(-1, k), "reciprocal")
    y = _dense(xq, sx, wq, wscale, bias, out_dtype)
    return y.reshape(*x.shape[:-1], wq.shape[0])
