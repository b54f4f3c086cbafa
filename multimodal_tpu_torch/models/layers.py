"""Transformer building blocks (port of ``multimodal_tpu/models/layers.py``).

Parameters live in float32 and are cast to the compute ``dtype`` at use, as in the
reference; LayerNorm takes f32 statistics with compute-dtype arithmetic (``ln_rows``).
Dense weights keep the JAX ``[in, out]`` layout, which is also what the block-attention
kernel reads. Initialization takes an explicit ``torch.Generator`` (``init_weights``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_tpu_torch.ops.attention import attention
from multimodal_tpu_torch.ops.block_attention import (
    LN_EPS,
    block_attention,
    block_attn_supported,
    ln_rows,
)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(1.702 x) — CLIP's activation."""
    return x * torch.sigmoid(1.702 * x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh-approximate GELU (flax ``nn.gelu``'s default)."""
    return F.gelu(x, approximate="tanh")


def resolve_act(name: str):
    if name == "quick_gelu":
        return quick_gelu
    if name == "gelu":
        return gelu
    raise ValueError(f"unknown activation {name!r}")


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class Dense(nn.Module):
    """``y = x @ kernel + bias`` with kernel [in, out] ~ N(0, std^2) and bias = 0."""

    def __init__(self, in_dim: int, out_dim: int, std: float):
        super().__init__()
        self.std = std
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))

    def init_weights(self, generator: torch.Generator):
        normal_(self.kernel, self.std, generator)
        with torch.no_grad():
            self.bias.zero_()

    def cast(self, dtype: torch.dtype):
        return self.kernel.to(dtype), self.bias.to(dtype)


class LayerNorm(nn.Module):
    """LayerNorm with float32 statistics and compute-dtype arithmetic (``ln_rows``)."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def params(self):
        return self.weight, self.bias

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ln_rows(x, self.weight, self.bias, LN_EPS)


class MLP(nn.Module):
    def __init__(self, width: int, expansion: float = 4.0, act=quick_gelu,
                 dtype: torch.dtype = torch.float32, depth: int = 12):
        super().__init__()
        hidden = int(width * expansion)
        self.act = act
        self.dtype = dtype
        self.c_fc = Dense(width, hidden, (2 * width) ** -0.5)
        self.c_proj = Dense(hidden, width, (width ** -0.5) * ((2 * depth) ** -0.5))

    def forward(self, x, ln_params=None, residual: bool = False):
        """ln_params: the block's raw ln_2 (weight, bias), applied here; residual=True
        returns x + mlp(LN(x))."""
        if residual and ln_params is None:
            raise ValueError("residual=True requires ln_params (the pre-LN handoff)")
        x_in = x
        if ln_params is not None:
            x = ln_rows(x, ln_params[0], ln_params[1], LN_EPS)
        w1, b1 = self.c_fc.cast(self.dtype)
        w2, b2 = self.c_proj.cast(self.dtype)
        y = self.act(x @ w1 + b1) @ w2 + b2
        return x_in + y if residual else y


class MultiHeadAttention(nn.Module):
    """Self-attention with separate q/k/v projections. Shapes the block-attention operator
    takes (``block_attn_supported``) go through it — on a CUDA tensor that is the
    hand-written kernel — and the rest through plain ``attention``."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32, depth: int = 12):
        super().__init__()
        self.width, self.heads, self.causal, self.dtype = width, heads, causal, dtype
        attn_std = width ** -0.5
        out_std = (width ** -0.5) * ((2 * depth) ** -0.5)
        self.query = Dense(width, width, attn_std)
        self.key = Dense(width, width, attn_std)
        self.value = Dense(width, width, attn_std)
        self.out = Dense(width, width, out_std)

    def forward(self, x, ln_params=None, causal: bool = False, fuse_residual: bool = False):
        """ln_params: the block's raw ln_1 (weight, bias); fuse_residual=True returns
        x + attn(LN(x)) (requires ln_params)."""
        if fuse_residual and ln_params is None:
            raise ValueError("fuse_residual requires ln_params (the pre-LN handoff)")
        causal = causal or self.causal
        b, s = x.shape[:2]
        (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (
            m.cast(self.dtype) for m in (self.query, self.key, self.value, self.out))
        if block_attn_supported(b, s, self.width, self.heads):
            ln_kw = {} if ln_params is None else {"ln_scale": ln_params[0],
                                                  "ln_bias": ln_params[1]}
            return block_attention(x, wq, bq, wk, bk, wv, bv, wo, bo, heads=self.heads,
                                   causal=causal, residual=fuse_residual, **ln_kw)
        x_in = x
        if ln_params is not None:
            x = ln_rows(x, ln_params[0], ln_params[1], LN_EPS)
        head_dim = self.width // self.heads
        q, k, v = ((x @ w_ + b_).view(b, s, self.heads, head_dim)
                   for w_, b_ in ((wq, bq), (wk, bk), (wv, bv)))
        out = attention(q, k, v, causal=causal).reshape(b, s, self.width) @ wo + bo
        return x_in + out if fuse_residual else out


class ResidualBlock(nn.Module):
    """Pre-LN residual attention block; both residual adds ride the branches
    (``fuse_residual`` / ``residual``), as in the reference without LayerScale."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, causal: bool = False,
                 act=quick_gelu, dtype: torch.dtype = torch.float32, depth: int = 12):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, causal=causal, dtype=dtype, depth=depth)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_ratio, act=act, dtype=dtype, depth=depth)

    def forward(self, x, causal: bool = False):
        x = self.attn(x, ln_params=self.ln_1.params(), causal=causal, fuse_residual=True)
        return self.mlp(x, ln_params=self.ln_2.params(), residual=True)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 causal: bool = False, act=quick_gelu, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, mlp_ratio, causal=causal, act=act, dtype=dtype,
                          depth=layers)
            for _ in range(layers)
        )

    def forward(self, x, causal: bool = False):
        for blk in self.resblocks:
            x = blk(x, causal=causal)
        return x
