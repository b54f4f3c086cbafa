"""Transformer building blocks (port of ``multimodal_tpu/models/layers.py``).

Parameters live in float32 and are cast to the compute ``dtype`` at use, as in the
reference; LayerNorm takes f32 statistics with compute-dtype arithmetic (``ln_rows``).
Dense weights keep the JAX ``[in, out]`` layout, which is also what the block-attention
and block-MLP kernels read. Initialization takes an explicit ``torch.Generator``
(``init_weights``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multimodal_tpu_torch.ops.attention import attention
from multimodal_tpu_torch.ops.block_attention import (
    LN_EPS,
    block_attention,
    block_attn_supported,
    ln_rows,
)
from multimodal_tpu_torch.ops.block_mlp import block_mlp, block_mlp_supported


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


class PatchDropout(nn.Module):
    """FLIP-style token dropout: in training keep a random subset of the patch tokens of
    every example (the ``num_prefix`` leading tokens always survive), which shortens the
    sequence; in eval the identity. The keep set is the argsort of uniform noise drawn from
    an explicit ``torch.Generator``."""

    def __init__(self, rate: float, num_prefix: int = 1):
        super().__init__()
        self.rate, self.num_prefix = rate, num_prefix

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None):
        if not self.training or self.rate <= 0.0:
            return x
        if generator is None:
            raise ValueError("patch dropout in training needs an explicit torch.Generator")
        b, s, w = x.shape
        num_patches = s - self.num_prefix
        keep = max(1, int(num_patches * (1.0 - self.rate)))
        noise = torch.rand(b, num_patches, generator=generator, device=generator.device)
        keep_idx = noise.argsort(dim=-1)[:, :keep].to(x.device) + self.num_prefix  # [B, keep]
        kept = x.gather(1, keep_idx[..., None].expand(b, keep, w))
        return torch.cat([x[:, :self.num_prefix], kept], dim=1)


class LayerScale(nn.Module):
    """Per-channel learnable scale of a residual branch, gamma = ``init_values`` at init."""

    def __init__(self, width: int, init_values: float = 1e-5):
        super().__init__()
        self.init_values = init_values
        self.gamma = nn.Parameter(torch.full((width,), float(init_values)))

    def init_weights(self, generator: torch.Generator):
        with torch.no_grad():
            self.gamma.fill_(self.init_values)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype)


class MLP(nn.Module):
    """c_fc, activation, c_proj. With ``block_mlp`` (opt-in, as in the reference) and the
    pre-LN hand-off, a supported shape runs as the fused operator ``ops.block_mlp`` (on a
    CUDA tensor the hand-written kernels): LayerNorm, both products, the activation and the
    residual add in one differentiable call."""

    def __init__(self, width: int, expansion: float = 4.0, act=quick_gelu,
                 dtype: torch.dtype = torch.float32, depth: int = 12, block_mlp: bool = False):
        super().__init__()
        self.width, self.hidden = width, int(width * expansion)
        self.act = act
        self.dtype = dtype
        self.block_mlp = block_mlp
        self.c_fc = Dense(width, self.hidden, (2 * width) ** -0.5)
        self.c_proj = Dense(self.hidden, width, (width ** -0.5) * ((2 * depth) ** -0.5))

    def forward(self, x, ln_params=None, residual: bool = False):
        """ln_params: the block's raw ln_2 (weight, bias), applied here; residual=True
        returns x + mlp(LN(x))."""
        if residual and ln_params is None:
            raise ValueError("residual=True requires ln_params (the pre-LN handoff)")
        w1, b1 = self.c_fc.cast(self.dtype)
        w2, b2 = self.c_proj.cast(self.dtype)
        act_name = ("quick_gelu" if self.act is quick_gelu else "gelu" if self.act is gelu
                    else None)
        if (self.block_mlp and ln_params is not None
                and block_mlp_supported(self.width, self.hidden, act_name)):
            return block_mlp(x, w1, b1, w2, b2, ln_scale=ln_params[0], ln_bias=ln_params[1],
                             act=act_name, residual=residual)
        x_in = x
        if ln_params is not None:
            x = ln_rows(x, ln_params[0], ln_params[1], LN_EPS)
        y = self.act(x @ w1 + b1) @ w2 + b2
        return x_in + y if residual else y


class MultiHeadAttention(nn.Module):
    """Self-attention with separate q/k/v projections. Shapes the block-attention operator
    takes (``block_attn_supported``) go through it — on a CUDA tensor those are the
    hand-written block kernels — and the rest through ``attention``, which on a CUDA tensor
    takes the fused whole-sequence kernels where they apply. ``scale_heads`` (a learnable
    per-head scale on the attention output, ones at init) changes what lies between the
    core and the output projection, so it routes off the block operator."""

    def __init__(self, width: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32, depth: int = 12,
                 scale_heads: bool = False):
        super().__init__()
        self.width, self.heads, self.causal, self.dtype = width, heads, causal, dtype
        self.head_scale = nn.Parameter(torch.ones(heads)) if scale_heads else None
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
        if self.head_scale is None and block_attn_supported(b, s, self.width, self.heads):
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
        out = attention(q, k, v, causal=causal)
        if self.head_scale is not None:
            out = out * self.head_scale.to(out.dtype)[None, None, :, None]
        out = out.reshape(b, s, self.width) @ wo + bo
        return x_in + out if fuse_residual else out


class ResidualBlock(nn.Module):
    """Pre-LN residual attention block. Without LayerScale both residual adds ride the
    branches (``fuse_residual`` / ``residual``) and the MLP gets the raw ln_2 parameters, so
    it can run as the fused operator. With ``ls_init_value`` each branch value is scaled by
    its ``LayerScale`` before the add, so both adds happen here: the attention still takes
    the ln_1 hand-off (without its residual), the MLP runs behind a plain ln_2 and never
    reaches the fused operator."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, causal: bool = False,
                 act=quick_gelu, dtype: torch.dtype = torch.float32, depth: int = 12,
                 scale_heads: bool = False, ls_init_value: float | None = None,
                 block_mlp: bool = False):
        super().__init__()
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, causal=causal, dtype=dtype, depth=depth,
                                       scale_heads=scale_heads)
        self.ln_2 = LayerNorm(width)
        self.mlp = MLP(width, mlp_ratio, act=act, dtype=dtype, depth=depth, block_mlp=block_mlp)
        scaled = ls_init_value is not None
        self.ls_1 = LayerScale(width, ls_init_value) if scaled else None
        self.ls_2 = LayerScale(width, ls_init_value) if scaled else None

    def forward(self, x, causal: bool = False):
        if self.ls_1 is None:
            x = self.attn(x, ln_params=self.ln_1.params(), causal=causal, fuse_residual=True)
            return self.mlp(x, ln_params=self.ln_2.params(), residual=True)
        x = x + self.ls_1(self.attn(x, ln_params=self.ln_1.params(), causal=causal))
        return x + self.ls_2(self.mlp(self.ln_2(x)))


class Transformer(nn.Module):
    """A stack of residual blocks. With ``remat`` every block is checkpointed in training:
    its forward keeps only its input and runs again inside the backward."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 causal: bool = False, act=quick_gelu, dtype: torch.dtype = torch.float32,
                 scale_heads: bool = False, ls_init_value: float | None = None,
                 remat: bool = False, block_mlp: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, mlp_ratio, causal=causal, act=act, dtype=dtype,
                          depth=layers, scale_heads=scale_heads, ls_init_value=ls_init_value,
                          block_mlp=block_mlp)
            for _ in range(layers)
        )

    def forward(self, x, causal: bool = False):
        remat = self.remat and self.training and torch.is_grad_enabled()
        for blk in self.resblocks:
            if remat:
                # the blocks draw no random numbers, so no generator state is kept
                x = checkpoint(blk, x, causal, use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x, causal=causal)
        return x
