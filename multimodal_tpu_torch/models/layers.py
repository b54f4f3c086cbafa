"""Transformer building blocks (port of ``multimodal_tpu/models/layers.py``).

Parameters live in float32 and are cast to the compute ``dtype`` at use, as in the
reference; LayerNorm takes f32 statistics with compute-dtype arithmetic (``ln_rows``).
Dense weights keep the JAX ``[in, out]`` layout, which is also what the block-attention
and block-MLP kernels read. Initialization takes an explicit ``torch.Generator``
(``init_weights``). With ``lora_rank`` > 0 every attention and MLP projection carries a
low-rank adapter that is folded into its kernel at use (``Dense.cast``), so the kernels still
see one weight; a ``moe_experts`` block swaps its MLP for ``models.moe.MoEMLP``; ``int8_fwd``
runs the dense MLP's two products on the SwitchBack int8 GEMM (``ops.quant``).
"""

from __future__ import annotations

import math

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
from multimodal_tpu_torch.ops.quant import int8_dense_train


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
    """``y = x @ kernel + bias`` with kernel [in, out] ~ N(0, std^2) and bias = 0.

    ``lora_rank`` r > 0 adds a PEFT-style adapter, ``lora_a`` [in, r] ~ N(0, 1/r) and
    ``lora_b`` [r, out] = 0: the weight in use is kernel + (alpha / r) lora_a @ lora_b, formed
    in float32 and then cast (the reference's ``_DenseParams``), so the block kernels still
    see one weight and autograd carries their weight gradient into the adapters. The
    adapters draw from the generator in a pass of their own (``init_adapters``) after every
    base weight, so a model with adapters has the base weights of the same seed without."""

    def __init__(self, in_dim: int, out_dim: int, std: float, lora_rank: int = 0,
                 lora_alpha: float = 16.0):
        super().__init__()
        self.std, self.lora_rank, self.lora_alpha = std, lora_rank, lora_alpha
        self.kernel = nn.Parameter(torch.empty(in_dim, out_dim))
        self.bias = nn.Parameter(torch.zeros(out_dim))
        if lora_rank > 0:
            self.lora_a = nn.Parameter(torch.empty(in_dim, lora_rank))
            self.lora_b = nn.Parameter(torch.zeros(lora_rank, out_dim))

    def init_weights(self, generator: torch.Generator):
        normal_(self.kernel, self.std, generator)
        with torch.no_grad():
            self.bias.zero_()

    def init_adapters(self, generator: torch.Generator):
        normal_(self.lora_a, self.lora_rank ** -0.5, generator)
        with torch.no_grad():
            self.lora_b.zero_()

    def weight(self) -> torch.Tensor:
        """The float32 kernel in use: with adapters, kernel + (alpha / r) lora_a @ lora_b."""
        if self.lora_rank == 0:
            return self.kernel
        return self.kernel + (self.lora_alpha / self.lora_rank) * (self.lora_a @ self.lora_b)

    def cast(self, dtype: torch.dtype):
        return self.weight().to(dtype), self.bias.to(dtype)


def init_adapters(model: nn.Module, generator: torch.Generator):
    """Draw every LoRA adapter of ``model`` from ``generator``, in module order; called after
    all base weights are drawn."""
    for m in model.modules():
        if isinstance(m, Dense) and m.lora_rank > 0:
            m.init_adapters(generator)


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


class AttentionalPooler(nn.Module):
    """Learned-query cross-attention pooling: ``n_queries`` learnable queries (LayerNorm
    ``ln_q``) attend over the token sequence (LayerNorm ``ln_k``) through four dense
    projections with bias. sq = n_queries != sk, so ``attention`` takes its plain path."""

    def __init__(self, d_model: int, n_head: int = 8, n_queries: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.d_model, self.n_head, self.n_queries, self.dtype = d_model, n_head, n_queries, dtype
        self.query = nn.Parameter(torch.empty(n_queries, d_model))
        self.ln_q, self.ln_k = LayerNorm(d_model), LayerNorm(d_model)
        std = d_model ** -0.5
        self.query_proj, self.key_proj, self.value_proj, self.out_proj = (
            Dense(d_model, d_model, std) for _ in range(4))

    def init_weights(self, generator: torch.Generator):
        normal_(self.query, 1.0, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, W] -> [B, n_queries, W]."""
        b, head_dim = x.shape[0], self.d_model // self.n_head
        dense = lambda m, t: t @ m.kernel.to(self.dtype) + m.bias.to(self.dtype)  # noqa: E731
        heads = lambda t: t.reshape(b, t.shape[1], self.n_head, head_dim)  # noqa: E731
        q_in = self.ln_q(self.query.to(x.dtype).expand(b, self.n_queries, self.d_model))
        kv_in = self.ln_k(x)
        out = attention(heads(dense(self.query_proj, q_in)), heads(dense(self.key_proj, kv_in)),
                        heads(dense(self.value_proj, kv_in)))
        return dense(self.out_proj, out.reshape(b, self.n_queries, self.d_model))


class MLP(nn.Module):
    """c_fc, activation, c_proj. With ``block_mlp`` (opt-in, as in the reference) and the
    pre-LN hand-off, a supported shape runs as the fused operator ``ops.block_mlp`` (on a
    CUDA tensor the hand-written kernels): LayerNorm, both products, the activation and the
    residual add in one differentiable call. With ``int8_fwd`` both products are the
    SwitchBack int8 GEMM (``ops.quant.int8_dense_train``) on the float32 weights, each bias
    added as the reference's jitted ``int8_dense_train(x, w) + b`` adds it; it never takes
    the fused operator, whose products are not int8."""

    def __init__(self, width: int, expansion: float = 4.0, act=quick_gelu,
                 dtype: torch.dtype = torch.float32, depth: int = 12, block_mlp: bool = False,
                 lora_rank: int = 0, lora_alpha: float = 16.0, int8_fwd: bool = False):
        super().__init__()
        self.width, self.hidden = width, int(width * expansion)
        self.act = act
        self.dtype = dtype
        self.block_mlp = block_mlp
        self.int8_fwd = int8_fwd
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.c_fc = Dense(width, self.hidden, (2 * width) ** -0.5, **lora)
        self.c_proj = Dense(self.hidden, width, (width ** -0.5) * ((2 * depth) ** -0.5), **lora)

    def forward(self, x, ln_params=None, residual: bool = False):
        """ln_params: the block's raw ln_2 (weight, bias), applied here; residual=True
        returns x + mlp(LN(x))."""
        if residual and ln_params is None:
            raise ValueError("residual=True requires ln_params (the pre-LN handoff)")
        act_name = ("quick_gelu" if self.act is quick_gelu else "gelu" if self.act is gelu
                    else None)
        if (self.block_mlp and not self.int8_fwd and ln_params is not None
                and block_mlp_supported(self.width, self.hidden, act_name)):
            (w1, b1), (w2, b2) = self.c_fc.cast(self.dtype), self.c_proj.cast(self.dtype)
            return block_mlp(x, w1, b1, w2, b2, ln_scale=ln_params[0], ln_bias=ln_params[1],
                             act=act_name, residual=residual)
        x_in = x
        if ln_params is not None:
            x = ln_rows(x, ln_params[0], ln_params[1], LN_EPS)
        if self.int8_fwd:
            h = int8_dense_train(x, self.c_fc.weight(), self.c_fc.bias)
            y = int8_dense_train(self.act(h), self.c_proj.weight(), self.c_proj.bias)
        else:
            (w1, b1), (w2, b2) = self.c_fc.cast(self.dtype), self.c_proj.cast(self.dtype)
            y = self.act(x @ w1 + b1) @ w2 + b2
        return x_in + y if residual else y


class MultiHeadAttention(nn.Module):
    """Self-attention with separate q/k/v projections. Shapes the block-attention operator
    takes (``block_attn_supported``) go through it — on a CUDA tensor those are the
    hand-written block kernels — and the rest through ``attention``, which on a CUDA tensor
    takes the fused whole-sequence kernels or, for a long causal sequence, the flash kernels
    where they apply. ``scale_heads`` (a learnable per-head scale on the attention output,
    ones at init) changes what lies between the core and the output projection, so it routes
    off the block operator. ``scaled_cosine`` (cosine-similarity logits times a learnable
    per-head temperature, exp of a ``logit_scale`` that starts at log 10 and is clamped at
    log 100) changes the logits themselves, so it runs the plain attention path."""

    LOGIT_SCALE_MAX = 4.6052  # log(1 / 0.01)

    def __init__(self, width: int, heads: int, causal: bool = False,
                 dtype: torch.dtype = torch.float32, depth: int = 12,
                 scale_heads: bool = False, scaled_cosine: bool = False, lora_rank: int = 0,
                 lora_alpha: float = 16.0):
        super().__init__()
        self.width, self.heads, self.causal, self.dtype = width, heads, causal, dtype
        self.head_scale = nn.Parameter(torch.ones(heads)) if scale_heads else None
        self.logit_scale = (nn.Parameter(torch.full((heads,), math.log(10.0)))
                            if scaled_cosine else None)
        attn_std = width ** -0.5
        out_std = (width ** -0.5) * ((2 * depth) ** -0.5)
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.query = Dense(width, width, attn_std, **lora)
        self.key = Dense(width, width, attn_std, **lora)
        self.value = Dense(width, width, attn_std, **lora)
        self.out = Dense(width, width, out_std, **lora)

    def forward(self, x, ln_params=None, causal: bool = False, fuse_residual: bool = False):
        """ln_params: the block's raw ln_1 (weight, bias); fuse_residual=True returns
        x + attn(LN(x)) (requires ln_params)."""
        if fuse_residual and ln_params is None:
            raise ValueError("fuse_residual requires ln_params (the pre-LN handoff)")
        causal = causal or self.causal
        b, s = x.shape[:2]
        (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (
            m.cast(self.dtype) for m in (self.query, self.key, self.value, self.out))
        if (self.head_scale is None and self.logit_scale is None
                and block_attn_supported(b, s, self.width, self.heads)):
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
        if self.logit_scale is not None:
            unit = lambda t: t * torch.rsqrt(  # noqa: E731
                t.to(torch.float32).square().sum(-1, keepdim=True) + 1e-12).to(t.dtype)
            # exp(clamped per-head scale) folded into q; sqrt(D) undoes attention()'s 1/sqrt(D)
            temp = torch.exp(torch.clamp(self.logit_scale, max=self.LOGIT_SCALE_MAX))
            q = unit(q) * (temp * head_dim ** 0.5).to(q.dtype)[None, None, :, None]
            out = attention(q, unit(k), v, causal=causal, impl="xla")
        else:
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
    reaches the fused operator. With ``moe_experts`` > 0 the MLP is a ``MoEMLP``
    (``moe_mlp``), behind a plain ln_2 with the add here, and never the fused operator.
    ``int8_fwd`` goes to the dense MLP alone, as in the reference: a MoE MLP stays float."""

    def __init__(self, width: int, heads: int, mlp_ratio: float = 4.0, causal: bool = False,
                 act=quick_gelu, dtype: torch.dtype = torch.float32, depth: int = 12,
                 scale_heads: bool = False, ls_init_value: float | None = None,
                 block_mlp: bool = False, scaled_cosine: bool = False, moe_experts: int = 0,
                 moe_top_k: int = 1, moe_capacity_factor: float = 1.25, lora_rank: int = 0,
                 lora_alpha: float = 16.0, int8_fwd: bool = False):
        super().__init__()
        lora = dict(lora_rank=lora_rank, lora_alpha=lora_alpha)
        self.ln_1 = LayerNorm(width)
        self.attn = MultiHeadAttention(width, heads, causal=causal, dtype=dtype, depth=depth,
                                       scale_heads=scale_heads, scaled_cosine=scaled_cosine,
                                       **lora)
        self.ln_2 = LayerNorm(width)
        self.mlp = self.moe_mlp = None
        if moe_experts > 0:
            from multimodal_tpu_torch.models.moe import MoEMLP  # moe imports this module

            self.moe_mlp = MoEMLP(width, moe_experts, mlp_ratio, act=act, dtype=dtype,
                                  depth=depth, top_k=moe_top_k,
                                  capacity_factor=moe_capacity_factor)
        else:
            self.mlp = MLP(width, mlp_ratio, act=act, dtype=dtype, depth=depth,
                           block_mlp=block_mlp, int8_fwd=int8_fwd, **lora)
        scaled = ls_init_value is not None
        self.ls_1 = LayerScale(width, ls_init_value) if scaled else None
        self.ls_2 = LayerScale(width, ls_init_value) if scaled else None

    def forward(self, x, causal: bool = False):
        if self.ls_1 is None:
            x = self.attn(x, ln_params=self.ln_1.params(), causal=causal, fuse_residual=True)
        else:
            x = x + self.ls_1(self.attn(x, ln_params=self.ln_1.params(), causal=causal))
        if self.moe_mlp is not None:
            y = self.moe_mlp(self.ln_2(x))
        elif self.ls_1 is None:
            return self.mlp(x, ln_params=self.ln_2.params(), residual=True)
        else:
            y = self.mlp(self.ln_2(x))
        return x + (y if self.ls_2 is None else self.ls_2(y))


class Transformer(nn.Module):
    """A stack of residual blocks. With ``remat`` every block is checkpointed in training:
    its forward keeps only its input and runs again inside the backward. With
    ``moe_experts`` > 0 block i is a MoE block where ``i % moe_every == moe_every - 1``.
    ``int8_fwd`` puts every dense MLP on the SwitchBack int8 GEMMs."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 causal: bool = False, act=quick_gelu, dtype: torch.dtype = torch.float32,
                 scale_heads: bool = False, ls_init_value: float | None = None,
                 remat: bool = False, block_mlp: bool = False, scaled_cosine: bool = False,
                 moe_experts: int = 0, moe_every: int = 2, moe_top_k: int = 1,
                 moe_capacity_factor: float = 1.25, lora_rank: int = 0,
                 lora_alpha: float = 16.0, int8_fwd: bool = False):
        super().__init__()
        self.remat = remat
        self.resblocks = nn.ModuleList(
            ResidualBlock(width, heads, mlp_ratio, causal=causal, act=act, dtype=dtype,
                          depth=layers, scale_heads=scale_heads, ls_init_value=ls_init_value,
                          block_mlp=block_mlp, scaled_cosine=scaled_cosine,
                          moe_experts=moe_experts if i % moe_every == moe_every - 1 else 0,
                          moe_top_k=moe_top_k, moe_capacity_factor=moe_capacity_factor,
                          lora_rank=lora_rank, lora_alpha=lora_alpha, int8_fwd=int8_fwd)
            for i in range(layers)
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
