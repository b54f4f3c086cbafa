"""CLIP-prefix captioning: a GPT-2 LM behind a mapper from the CLIP embedding, with a
KV-cached decode (port of ``multimodal_tpu/models/captioner.py``).

  * ``GPT2``: learned positions, pre-LN blocks, GPT-2's tanh GELU, the weight-tied LM head;
    over input embeddings (the captioner feeds soft prefixes, not token ids). Its attention
    is plain torch, as the reference's einsum: float32 logits, a -1e30 mask, probabilities
    cast to the compute dtype before P.V. Its LayerNorms take float32 statistics with
    var = E[x^2] - mean^2 (flax's), eps 1e-5.
  * ``TransformerMapper``: the CLIP embedding projected to ``clip_length`` tokens beside
    ``prefix_length`` learned constants, run through a ``models.layers.Transformer`` with
    ReLU; the constants' outputs are the prefix. Its attention takes the block operator
    wherever ``block_attn_supported`` admits the shape (on a CUDA tensor the hand-written
    block kernels); ReLU keeps its MLP off the fused MLP operator, as in the reference.
  * ``ClipCaptionModel``: prefix ++ token embeddings -> the masked next-token cross entropy;
    ``generate`` decodes one token a step against a static cache of [B, prefix + max_len, H,
    D] per layer, written in place at the step's position, with the mask k_pos <= q_pos over
    the whole cache: greedy at temperature 0, else the Gumbel-max draw of
    ``logits / temperature`` (``ops.draws.gumbel``); a row that has emitted EOS emits 0 after
    it.

Parameters keep the reference's layouts and, where it can, its names (``[in, out]``
kernels, ``ln_*.scale``, ``wte.embedding``, ``wpe``, ``prefix_const``), so that
``caption_params_to_port`` carries a flax tree across and ``load_hf_gpt2`` a HuggingFace
``GPT2LMHeadModel`` state dict. Weights are drawn on the CPU from a ``torch.Generator``
seeded with ``seed`` with the reference's init distributions, then moved to ``device``: the
GPU unless the caller asks for ``"cpu"``.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Any, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from multimodal_tpu_torch.models.layers import Dense, Transformer, normal_
from multimodal_tpu_torch.ops import draws


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_positions: int = 1024
    width: int = 768
    layers: int = 12
    heads: int = 12


TINY_GPT2 = GPT2Config(vocab_size=512, max_positions=128, width=64, layers=2, heads=2)


def _lecun_(t: torch.Tensor, generator: torch.Generator):
    """flax's default Dense kernel init: a normal of variance 1 / fan_in truncated at two
    standard deviations (the truncated normal's own deviation corrected, as flax does)."""
    std = (1.0 / t.shape[0]) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def _init_dense(d: Dense, generator: torch.Generator):
    _lecun_(d.kernel, generator)
    with torch.no_grad():
        d.bias.zero_()


class FlaxLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=float32)``: the input in float32, mean and
    var = max(E[x^2] - mean^2, 0), then (x - mean) * (rsqrt(var + eps) * scale) + bias, all
    in float32."""

    def __init__(self, width: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = nn.Parameter(torch.zeros(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        var = torch.clamp(x.square().mean(dim=-1, keepdim=True) - mean.square(), min=0.0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.scale) + self.bias


def _dense(d: Dense, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x @ d.kernel.to(dtype) + d.bias.to(dtype)


def gpt2_gelu(h: torch.Tensor) -> torch.Tensor:
    """GPT-2's GELU in its explicit tanh form."""
    return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h ** 3)))


class GPT2Block(nn.Module):
    def __init__(self, cfg: GPT2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        w = cfg.width
        self.ln_1 = FlaxLayerNorm(w)
        self.attn_qkv = Dense(w, 3 * w, 0.0)
        self.attn_out = Dense(w, w, 0.0)
        self.ln_2 = FlaxLayerNorm(w)
        self.mlp_fc = Dense(w, 4 * w, 0.0)
        self.mlp_proj = Dense(4 * w, w, 0.0)

    def init_weights(self, generator: torch.Generator):
        for d in (self.attn_qkv, self.attn_out, self.mlp_fc, self.mlp_proj):
            _init_dense(d, generator)

    def forward(self, x: torch.Tensor, cache=None, position: int = 0) -> torch.Tensor:
        """x [B, T, W]. With ``cache`` ((k, v), each [B, max, H, D]) x is the suffix at
        ``position``: its k and v are written into the cache in place and the queries attend
        over the whole cache, keys after their own position masked."""
        c, dt = self.cfg, self.dtype
        head_dim = c.width // c.heads
        b, t = x.shape[:2]
        h = self.ln_1(x).to(dt)
        q, k, v = (z.reshape(b, t, c.heads, head_dim)
                   for z in _dense(self.attn_qkv, h, dt).split(c.width, dim=-1))
        if cache is not None:
            ck, cv = cache
            ck[:, position:position + t] = k.to(ck.dtype)
            cv[:, position:position + t] = v.to(cv.dtype)
            kk, vv = ck, cv
            k_pos = torch.arange(ck.shape[1], device=x.device)[None, :]
            q_pos = position + torch.arange(t, device=x.device)[:, None]
            mask = k_pos <= q_pos  # [T, K]
        else:
            kk, vv = k, v
            mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        # float32 logits (the products of compute-dtype values, summed in float32)
        logits = torch.matmul(q.to(torch.float32).transpose(1, 2),
                              kk.to(torch.float32).permute(0, 2, 3, 1)) / math.sqrt(head_dim)
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dt)
        attn = torch.matmul(probs, vv.transpose(1, 2)).transpose(1, 2).reshape(b, t, c.width)
        x = x + _dense(self.attn_out, attn, dt)
        h = self.ln_2(x).to(dt)
        h = gpt2_gelu(_dense(self.mlp_fc, h, dt))
        return x + _dense(self.mlp_proj, h, dt)


class TokenEmbed(nn.Module):
    """flax ``nn.Embed``: the table cast to the compute dtype, then gathered."""

    def __init__(self, vocab: int, width: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(vocab, width))

    def forward(self, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self.embedding.to(dtype)[tokens]


class GPT2(nn.Module):
    """GPT-2 over input embeddings."""

    def __init__(self, cfg: GPT2Config, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.wte = TokenEmbed(cfg.vocab_size, cfg.width)
        self.wpe = nn.Parameter(torch.empty(cfg.max_positions, cfg.width))
        self.h = nn.ModuleList(GPT2Block(cfg, dtype) for _ in range(cfg.layers))
        self.ln_f = FlaxLayerNorm(cfg.width)

    def init_weights(self, generator: torch.Generator):
        normal_(self.wte.embedding, 0.02, generator)
        normal_(self.wpe, 0.01, generator)
        for blk in self.h:
            blk.init_weights(generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.wte(tokens, self.dtype)

    def forward(self, embeds: torch.Tensor, caches=None, position: int = 0):
        """embeds [B, T, W] -> (float32 logits [B, T, vocab], the caches, written in place)."""
        t = embeds.shape[1]
        x = embeds + self.wpe[position:position + t].to(self.dtype)
        for i, blk in enumerate(self.h):
            x = blk(x, cache=None if caches is None else caches[i], position=position)
        x = self.ln_f(x)
        return x @ self.wte.embedding.to(torch.float32).T, caches  # the weight-tied head

    def init_cache(self, batch: int, max_len: int) -> list:
        c = self.cfg
        shape = (batch, max_len, c.heads, c.width // c.heads)
        dev = self.wpe.device
        return [(torch.zeros(shape, dtype=self.dtype, device=dev),
                 torch.zeros(shape, dtype=self.dtype, device=dev)) for _ in range(c.layers)]


class TransformerMapper(nn.Module):
    """CLIP embedding -> ``prefix_length`` GPT-2 soft tokens."""

    def __init__(self, clip_dim: int, width: int, prefix_length: int, clip_length: int = 10,
                 layers: int = 8, heads: int = 8, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.width, self.prefix_length, self.clip_length = width, prefix_length, clip_length
        self.dtype = dtype
        self.proj = Dense(clip_dim, clip_length * width, 0.0)
        self.prefix_const = nn.Parameter(torch.empty(prefix_length, width))
        self.transformer = Transformer(width, layers, heads, act=F.relu, dtype=dtype)

    def init_weights(self, generator: torch.Generator):
        _init_dense(self.proj, generator)
        normal_(self.prefix_const, 0.02, generator)
        for m in self.transformer.modules():
            if hasattr(m, "init_weights"):
                m.init_weights(generator)

    def forward(self, clip_embed: torch.Tensor) -> torch.Tensor:
        b = clip_embed.shape[0]
        x = _dense(self.proj, clip_embed.to(self.dtype), self.dtype)
        x = x.reshape(b, self.clip_length, self.width)
        const = self.prefix_const.to(self.dtype).expand(b, self.prefix_length, self.width)
        x = self.transformer(torch.cat([x, const], dim=1))
        return x[:, self.clip_length:]


class MLPMapper(nn.Module):
    """The MLP mapper: Dense, tanh, Dense (flax ``nn.Sequential``'s ``layers_0`` and
    ``layers_2``)."""

    def __init__(self, clip_dim: int, width: int, prefix_length: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.layers_0 = Dense(clip_dim, (width * prefix_length) // 2, 0.0)
        self.layers_2 = Dense((width * prefix_length) // 2, width * prefix_length, 0.0)

    def init_weights(self, generator: torch.Generator):
        _init_dense(self.layers_0, generator)
        _init_dense(self.layers_2, generator)

    def forward(self, clip_embed: torch.Tensor) -> torch.Tensor:
        h = torch.tanh(_dense(self.layers_0, clip_embed.to(self.dtype), self.dtype))
        return _dense(self.layers_2, h, self.dtype)


class ClipCaptionModel(nn.Module):
    """Prefix captioning LM, built and initialized on the CPU from ``seed``, then moved to
    ``device`` (the GPU unless the caller asks for ``"cpu"``; without a CUDA device that
    raises)."""

    def __init__(self, gpt2: GPT2Config = GPT2Config(), clip_dim: int = 512,
                 prefix_length: int = 10, clip_length: int = 10, mapper_layers: int = 8,
                 use_transformer_mapper: bool = True, dtype: torch.dtype = torch.float32, *,
                 device: str | torch.device = "cuda", seed: int = 0):
        super().__init__()
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("ClipCaptionModel(device='cuda'): no CUDA device is available; "
                               "pass device='cpu' to build it on the CPU")
        self.config = dict(gpt2=gpt2, clip_dim=clip_dim, prefix_length=prefix_length,
                           clip_length=clip_length, mapper_layers=mapper_layers,
                           use_transformer_mapper=use_transformer_mapper, dtype=dtype)
        self.gpt2, self.prefix_length, self.dtype = gpt2, prefix_length, dtype
        self.lm = GPT2(gpt2, dtype)
        if use_transformer_mapper:
            self.mapper = TransformerMapper(clip_dim, gpt2.width, prefix_length,
                                            clip_length=clip_length, layers=mapper_layers,
                                            dtype=dtype)
        else:
            self.mapper = MLPMapper(clip_dim, gpt2.width, prefix_length, dtype)
        self.init_weights(torch.Generator().manual_seed(seed))
        self.to(device)

    def init_weights(self, generator: torch.Generator):
        """The reference's init distributions, drawn from ``generator`` (on the parameters'
        device)."""
        self.lm.init_weights(generator)
        self.mapper.init_weights(generator)

    def fresh_state_dict(self, seed: int) -> dict:
        """The weights a model of this configuration built from ``seed`` starts with (drawn on
        the CPU, so the same on every device)."""
        return ClipCaptionModel(**self.config, device="cpu", seed=seed).state_dict()

    def prefix(self, clip_embed: torch.Tensor) -> torch.Tensor:
        out = self.mapper(clip_embed)
        return out.reshape(clip_embed.shape[0], self.prefix_length, self.gpt2.width)

    def forward(self, clip_embed: torch.Tensor, tokens: torch.Tensor,
                mask: torch.Tensor | None = None) -> torch.Tensor:
        """The mean next-token cross entropy over the caption tokens: clip_embed [B, clip_dim],
        tokens [B, T] with 0 padding; position ``prefix_length + i - 1`` predicts
        ``tokens[:, i]``, counted where the label is not 0 (or where ``mask`` says)."""
        embeds = torch.cat([self.prefix(clip_embed), self.lm.embed(tokens)], dim=1)
        logits, _ = self.lm(embeds)
        logits = logits[:, self.prefix_length - 1:-1]  # [B, T, V]
        valid = (tokens > 0) if mask is None else mask
        valid = valid.to(torch.float32)
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, tokens[..., None].long())[..., 0]
        return (nll * valid).sum() / torch.clamp(valid.sum(), min=1.0)

    @torch.no_grad()
    def generate(self, clip_embed: torch.Tensor, generator: torch.Generator | None = None,
                 max_len: int = 40, temperature: float = 0.0, eos_token: int = 50256,
                 return_logits: bool = False):
        """[B, max_len] int64 tokens, 0 after a row's EOS (the EOS itself is emitted). One
        token a step against the static cache; at ``temperature`` > 0 each step draws
        Gumbel noise from ``generator``. With ``return_logits`` also the float32 logits each
        step's token came from, [B, max_len, vocab]."""
        prefix = self.prefix(clip_embed)
        b = prefix.shape[0]
        caches = self.lm.init_cache(b, self.prefix_length + max_len)
        logits, caches = self.lm(prefix, caches, position=0)
        last = logits[:, -1]
        done = torch.zeros(b, dtype=torch.bool, device=prefix.device)
        toks, seen = [], []
        for i in range(max_len):
            if return_logits:
                seen.append(last)
            if temperature == 0.0:
                tok = last.argmax(dim=-1)
            else:
                if generator is None:
                    raise ValueError("sampling at temperature > 0 needs a torch.Generator")
                noise = draws.gumbel(last.shape, generator, last)
                tok = (noise + last / temperature).argmax(dim=-1)
            tok = torch.where(done, 0, tok)
            done = done | (tok == eos_token)
            toks.append(tok)
            if i + 1 < max_len:  # the last token's logits would go unused
                logits, caches = self.lm(self.lm.embed(tok[:, None]), caches,
                                         position=self.prefix_length + i)
                last = logits[:, -1]
        out = torch.stack(toks, dim=1)
        return (out, torch.stack(seen, dim=1)) if return_logits else out


# ---------------------------------------------------------------------------
# weights from elsewhere
# ---------------------------------------------------------------------------


def caption_params_to_port(params: Mapping[str, Any]) -> dict:
    """A ``ClipCaptionModel``'s flax tree ({'params': ...} or its inside; leaves numpy or
    anything ``np.asarray`` takes), either mapper -> the port's state-dict names, float32
    numpy values: ``lm/h_3/ln_1/scale`` becomes ``lm.h.3.ln_1.scale``, and the transformer
    mapper's leaves are renamed as ``checkpoint_interop.jax_params_to_port`` renames a CLIP
    tree's (``mapper.transformer.resblocks.0.ln_1.weight``)."""
    from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port

    return {re.sub(r"(^|\.)h_(\d+)\.", r"\1h.\2.", k): v
            for k, v in jax_params_to_port(params).items()}


@torch.no_grad()
def load_caption_params(model: ClipCaptionModel, params: Mapping[str, Any]) -> ClipCaptionModel:
    """Copy a ``ClipCaptionModel``'s flax tree into ``model`` in place (on its device); a
    mismatch in names or shapes raises."""
    from multimodal_tpu_torch.models.checkpoint_interop import _fill

    return _fill(model, caption_params_to_port(params), "caption parameter tree")


def load_hf_gpt2(state_dict: Mapping[str, Any], cfg: GPT2Config) -> dict:
    """A HuggingFace ``GPT2LMHeadModel`` (or ``GPT2Model``) state dict -> the port's ``GPT2``
    state dict (float32 tensors; load it with ``GPT2.load_state_dict``). HF's ``Conv1D``
    stores [in, out], the layout of the port's kernels, so nothing is transposed; the
    position table is cut to ``cfg.max_positions``."""
    from multimodal_tpu_torch.models.checkpoint_interop import _f32

    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    t = lambda k: torch.from_numpy(_f32(sd[k]).copy())  # noqa: E731
    out = {"wte.embedding": t("wte.weight"), "wpe": t("wpe.weight")[: cfg.max_positions],
           "ln_f.scale": t("ln_f.weight"), "ln_f.bias": t("ln_f.bias")}
    names = {"ln_1": "ln_1", "ln_2": "ln_2", "attn_qkv": "attn.c_attn", "attn_out": "attn.c_proj",
             "mlp_fc": "mlp.c_fc", "mlp_proj": "mlp.c_proj"}
    for i in range(cfg.layers):
        for dst, src in names.items():
            first = "scale" if dst.startswith("ln") else "kernel"
            out[f"h.{i}.{dst}.{first}"] = t(f"h.{i}.{src}.weight")
            out[f"h.{i}.{dst}.bias"] = t(f"h.{i}.{src}.bias")
    return out
