"""Transformer building blocks of the PyTorch port against the Flax modules of
``multimodal_tpu.models.layers`` with the same parameters and inputs (f32 atol 1e-5)."""

import re

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_tpu.models import layers as jl
from multimodal_tpu.ops.block_attention import _ln_rows
from multimodal_tpu_torch.models import layers as tl
from multimodal_tpu_torch.ops.block_attention import ln_rows

torch.set_num_threads(1)


def _port_name(path: str) -> str:
    path = re.sub(r"resblock_(\d+)", r"resblocks.\1", path)
    path = path.replace("LayerNorm_0.scale", "weight").replace("LayerNorm_0.bias", "bias")
    return path


def _load_flax(module: torch.nn.Module, params) -> torch.nn.Module:
    """Copy a Flax param tree into the port module (names mapped, shapes checked)."""
    flat = {_port_name(".".join(k.key for k in path)): np.array(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params["params"])}
    named = dict(module.named_parameters())
    assert set(flat) == set(named), (sorted(flat), sorted(named))
    with torch.no_grad():
        for name, p in named.items():
            assert tuple(p.shape) == flat[name].shape, name
            p.copy_(torch.from_numpy(flat[name]))
    return module


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ln_rows(dtype):
    rng = np.random.default_rng(0)
    x = 3 + 2 * rng.standard_normal((4, 7, 96), dtype=np.float32)
    g = 1 + 0.1 * rng.standard_normal(96, dtype=np.float32)
    b = 0.1 * rng.standard_normal(96, dtype=np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    want = np.asarray(_ln_rows(jnp.asarray(x, jdt), jnp.asarray(g), jnp.asarray(b), 1e-5)
                      .astype(jnp.float32))
    got = ln_rows(torch.from_numpy(x).to(tdt), torch.from_numpy(g), torch.from_numpy(b),
                  1e-5).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:  # bf16 arithmetic: within two bf16 ulps of the output magnitude
        np.testing.assert_allclose(got, want, atol=2 * 2 ** -7 * np.abs(want).max(), rtol=0)


def test_quick_gelu():
    x = _x((1000,), 1) * 4
    np.testing.assert_allclose(tl.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jl.quick_gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
@pytest.mark.parametrize("residual", [False, True])
def test_mlp(residual, act):
    width = 64
    x = _x((2, 9, width), 2)
    jm = jl.MLP(width, depth=2, act=jl.quick_gelu if act == "quick_gelu" else nn.gelu)
    rng = np.random.default_rng(3)
    ln = (jnp.asarray(1 + 0.1 * rng.standard_normal(width, dtype=np.float32)),
          jnp.asarray(0.1 * rng.standard_normal(width, dtype=np.float32)))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), ln_params=ln, residual=residual)
    want = np.asarray(jm.apply(params, jnp.asarray(x), ln_params=ln, residual=residual))
    tm = _load_flax(tl.MLP(width, depth=2, act=tl.resolve_act(act)), params)
    got = tm(torch.from_numpy(x), ln_params=tuple(torch.tensor(np.asarray(a)) for a in ln),
             residual=residual).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


# width 128 / head_dim 64 takes the block-attention operator, width 64 the plain attention
@pytest.mark.parametrize("width,heads", [(128, 2), (64, 2)])
@pytest.mark.parametrize("causal", [False, True])
def test_residual_block(width, heads, causal):
    x = _x((2, 12, width), 4)
    jm = jl.ResidualBlock(width, heads, causal=causal, depth=2)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = _load_flax(tl.ResidualBlock(width, heads, causal=causal, depth=2), params)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_transformer(causal):
    width, layers, heads = 128, 2, 2
    x = _x((2, 10, width), 5)
    jm = jl.Transformer(width, layers, heads, causal=causal)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    tm = _load_flax(tl.Transformer(width, layers, heads, causal=causal), params)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
