"""Ring attention and pipeline parallelism on gloo ranks against the JAX package.

* Ring attention (world 4, full and causal): the forward and the q / k / v gradients of the
  port's ``ring_attention`` (the flash operator's plain versions per visited block, here on
  the CPU) against the JAX ``ring_attention`` under ``shard_map`` over 4 devices, at
  ``tests/test_ring_attention.py``'s limits (rtol = atol = 2e-5 forward, 5e-5 gradients);
  ``ring_attention_blocks``, the same schedule over blocks of one sequence on one device,
  against the port's one-call flash operator.
* Pipeline parallelism (world 8): ``pipeline_blocks`` at the JAX test's (stages,
  microbatches) cases against the blocks applied in order, value and gradients (rtol 1e-5,
  atol 1e-6, ``tests/test_pipeline_parallel.py``'s); the pipelined CLIP step on a
  (data 4, stage 2) mesh against the JAX single-device step (``tests/test_torch_dist_dp.py``'s
  limits); a MoE trunk is refused.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from multimodal_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from multimodal_tpu.models import create_model as jax_create_model
from torch_dist_workers import run_ranks
from torch_jax_models import B, assert_matches_jax, batch, jax_run, port_params

PP_CASES = [(2, 2), (4, 4), (8, 2), (1, 3)]


def qkv(s: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(2, s, 4, 16)).astype(np.float32) for _ in range(3))


@functools.lru_cache(maxsize=None)
def ring_ranks(tmp: str):
    inputs = {key: tuple(torch.from_numpy(a) for a in qkv(s))
              for key, s in (("fwd", 64), ("grad", 32))}
    return run_ranks("ring_attention", 4, inputs, tmp)


@functools.lru_cache(maxsize=None)
def pp_ranks(tmp: str):
    rng = np.random.default_rng(1)
    blocks = {"w": torch.from_numpy((rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32)),
              "b": torch.from_numpy((rng.normal(size=(8, 16)) * 0.1).astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(12, 4, 16)).astype(np.float32))
    images, tokens = batch(jax_create_model("tiny-test").cfg, B)
    inputs = {"blocks": blocks, "x": x, "pp_cases": PP_CASES,
              "params": {"tiny-test": port_params("tiny-test")},
              "batch": {"tiny-test": {"image": torch.from_numpy(images),
                                      "text": torch.from_numpy(tokens).long()}}}
    return run_ranks("pp", 8, inputs, tmp)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("dist_ring_pp"))


def jax_ring(q, k, v, causal: bool):
    mesh = Mesh(np.asarray(jax.devices()[:4]), ("seq",))
    return jax.shard_map(functools.partial(jax_ring_attention, axis_name="seq", causal=causal),
                         mesh=mesh, in_specs=(P(None, "seq"),) * 3,
                         out_specs=P(None, "seq"))(q, k, v)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax_under_shard_map(tmp, causal):
    ranks = ring_ranks(tmp)
    q, k, v = (jnp.asarray(a) for a in qkv(64))
    out = torch.cat([r[("fwd", causal)]["out"] for r in ranks], dim=1)
    np.testing.assert_allclose(out.numpy(), np.asarray(jax.jit(jax_ring, static_argnums=3)(
        q, k, v, causal)), rtol=2e-5, atol=2e-5)

    q, k, v = (jnp.asarray(a) for a in qkv(32))
    want = jax.jit(jax.grad(lambda q, k, v: jnp.sum(jnp.sin(jax_ring(q, k, v, causal))),
                            argnums=(0, 1, 2)))(q, k, v)
    for i, name in enumerate("qkv"):
        got = torch.cat([r[("grad", causal)]["grads"][i] for r in ranks], dim=1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want[i]), rtol=5e-5, atol=5e-5,
                                   err_msg=f"grad w.r.t. {name}")


@pytest.mark.parametrize("causal", [False, True])
def test_ring_schedule_over_blocks_matches_one_flash_call(causal):
    from multimodal_tpu_torch.ops.flash_attention import flash_attention
    from multimodal_tpu_torch.ops.ring_attention import ring_attention_blocks

    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in qkv(64, seed=3))
    ct = torch.from_numpy(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    got = ring_attention_blocks(q, k, v, 4, causal=causal)
    g_got = torch.autograd.grad(got, (q, k, v), ct)
    want = flash_attention(q, k, v, causal=causal)
    g_want = torch.autograd.grad(want, (q, k, v), ct)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    for a, b in zip(g_got, g_want):
        torch.testing.assert_close(a, b, rtol=5e-5, atol=5e-5)


@pytest.mark.parametrize("stages,micro", PP_CASES)
def test_pipeline_matches_sequential(tmp, stages, micro):
    rng = np.random.default_rng(1)
    w = jnp.asarray((rng.normal(size=(8, 16, 16)) * 0.3).astype(np.float32))
    b = jnp.asarray((rng.normal(size=(8, 16)) * 0.1).astype(np.float32))
    x = jnp.asarray(rng.normal(size=(12, 4, 16)).astype(np.float32))

    def seq(w, b, x):
        for i in range(8):
            x = jnp.tanh(x @ w[i] + b[i])
        return x

    y = seq(w, b, x)
    grads = jax.grad(lambda w, b, x: jnp.mean(jnp.square(seq(w, b, x))), argnums=(0, 1, 2))(
        w, b, x)
    got = pp_ranks(tmp)[0][(stages, micro)]
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(y), rtol=1e-5, atol=1e-6)
    for g, want, name in zip(got["grads"], grads, ("w", "b", "x")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=name)


def test_pipelined_step_matches_the_single_device_step(tmp):
    ranks = pp_ranks(tmp)
    metrics, params = jax_run("tiny-test")
    got = [{"train": r["train"]} for r in ranks]
    assert_matches_jax(got, "train", metrics, params)
    # a stage's optimizer holds the stems, the heads and its own blocks: one of two per tower
    assert ranks[0]["train"]["optimizer_leaves"] < len(params)


def test_pipelined_step_refuses_moe_trunks():
    from multimodal_tpu_torch.models import create_model
    from multimodal_tpu_torch.parallel.pp import make_pp_train_step

    with pytest.raises(ValueError, match="MoE"):
        make_pp_train_step(create_model("tiny-test-moe", device="cpu"), None, mesh=None)


def test_pipeline_params_stack_like_jax_and_round_trip():
    """``to_pipeline_params`` stacks each tower's blocks as the reference's does (the same
    leaves under the same names, once through ``jax_params_to_port``), and
    ``from_pipeline_params`` gives the state dict back bit for bit."""
    from multimodal_tpu.parallel.pp import to_pipeline_params as jax_to_pipeline
    from multimodal_tpu_torch.models.checkpoint_interop import jax_params_to_port
    from multimodal_tpu_torch.parallel.pp import from_pipeline_params, to_pipeline_params
    from torch_jax_models import random_params

    params = random_params(jax_create_model("tiny-test"))
    want = jax_params_to_port(jax_to_pipeline(params))
    port = {k: torch.from_numpy(v) for k, v in jax_params_to_port(params).items()}
    got = to_pipeline_params(port)
    assert set(got) == set(want)
    assert got["visual_blocks.mlp.c_fc.kernel"].shape[0] == 2
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    back = from_pipeline_params(got)
    assert set(back) == set(port)
    for k, t in port.items():
        assert torch.equal(back[k], t), k
