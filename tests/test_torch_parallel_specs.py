"""The port's placement rules, pure functions of a leaf's path and shape, choose the JAX
package's axis for every leaf: ``fsdp_spec_for_leaf``, ``tp_spec_for_path``,
``fsdp_tp_spec_for_path`` and ``ep_spec_for_path`` over every parameter of ``tiny-test``,
``tiny-test-moe`` and ``ViT-B-32`` (shapes from ``jax.eval_shape``, names through
``checkpoint_interop``'s flax -> port mapping) at world sizes 2, 4 and 8 (TP and EP axes of 2
within them)."""

import functools

import jax
import pytest

from multimodal_tpu.models import create_model as jax_create_model
from multimodal_tpu.models import init_params
from multimodal_tpu.parallel.compose import fsdp_tp_spec_for_path as jax_fsdp_tp
from multimodal_tpu.parallel.ep import ep_spec_for_path as jax_ep
from multimodal_tpu.parallel.fsdp import fsdp_spec_for_leaf as jax_fsdp
from multimodal_tpu.parallel.tp import tp_spec_for_path as jax_tp
from multimodal_tpu_torch.models.checkpoint_interop import _port_name
from multimodal_tpu_torch.parallel import (
    ep_spec_for_path,
    fsdp_spec_for_leaf,
    fsdp_tp_spec_for_path,
    tp_spec_for_path,
)
from multimodal_tpu_torch.parallel.placement import padded_spec

MODELS = ["tiny-test", "tiny-test-moe", "ViT-B-32"]


@functools.lru_cache(maxsize=None)
def leaves(model: str) -> list:
    """(flax path, port name, shape) of every parameter."""
    shapes = jax.eval_shape(lambda: init_params(jax_create_model(model),
                                                jax.random.PRNGKey(0)))["params"]
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        keys = [k.key for k in path]
        out.append((path, _port_name(keys), leaf))
    return out


def same(jax_spec, port_spec, ndim: int):
    return padded_spec(tuple(jax_spec), ndim) == padded_spec(port_spec, ndim)


def rules(world: int):
    m = 2
    return {
        "fsdp": (lambda p, n, x: jax_fsdp(x, world),
                 lambda p, n, x: fsdp_spec_for_leaf(x.shape, world)),
        "tp": (lambda p, n, x: jax_tp(p, x, m),
               lambda p, n, x: tp_spec_for_path(n.split("."), x.shape, m)),
        "fsdp_tp": (lambda p, n, x: jax_fsdp_tp(p, x, world // m, m),
                    lambda p, n, x: fsdp_tp_spec_for_path(n.split("."), x.shape, world // m, m)),
        "ep": (lambda p, n, x: jax_ep(p, x, m),
               lambda p, n, x: ep_spec_for_path(n.split("."), x.shape, m)),
    }


@pytest.mark.parametrize("rule", ["fsdp", "tp", "fsdp_tp", "ep"])
@pytest.mark.parametrize("world", [2, 4, 8])
@pytest.mark.parametrize("model", MODELS)
def test_rule_chooses_the_jax_axis_for_every_leaf(model, world, rule):
    want_fn, got_fn = rules(world)[rule]
    split = 0
    for path, name, leaf in leaves(model):
        want, got = want_fn(path, name, leaf), got_fn(path, name, leaf)
        assert same(want, got, leaf.ndim), (name, tuple(want), got)
        split += any(a is not None for a in got)
    if rule != "ep" or model == "tiny-test-moe":
        assert split, f"{rule} splits no leaf of {model}"
