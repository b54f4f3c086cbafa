"""The port's data-parallel step on gloo ranks against the JAX single-device step on the same
global batch: the gathered-feature loss (local against global, and the global matrix), the
chunked loss over the gathered keys, the ring loss (with label smoothing), SigLIP's ring, the
align and CLOOB losses.

Two process groups, world 2 and world 4 (``torch_dist_workers.run_ranks``), each running every
case; the JAX side runs ``make_train_step`` on one device with the global batch. The same
seeded weights cross through ``jax_params_to_port``. Limits, float32: loss rtol 1e-5 and grad
norm rtol 1e-4 at each of two steps, the updated ``logit_scale`` rtol 1e-5
(``tests/test_tensor_parallel.py``'s), every parameter after the two steps atol 2e-5, rtol
1e-5 (``tests/test_torch_train_step.py``'s); every rank reports the same loss.
"""

import functools

import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from torch_dist_workers import DP_CASES, run_ranks
from torch_jax_models import (B, assert_matches_jax, batch, jax_run, port_params,
                              semantic_features)

def dist_inputs(name: str = "tiny-test", siglip: bool = False, semantic: bool = False) -> dict:
    cfg = jax_create_model(name).cfg
    images, tokens = batch(cfg, B)
    data = {"image": torch.from_numpy(images), "text": torch.from_numpy(tokens).long()}
    if semantic:
        data["semantic"] = torch.from_numpy(semantic_features())
    return {"params": {name: port_params(name, siglip)}, "batch": {name: data}}


@functools.lru_cache(maxsize=None)
def session(world: int, tmp: str):
    inputs = dist_inputs(semantic=True)
    # the SigLIP case's model has the head's bias, and its own seeded weights
    inputs["params"]["tiny-test+siglip"] = port_params("tiny-test", siglip=True)
    return run_ranks("dp", world, inputs, tmp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_dp"))
    return lambda world: session(world, tmp)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(DP_CASES))
def test_data_parallel_step_matches_the_single_device_step(ranks, world, case):
    spec = DP_CASES[case]
    loss = spec.get("loss", "clip")
    kwargs = tuple(sorted(spec.get("loss_kwargs", {}).items()))
    metrics, params = jax_run("tiny-test", loss, spec.get("siglip", False), kwargs)
    assert_matches_jax(ranks(world), case, metrics, params)
