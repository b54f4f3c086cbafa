"""The port's parameter placements on gloo ranks against the JAX single-device step on the
same global batch: FSDP, TP, FSDP x TP, EP (``tiny-test-moe``) and FSDP over the hybrid
``('replica', 'data')`` mesh; each rank's tiles and moment tiles of a split leaf hold 1/N of
it; a checkpoint holds whole tensors and restores into the tiles.

Two process groups, world 2 and world 4 (TP, FSDP x TP and EP as 1 x 2 and 2 x 2 meshes, the
hybrid mesh as 2 x 1 and 2 x 2). Limits as ``tests/test_torch_dist_dp.py``'s.
"""

import functools

import numpy as np
import pytest
import torch

from multimodal_tpu.models import create_model as jax_create_model
from torch_dist_workers import run_ranks
from torch_jax_models import B, assert_matches_jax, batch, jax_run, port_params

CASES = {"fsdp": "tiny-test", "tp": "tiny-test", "fsdp_tp": "tiny-test", "ep": "tiny-test-moe",
         "hybrid_fsdp": "tiny-test"}


@functools.lru_cache(maxsize=None)
def session(world: int, tmp: str):
    inputs = {"params": {}, "batch": {}}
    for name in set(CASES.values()):
        images, tokens = batch(jax_create_model(name).cfg, B)
        inputs["params"][name] = port_params(name)
        inputs["batch"][name] = {"image": torch.from_numpy(images),
                                 "text": torch.from_numpy(tokens).long()}
    return run_ranks("sharded", world, inputs, tmp)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("dist_sharded"))
    return lambda world: session(world, tmp)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_placed_step_matches_the_single_device_step(ranks, world, case):
    metrics, params = jax_run(CASES[case])
    got = ranks(world)
    assert_matches_jax(got, case, metrics, params)
    if case == "hybrid_fsdp" and world == 2:  # a 2 x 1 mesh: the data axis splits nothing
        assert not got[0][case]["sizes"]
        return
    sizes = got[0][case]["sizes"]
    assert sizes, f"{case} split no parameter"
    ways = {"fsdp": world, "tp": 2, "fsdp_tp": world, "ep": 2, "hybrid_fsdp": 2}[case]
    if case == "fsdp_tp":  # leaves with a TP rule split both ways, the others over data only
        assert any(whole == tile * world for tile, whole, _ in sizes.values())
    else:
        assert all(whole == tile * ways for tile, whole, _ in sizes.values()), sizes
    assert all(moment == tile for tile, _, moment in sizes.values())


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_checkpoint_is_whole_and_restores_into_the_tiles(ranks, world):
    """The checkpoint of an FSDP run holds whole tensors (it loads into a model at world 1)
    and restores into the tiles of a freshly placed model bit for bit."""
    ck = ranks(world)[0]["checkpoint"]
    assert all(r["checkpoint"]["restored_tiles_equal"] for r in ranks(world))
    assert ck["step"] == 2
    from multimodal_tpu_torch.models import create_model

    model = create_model("tiny-test", device="cpu")
    model.load_state_dict(ck["model"])
    want = ranks(world)[0]["fsdp"]["params"]
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), want[n].numpy(), err_msg=n)
        assert ck["mu"][n].shape == p.shape
