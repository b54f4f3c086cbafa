"""Expert parallelism: a MoE layer's expert stacks split over an ``expert`` axis (port of
``multimodal_tpu/parallel/ep.py``).

The stacks ``w1``, ``w2``, ``b1``, ``b2`` (``[E, ...]``) of every ``moe_mlp`` split on dim 0
over ``expert`` when E divides; the router stays whole. The batch splits over ``data`` only,
so the ranks of an ``expert`` group hold the same tokens: there is nothing to exchange by
all-to-all, and the experts are gathered at use (``parallel.placement``), which keeps the
port's one-hot dispatch as it is. Each rank stores its experts' tiles and their moments.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multimodal_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, create_mesh
from multimodal_tpu_torch.parallel.placement import Placement

EXPERT_AXIS = "expert"


def create_ep_mesh(data: int, experts: int) -> DeviceMesh:
    if data * experts != dist.get_world_size():
        raise ValueError(f"a {data} x {experts} mesh needs {data * experts} ranks, the run "
                         f"has {dist.get_world_size()}")
    return create_mesh((data, experts), (DATA_AXIS, EXPERT_AXIS))


def ep_spec_for_path(path, shape, expert_size: int) -> tuple:
    """``('expert',)`` for a ``moe_mlp`` expert stack whose leading dim divides over
    ``expert_size``; ``()`` for every other leaf."""
    parts = list(path)
    shape = tuple(shape)
    if ("moe_mlp" in parts and parts[-1] in ("w1", "w2", "b1", "b2") and shape
            and shape[0] % expert_size == 0):
        return (EXPERT_AXIS,)
    return ()


def ep_specs(model, mesh: DeviceMesh) -> dict:
    e = axis_size(mesh, EXPERT_AXIS)
    return {name: ep_spec_for_path(name.split("."), p.shape, e)
            for name, p in model.named_parameters()}


def shard_model_ep(model, mesh: DeviceMesh) -> Placement:
    """Place ``model``'s parameters on a ``('data', 'expert')`` mesh by the EP rule."""
    return Placement(model, mesh, ep_specs(model, mesh))
