"""FSDP / ZeRO: parameters and their optimizer moments split over the ``data`` axis (port of
``multimodal_tpu/parallel/fsdp.py``).

``fsdp_spec_for_leaf`` is the reference's rule, a pure function of the shape: the largest
axis that divides evenly over the shards, ties to the last such axis (the output features of
an ``[in, out]`` kernel), and leaves under ``MIN_SHARD_SIZE`` elements stay whole.
``shard_model_fsdp`` places a model by it (``parallel.placement``): each rank keeps its tile,
the forward gathers every weight at use and the backward reduce-scatters its gradient, and an
optimizer built afterwards holds moments of the tiles' size, 1/N of the whole. On a hybrid
mesh the tiles ride ``data`` only; the ``replica`` axis keeps whole copies.
"""

from __future__ import annotations

import math

from torch.distributed.device_mesh import DeviceMesh

from multimodal_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from multimodal_tpu_torch.parallel.placement import Placement

# leaves smaller than this stay whole: splitting a LayerNorm vector saves nothing and costs a
# gather; 2^13 elements = 32 KiB of float32 per leaf
MIN_SHARD_SIZE = 8192


def fsdp_spec_for_leaf(shape, n_shards: int, min_size: int = MIN_SHARD_SIZE) -> tuple:
    """The spec splitting the largest evenly divisible axis of a leaf of ``shape`` over
    ``data`` (ties to the last qualifying axis); ``()`` keeps it whole."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_size:
        return ()
    best = None
    for i, d in enumerate(shape):
        if d % n_shards == 0 and (best is None or d >= shape[best]):
            best = i
    if best is None:
        return ()
    spec = [None] * len(shape)
    spec[best] = DATA_AXIS
    return tuple(spec)


def fsdp_specs(model, mesh: DeviceMesh, min_size: int = MIN_SHARD_SIZE) -> dict:
    """The FSDP spec of every parameter of ``model`` on ``mesh``."""
    n = axis_size(mesh, DATA_AXIS)
    return {name: fsdp_spec_for_leaf(p.shape, n, min_size)
            for name, p in model.named_parameters()}


def shard_model_fsdp(model, mesh: DeviceMesh, min_size: int = MIN_SHARD_SIZE) -> Placement:
    """Place ``model``'s parameters on ``mesh`` by the FSDP rule."""
    return Placement(model, mesh, fsdp_specs(model, mesh, min_size))
