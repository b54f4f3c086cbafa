"""FSDP x TP: the TP rule on ``model`` and the FSDP rule on the largest axis left, over one
``('data', 'model')`` mesh (port of ``multimodal_tpu/parallel/compose.py``). A leaf without a
TP rule takes plain FSDP over ``data``; the moments follow their parameters, so they shrink
with both axes."""

from __future__ import annotations

import math

from torch.distributed.device_mesh import DeviceMesh

from multimodal_tpu_torch.parallel.fsdp import MIN_SHARD_SIZE, fsdp_spec_for_leaf
from multimodal_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
from multimodal_tpu_torch.parallel.placement import Placement
from multimodal_tpu_torch.parallel.tp import MODEL_AXIS, tp_spec_for_path


def fsdp_tp_spec_for_path(path, shape, data_size: int, model_size: int,
                          min_size: int = MIN_SHARD_SIZE) -> tuple:
    """The 2-D spec: the TP rule's ``model`` split, then ``data`` on the largest free axis
    that divides (ties to the last)."""
    shape = tuple(shape)
    tp_spec = tp_spec_for_path(path, shape, model_size)
    if tp_spec == ():
        return fsdp_spec_for_leaf(shape, data_size, min_size)
    if math.prod(shape) < min_size:
        return tp_spec
    dims = list(tp_spec) + [None] * (len(shape) - len(tp_spec))
    best = None
    for i, d in enumerate(shape):
        if dims[i] is None and d % data_size == 0 and (best is None or d >= shape[best]):
            best = i
    if best is not None:
        dims[best] = DATA_AXIS
    return tuple(dims)


def fsdp_tp_specs(model, mesh: DeviceMesh, min_size: int = MIN_SHARD_SIZE) -> dict:
    d, m = axis_size(mesh, DATA_AXIS), axis_size(mesh, MODEL_AXIS)
    return {name: fsdp_tp_spec_for_path(name.split("."), p.shape, d, m, min_size)
            for name, p in model.named_parameters()}


def shard_model_fsdp_tp(model, mesh: DeviceMesh, min_size: int = MIN_SHARD_SIZE) -> Placement:
    """Place ``model``'s parameters on a ``('data', 'model')`` mesh by the composed rules."""
    return Placement(model, mesh, fsdp_tp_specs(model, mesh, min_size))
