"""Tensor parallelism over a ``('data', 'model')`` mesh (port of
``multimodal_tpu/parallel/tp.py``): the reference's Megatron rules by parameter path,

    mlp/c_fc kernel   [W, 4W]  -> (None, 'model')   column parallel
    mlp/c_proj kernel [4W, W]  -> ('model', None)   row parallel
    attn q/k/v kernel [W, W]   -> (None, 'model')   heads
    attn out kernel   [W, W]   -> ('model', None)
    everything else            -> whole

applied to the port's parameter names, which carry the flax path (``.../mlp/c_fc/kernel``
is ``...mlp.c_fc.kernel``, both ``[in, out]``), so every rule finds the same leaves. A leaf
whose split dimension does not divide stays whole.

``shard_model_tp`` places a model by them (``parallel.placement``): each rank stores its
tile and its moments' tiles; the block kernels take whole ``[W, W]`` weights and add the bias
and the residual inside, so the weights are gathered at use, as GSPMD gathers the operands of
a custom call. The batch splits over ``data`` only: the ranks of a ``model`` group hold the
same rows.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from multimodal_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, create_mesh
from multimodal_tpu_torch.parallel.placement import Placement

MODEL_AXIS = "model"

# (path parts that must all appear, spec), checked in order
_RULES = (
    (("mlp", "c_fc", "kernel"), (None, MODEL_AXIS)),
    (("mlp", "c_fc", "bias"), (MODEL_AXIS,)),
    (("mlp", "c_proj", "kernel"), (MODEL_AXIS, None)),
    (("attn", "query", "kernel"), (None, MODEL_AXIS)),
    (("attn", "key", "kernel"), (None, MODEL_AXIS)),
    (("attn", "value", "kernel"), (None, MODEL_AXIS)),
    (("attn", "query", "bias"), (MODEL_AXIS,)),
    (("attn", "key", "bias"), (MODEL_AXIS,)),
    (("attn", "value", "bias"), (MODEL_AXIS,)),
    (("attn", "out", "kernel"), (MODEL_AXIS, None)),
)


def create_tp_mesh(data: int, model: int) -> DeviceMesh:
    if data * model != dist.get_world_size():
        raise ValueError(f"a {data} x {model} mesh needs {data * model} ranks, the run has "
                         f"{dist.get_world_size()}")
    return create_mesh((data, model), (DATA_AXIS, MODEL_AXIS))


def tp_spec_for_path(path, shape, model_size: int) -> tuple:
    """The spec of the leaf at ``path`` (its name's parts) of ``shape``: the first rule whose
    parts all appear in the path, if its split dimension divides over ``model_size``; else
    ``()``."""
    parts = list(path)
    shape = tuple(shape)
    for needles, spec in _RULES:
        if all(n in parts for n in needles):
            ok = all(axis != MODEL_AXIS or (i < len(shape) and shape[i] % model_size == 0)
                     for i, axis in enumerate(spec))
            return spec if ok else ()
    return ()


def tp_specs(model, mesh: DeviceMesh) -> dict:
    m = axis_size(mesh, MODEL_AXIS)
    return {name: tp_spec_for_path(name.split("."), p.shape, m)
            for name, p in model.named_parameters()}


def shard_model_tp(model, mesh: DeviceMesh) -> Placement:
    """Place ``model``'s parameters on a ``('data', 'model')`` mesh by the TP rules."""
    return Placement(model, mesh, tp_specs(model, mesh))
