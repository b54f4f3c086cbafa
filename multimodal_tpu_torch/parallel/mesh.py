"""The process group and the device mesh (port of ``multimodal_tpu/parallel/mesh.py``).

JAX is single-controller: one process sees every device, and a ``Mesh`` names their axes.
PyTorch runs one process per device: ``init_process_group`` joins the run's processes (the
environment of ``python -m torch.distributed.run``: RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT; or ``--dist-url tcp://host:port`` with RANK and WORLD_SIZE, the
reference's convention), and ``create_mesh`` lays the ranks out as a
``torch.distributed.device_mesh.DeviceMesh`` whose dimensions carry the JAX axis names
(``data``, ``replica``, ``model``, ``expert``, ``stage``). Rank r sits at the mesh position
of index r in row-major order, as ``np.reshape`` lays JAX's devices out.

The backend follows the device, explicitly: NCCL for CUDA, gloo for the CPU; a backend
named that does not fit the device raises. A run without any of that environment is a world
of one rank: ``init_process_group`` forms it in process (an in-memory store), so every flag
runs its degenerate form, as the JAX CLI does on one device.

``shard_batch`` gives rank r rows ``[r B / W, (r + 1) B / W)`` of a global batch, W the size
of the mesh's batch axes (``batch_axes``: ``('replica', 'data')`` on a hybrid mesh, else
``('data',)``): what JAX's sharded ``device_put`` of the batch means.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"
REPLICA_AXIS = "replica"


def backend_for(device) -> str:
    """The process-group backend of ``device``: NCCL on CUDA, gloo on the CPU."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no process-group backend for device {device}")
    return "nccl" if kind == "cuda" else "gloo"


def init_process_group(device, dist_url: Optional[str] = None,
                       backend: Optional[str] = None) -> torch.device:
    """Join the run's process group (idempotent) and return this rank's device:
    ``cuda:LOCAL_RANK`` (made the current CUDA device) or ``cpu``.

    ``dist_url`` ``tcp://host:port`` takes RANK and WORLD_SIZE from the environment;
    ``env://`` or None the torchrun environment; neither with no WORLD_SIZE set forms a
    world of one rank in process. ``backend`` None takes ``backend_for(device)``; another
    backend than the device's raises."""
    want = backend_for(device)
    if backend is not None and backend != want:
        raise ValueError(f"--dist-backend {backend} does not fit --device "
                         f"{torch.device(device).type} (that device takes {want})")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA process group needs a CUDA device; none is available")
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        if dist.get_backend() != want:
            raise ValueError(f"the process group runs {dist.get_backend()}, the device "
                             f"{dev} takes {want}")
        return dev
    if dist_url and dist_url != "env://":
        dist.init_process_group(want, init_method=dist_url,
                                rank=int(os.environ.get("RANK", "0")),
                                world_size=int(os.environ.get("WORLD_SIZE", "1")))
    elif "WORLD_SIZE" in os.environ:
        dist.init_process_group(want, init_method="env://")
    else:  # no launcher: a world of one rank
        dist.init_process_group(want, store=dist.HashStore(), rank=0, world_size=1)
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(shape: Optional[Sequence[int]] = None,
                axis_names: Sequence[str] = (DATA_AXIS,)) -> DeviceMesh:
    """A mesh over every rank of the process group; by default one ``data`` axis, the 1-D
    data-parallel mesh. A multi-axis mesh needs its ``shape``, whose product is the world."""
    world = dist.get_world_size()
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("a multi-axis mesh needs its shape")
        shape = (world,)
    if int(torch.tensor(shape).prod()) != world:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover the {world} ranks")
    return init_device_mesh(_device_type(), tuple(shape), mesh_dim_names=tuple(axis_names))


def create_hybrid_mesh(num_slices: int) -> DeviceMesh:
    """The ``('replica', 'data')`` mesh of a multi-slice run: ``num_slices`` replicas of a
    ``data`` axis of world / num_slices ranks. FSDP shards ride ``data`` only."""
    world = dist.get_world_size()
    if world % num_slices:
        raise ValueError(f"{world} ranks do not divide into {num_slices} slices")
    return create_mesh((num_slices, world // num_slices), (REPLICA_AXIS, DATA_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis)) if axis in mesh.mesh_dim_names else 1


def axis_rank(mesh: DeviceMesh, axis: str) -> int:
    return mesh.get_local_rank(axis) if axis in mesh.mesh_dim_names else 0


def batch_axes(mesh: DeviceMesh) -> tuple:
    """The mesh axes the batch splits over: ``('replica', 'data')`` on a hybrid mesh,
    ``('data',)`` otherwise."""
    return tuple(a for a in (REPLICA_AXIS, DATA_AXIS) if a in mesh.mesh_dim_names)


def batch_group(mesh: DeviceMesh):
    """The process group over the batch axes: the ``data`` axis's, or on a hybrid mesh
    (whose two axes are the whole mesh) the world's."""
    axes = batch_axes(mesh)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if len(axes) != len(mesh.mesh_dim_names):
        raise ValueError(f"the batch axes {axes} of mesh {mesh.mesh_dim_names} are not the "
                         "whole mesh")
    return dist.group.WORLD


def batch_shard(mesh: DeviceMesh) -> tuple[int, int]:
    """(this rank's index, the number of shards) of the batch over ``batch_axes``, row-major
    over those axes."""
    index, count = 0, 1
    for axis in batch_axes(mesh):
        index = index * axis_size(mesh, axis) + axis_rank(mesh, axis)
        count *= axis_size(mesh, axis)
    return index, count


def shard_batch(batch: dict, mesh: DeviceMesh) -> dict:
    """This rank's rows of a global batch (a dict of tensors with the batch first):
    ``[r B / W, (r + 1) B / W)``, W the batch axes' size."""
    r, w = batch_shard(mesh)
    n = next(iter(batch.values())).shape[0]
    if n % w:
        raise ValueError(f"a batch of {n} does not split over {w} ranks")
    m = n // w
    return {k: v[r * m:(r + 1) * m] for k, v in batch.items()}
