"""The distributed layer of the port (``multimodal_tpu/parallel/``): the process group and
the mesh, the placement of parameters over it (FSDP, TP, FSDP x TP, EP), optimizer-state
offload (``parallel.offload``) and pipeline parallelism (``parallel.pp``)."""

from multimodal_tpu_torch.parallel.compose import fsdp_tp_spec_for_path, shard_model_fsdp_tp
from multimodal_tpu_torch.parallel.ep import (
    EXPERT_AXIS,
    create_ep_mesh,
    ep_spec_for_path,
    shard_model_ep,
)
from multimodal_tpu_torch.parallel.fsdp import MIN_SHARD_SIZE, fsdp_spec_for_leaf, shard_model_fsdp
from multimodal_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    REPLICA_AXIS,
    batch_axes,
    batch_group,
    create_hybrid_mesh,
    create_mesh,
    init_process_group,
    shard_batch,
)
from multimodal_tpu_torch.parallel.placement import Placement
from multimodal_tpu_torch.parallel.tp import (
    MODEL_AXIS,
    create_tp_mesh,
    shard_model_tp,
    tp_spec_for_path,
)

__all__ = ["DATA_AXIS", "EXPERT_AXIS", "MIN_SHARD_SIZE", "MODEL_AXIS", "Placement",
           "REPLICA_AXIS", "batch_axes", "batch_group", "create_ep_mesh", "create_hybrid_mesh",
           "create_mesh", "create_tp_mesh", "ep_spec_for_path", "fsdp_spec_for_leaf",
           "fsdp_tp_spec_for_path", "init_process_group", "shard_batch", "shard_model_ep",
           "shard_model_fsdp", "shard_model_fsdp_tp", "shard_model_tp", "tp_spec_for_path"]
