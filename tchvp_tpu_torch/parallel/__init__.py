"""Parallelism of the port over ``torch.distributed``: the launch, the mesh
and its gate (:mod:`.mesh`), the collectives (:mod:`.collectives`), the data-parallel
input (:mod:`.input`) and the sharding planner (:mod:`.plan`)."""

from tchvp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    HostLayout,
    activate_mesh,
    ambient_mesh,
    axis_group,
    axis_shards,
    axis_size,
    group_over,
    host_layout,
    host_local_batch_slice,
    init_distributed,
    launch_layout,
    launch_line,
    make_hybrid_mesh,
    make_mesh,
    mesh_with_axis,
    replicate,
    shard_batch,
    shard_frames,
    with_current_mesh,
)
from tchvp_tpu_torch.parallel.plan import (
    LeafPlan,
    ShardingPlan,
    abstract_train_state,
    plan_state,
)

__all__ = [
    "DATA_AXIS",
    "HostLayout",
    "LeafPlan",
    "ShardingPlan",
    "abstract_train_state",
    "activate_mesh",
    "ambient_mesh",
    "axis_group",
    "axis_shards",
    "axis_size",
    "group_over",
    "host_layout",
    "host_local_batch_slice",
    "init_distributed",
    "launch_layout",
    "launch_line",
    "make_hybrid_mesh",
    "make_mesh",
    "mesh_with_axis",
    "plan_state",
    "replicate",
    "shard_batch",
    "shard_frames",
    "with_current_mesh",
]
