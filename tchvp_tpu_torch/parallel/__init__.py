"""Parallelism of the port over ``torch.distributed``: the mesh and its gate
(:mod:`.mesh`) and the collectives of sequence parallelism
(:mod:`.collectives`)."""

from tchvp_tpu_torch.parallel.mesh import (
    activate_mesh,
    ambient_mesh,
    axis_group,
    axis_shards,
    axis_size,
    init_distributed,
    make_mesh,
    mesh_with_axis,
    shard_frames,
    with_current_mesh,
)

__all__ = [
    "activate_mesh",
    "ambient_mesh",
    "axis_group",
    "axis_shards",
    "axis_size",
    "init_distributed",
    "make_mesh",
    "mesh_with_axis",
    "shard_frames",
    "with_current_mesh",
]
