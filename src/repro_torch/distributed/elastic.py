"""Elastic scaling: rebuild the mesh after rank loss and reshard state.
The port of `repro/distributed/elastic.py`.

Policy: failures shrink the `data` axis (the data-parallel degree); the
`model` (and `pod`) extents stay, because weights are sharded across a
model group, so a dead rank inside one takes its whole group's data rank
out.  Parameters and optimizer state are restored from the latest
checkpoint onto the new mesh (`CheckpointManager.restore(shardings=)`).

`plan_shrunk_mesh` is arithmetic on the axis sizes of a `DeviceMesh` (or of
any object with a `shape` dict); `build_mesh_from_plan` makes the new
`DeviceMesh` over the surviving ranks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import axis_sizes

__all__ = ["plan_shrunk_mesh", "ElasticPlan", "build_mesh_from_plan"]


@dataclass(frozen=True)
class ElasticPlan:
    old_shape: dict[str, int]
    new_shape: dict[str, int]
    lost_ranks: int

    @property
    def new_axis_sizes(self) -> tuple[int, ...]:
        return tuple(self.new_shape.values())


def plan_shrunk_mesh(mesh, n_failed: int,
                     data_axis: str = "data") -> ElasticPlan:
    """The largest surviving mesh after `n_failed` rank failures: each
    takes out the data rank it belongs to, so ceil(n_failed / ranks per
    data rank) data ranks go; the other extents are kept."""
    shape = axis_sizes(mesh)
    per_rank = math.prod(s for a, s in shape.items() if a != data_axis)
    lost_ranks = math.ceil(n_failed / per_rank) if n_failed else 0
    new_data = shape[data_axis] - lost_ranks
    if new_data < 1:
        raise RuntimeError(
            f"too many failures: {n_failed} kills all {shape[data_axis]} "
            "data ranks")
    new_shape = dict(shape)
    new_shape[data_axis] = new_data
    return ElasticPlan(shape, new_shape, lost_ranks)


def build_mesh_from_plan(plan: ElasticPlan, ranks=None,
                         device_type: str = "cuda"):
    """The shrunk `DeviceMesh` over the first prod(new sizes) of `ranks`
    (the surviving ranks, in order; default every rank of the world).
    Every rank of the process group must call this, since making a mesh
    makes process groups; a rank outside the new mesh gets None."""
    from torch.distributed.device_mesh import DeviceMesh
    names = tuple(plan.new_shape.keys())
    sizes = plan.new_axis_sizes
    need = math.prod(sizes)
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if len(ranks) < need:
        raise RuntimeError(f"need {need} ranks, have {len(ranks)}")
    layout = torch.tensor(ranks[:need], dtype=torch.int64).reshape(sizes)
    mesh = DeviceMesh(device_type, layout, mesh_dim_names=names)
    return mesh if dist.get_rank() in ranks[:need] else None
