"""Device meshes: the data-parallel part of `ray_tpu/parallel/mesh.py`.

The JAX package builds one `jax.sharding.Mesh` over every chip and names an
axis per kind of parallelism. Here a mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the ranks of torch's
default process group, one process per device. This slice has the
hierarchical data-parallel mesh only: the dp axis split into
`(dp_inter, dp_intra)`, hosts x local devices, whose two dimensions' groups
carry the two-level gradient sync of `train.spmd`. The logical-axis rules
and the fsdp, tp, sp, ep and pp axes are ROADMAP item 5.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective._comm import Comm
from ray_tpu_torch.util.collective.hierarchy import (HierGroups, Topology,
                                                     host_id, infer_topology)
from ray_tpu_torch.utils.platform import default_device

# Hierarchical data-parallel sub-axes: dp as (slow-fabric hosts) x
# (fast-fabric local devices).
DP_SUB_AXES = ("dp_inter", "dp_intra")


def _host_topology(world: int) -> Topology:
    """hosts x ranks-per-host of the default group, from every rank's
    `host_id` (flat where hosts hold different counts)."""
    hosts = [None] * world
    dist.all_gather_object(hosts, host_id())
    return infer_topology([{"rank": r, "host": h}
                           for r, h in enumerate(hosts)], world)


def build_hierarchical_mesh(config: Optional[Mapping[str, int]] = None,
                            topology: Optional[Topology] = None,
                            device_type: Optional[str] = None):
    """A 2-D `DeviceMesh` named `(dp_inter, dp_intra)` over the default
    process group's ranks, laid out row-major hosts x local (rank =
    inter_pos * intra + intra_pos), as `Topology` numbers its members.

    Call `torch.distributed.init_process_group` first (one rank per
    device). `config` may only name dp (its degree must be the world);
    other axes are item 5. `topology` defaults to the hosts the ranks run
    on; tests pass an explicit `Topology(2, 2)` to emulate 2 hosts x 2
    devices. `device_type` defaults to CUDA, and raises without it."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "build_hierarchical_mesh spans the default process group: call "
            "torch.distributed.init_process_group first, one rank a device")
    world = dist.get_world_size()
    cfg = dict(config or {})
    others = {k: v for k, v in cfg.items() if k != "dp" and v != 1}
    if others:
        raise NotImplementedError(
            f"mesh axes {sorted(others)} need the port's meshes (ROADMAP "
            f"item 5); this slice builds data-parallel meshes only")
    dp = cfg.get("dp", world)
    if dp != world:
        raise ValueError(f"dp={dp} must cover the world of {world} ranks")
    if topology is None:
        topology = _host_topology(world)
    if topology.world != world:
        raise ValueError(
            f"dp={world} devices cannot form a {topology.inter}x"
            f"{topology.intra} (inter x intra) topology")
    device_type = default_device(device_type).type
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(topology.inter,
                                                  topology.intra),
                      mesh_dim_names=DP_SUB_AXES)


def dp_axis_names(mesh: Any) -> tuple:
    """The mesh dimensions carrying pure data parallelism: the
    `(dp_inter, dp_intra)` pair on a hierarchical mesh, the single `dp`
    otherwise. Empty when the mesh has neither."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if all(a in names for a in DP_SUB_AXES):
        return DP_SUB_AXES
    if "dp" in names:
        return ("dp",)
    return ()


def is_hierarchical_mesh(mesh: Any) -> bool:
    return dp_axis_names(mesh) == DP_SUB_AXES


def hier_topology(mesh: Any) -> Topology:
    """The `Topology` a hierarchical mesh's dp sub-axes express, with axis
    names bound to the mesh's dimension names."""
    if not is_hierarchical_mesh(mesh):
        raise ValueError(
            f"mesh axes {tuple(getattr(mesh, 'mesh_dim_names', None) or ())}"
            f" carry no (dp_inter, dp_intra) sub-axes; "
            f"build_hierarchical_mesh makes one")
    names = mesh.mesh_dim_names
    return Topology(inter=mesh.size(names.index(DP_SUB_AXES[0])),
                    intra=mesh.size(names.index(DP_SUB_AXES[1])),
                    inter_axis=DP_SUB_AXES[0], intra_axis=DP_SUB_AXES[1])


def hier_groups(mesh: Any) -> HierGroups:
    """This rank's `dp_intra` and `dp_inter` groups of a hierarchical mesh,
    for `util.collective.hierarchy`'s program bodies."""
    return HierGroups(hier_topology(mesh),
                      intra=Comm.registered(mesh.get_group(DP_SUB_AXES[1])),
                      inter=Comm.registered(mesh.get_group(DP_SUB_AXES[0])))


__all__ = ["DP_SUB_AXES", "build_hierarchical_mesh", "dp_axis_names",
           "is_hierarchical_mesh", "hier_topology", "hier_groups"]
