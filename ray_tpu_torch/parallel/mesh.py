"""Device meshes and logical-axis sharding rules (counterpart of
`ray_tpu/parallel/mesh.py`).

The JAX package builds one `jax.sharding.Mesh` over every chip, names an
axis per kind of parallelism (pp, dp, fsdp, sp, ep, tp) and leaves the
collectives to XLA. Here a mesh is a `torch.distributed.device_mesh.
DeviceMesh` over the ranks of torch's default process group, one process a
device, and a sharded tensor is a `torch.distributed.tensor.DTensor`: a
`PartitionSpec` becomes a tuple of per-mesh-dimension placements
(`spec_to_placements`), `with_sharding_constraint` becomes
`DTensor.redistribute` (`constrain`), and DTensor's sharding propagation
inserts the collectives. Model code stays one body for the sharded and the
unsharded case, as in JAX.

- `build_mesh`: the mesh of `MeshConfig`'s degrees, axes in canonical
  order (`MESH_AXES`);
- the flax-style logical rules (`DEFAULT_RULES`, `logical_to_spec`,
  `use_mesh`, `constrain`) map a model's logical axis names to mesh axes;
- `build_hierarchical_mesh`: the mesh whose dp axis is split into
  `(dp_inter, dp_intra)`, hosts x local devices, whose two dimensions'
  groups carry the two-level gradient sync of `train.spmd`; composed with
  fsdp, sp, ep and tp it is JAX's 7-D `HIER_MESH_AXES` mesh
  (`full_hierarchical_mesh`), whose other axes `model_submesh` hands to
  DTensor. pp on it is refused, as the JAX package's pipeline fails there.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Mapping, NamedTuple, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective._comm import Comm
from ray_tpu_torch.util.collective.hierarchy import (HierGroups, Topology,
                                                     host_id, infer_topology)
from ray_tpu_torch.utils.platform import default_device

# Canonical mesh axis names, outermost (slow-fabric tolerant) to innermost
# (fast-fabric only).
MESH_AXES = ("pp", "dp", "fsdp", "sp", "ep", "tp")

# Hierarchical data-parallel sub-axes: dp as (slow-fabric hosts) x
# (fast-fabric local devices).
DP_SUB_AXES = ("dp_inter", "dp_intra")
HIER_MESH_AXES = ("pp", "dp_inter", "dp_intra", "fsdp", "sp", "ep", "tp")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Degree of each parallelism axis. Product must equal the device count.

    Any axis left at -1 is inferred to absorb the remaining devices (at most
    one axis may be -1).
    """

    pp: int = 1    # pipeline stages
    dp: int = 1    # pure data parallel (gradients allreduced)
    fsdp: int = 1  # data parallel with parameters sharded (ZeRO-3 style)
    sp: int = 1    # sequence/context parallel (ring attention axis)
    ep: int = 1    # expert parallel (MoE)
    tp: int = 1    # tensor (megatron) parallel

    def degrees(self) -> dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    def resolved(self, n_devices: int) -> "MeshConfig":
        d = self.degrees()
        unknown = [a for a, v in d.items() if v == -1]
        if len(unknown) > 1:
            raise ValueError(f"at most one axis may be -1, got {unknown}")
        known = math.prod(v for v in d.values() if v != -1)
        if unknown:
            if n_devices % known:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes "
                    f"product {known}")
            d[unknown[0]] = n_devices // known
        if math.prod(d.values()) != n_devices:
            raise ValueError(
                f"mesh {d} has {math.prod(d.values())} slots but "
                f"{n_devices} devices")
        return MeshConfig(**d)


def adaptive_mesh_config(
    requested: Union[MeshConfig, Mapping[str, int]],
    n_devices: int,
    shrink_axes: Sequence[str] = ("dp", "fsdp"),
) -> MeshConfig:
    """Fit `requested` to what `n_devices` can actually hold.

    Elastic-training companion to `MeshConfig.resolved`: instead of
    erroring when the device count no longer matches (a worker or host was
    lost mid-run), shrink the `shrink_axes` (outermost data axes first, the
    ones whose degree is a pure throughput knob) toward 1 until the mesh
    fits, and grow them back (up to the requested degree) when capacity
    returns. Model-parallel axes (tp/pp/ep/sp) are never changed: their
    degree is baked into parameter shapes, so a mesh that cannot hold them
    is a hard error.

    The returned config may use only a SUBSET of `n_devices` (odd survivor
    counts); the caller runs the mesh over that many ranks.
    """
    if isinstance(requested, Mapping):
        requested = MeshConfig(**dict(requested))
    d = requested.degrees()
    if any(v == -1 for v in d.values()):
        return requested.resolved(n_devices)
    fixed = math.prod(v for a, v in d.items() if a not in shrink_axes)
    if fixed <= 0 or n_devices < fixed:
        raise ValueError(
            f"{n_devices} devices cannot hold fixed axes "
            f"{ {a: v for a, v in d.items() if a not in shrink_axes} } "
            f"(product {fixed})")
    # floor, don't reject: 3 survivors with tp=2 means a dp=1,tp=2 mesh on
    # 2 of them
    budget = n_devices // fixed
    # shrink the LAST shrink axis first (innermost data axis) so the
    # outer/data-parallel degree survives longest; grow in reverse
    for axis in reversed(list(shrink_axes)):
        while d[axis] > 1 and math.prod(d[a] for a in shrink_axes) > budget:
            d[axis] = (d[axis] // 2) if d[axis] % 2 == 0 else 1
    got = math.prod(d[a] for a in shrink_axes)
    if got > budget:
        raise ValueError(
            f"cannot shrink {tuple(shrink_axes)} below {got} to fit "
            f"budget {budget} ({n_devices} devices)")
    # absorb leftover capacity into the FIRST shrink axis (grow-back on
    # rejoin), never past the requested degree
    first = list(shrink_axes)[0]
    while (got * 2 <= budget
           and d[first] * 2 <= requested.degrees()[first]):
        d[first] *= 2
        got *= 2
    return MeshConfig(**d)


def _world(caller: str) -> int:
    if not dist.is_initialized():
        raise RuntimeError(
            f"{caller} spans the default process group: call "
            f"torch.distributed.init_process_group first, one rank a device")
    return dist.get_world_size()


def build_mesh(config: Union[MeshConfig, Mapping[str, int], None] = None,
               device_type: Optional[str] = None):
    """A `DeviceMesh` over the default process group's ranks with the
    canonical axis names, laid out row-major in `MESH_AXES` order (rank =
    the JAX mesh's device index).

    Axes of degree 1 drop out of the mesh, and a config whose every axis is
    1 gives a one-dimensional `dp` mesh of size 1. A dropped axis still
    resolves (`axis_size` gives 1, `spec_to_placements` skips it), so specs
    name all six axes as in JAX. The reason is DTensor's sharding
    propagation, which expands every op's strategies over every mesh
    dimension: on a six-dimensional mesh of 2 x 2 ranks one matmul took
    minutes to place, on the two-dimensional one milliseconds.

    Call `torch.distributed.init_process_group` first (one rank a device).
    `config` defaults to dp over the whole world. `device_type` defaults to
    CUDA, and raises without it."""
    from torch.distributed.device_mesh import DeviceMesh

    world = _world("build_mesh")
    if config is None:
        config = MeshConfig(dp=world)
    if isinstance(config, Mapping):
        config = MeshConfig(**dict(config))
    degrees = config.resolved(world).degrees()
    names = tuple(a for a in MESH_AXES if degrees[a] > 1) or ("dp",)
    device_type = default_device(device_type).type
    return DeviceMesh(device_type,
                      torch.arange(world).reshape(
                          [degrees[a] for a in names]),
                      mesh_dim_names=names)


def _hosts(world: int) -> list:
    """Every rank's `host_id` in the default group, by rank."""
    hosts = [None] * world
    dist.all_gather_object(hosts, host_id())
    return hosts


def _host_topology(world: int) -> Topology:
    """hosts x ranks-per-host of the default group (flat where hosts hold
    different counts)."""
    return infer_topology([{"rank": r, "host": h}
                           for r, h in enumerate(_hosts(world))], world)


def build_hierarchical_mesh(config: Optional[Mapping[str, int]] = None,
                            topology: Optional[Topology] = None,
                            device_type: Optional[str] = None):
    """A `DeviceMesh` over the default process group's ranks whose dp axis
    is split into `(dp_inter, dp_intra)`, laid out row-major hosts x local
    (dp rank = inter_pos * intra + intra_pos), as `Topology` numbers its
    members and as the JAX package lays out its dp slot.

    With dp alone (every other axis of `config` 1) it is the 2-D
    `(dp_inter, dp_intra)` mesh. With fsdp, sp, ep or tp it is the 7-D
    `HIER_MESH_AXES` mesh (`full_hierarchical_mesh`): `train.spmd` runs
    the two-level sync over the dp pair and leaves the other axes to
    DTensor on `model_submesh(mesh)`, as the JAX package's step is manual
    over the dp pair only. pp > 1 raises: the JAX package's pipeline opens
    a shard_map that fails nested inside its fused sync's (ROADMAP queue
    3). A dp left out of `config` takes the ranks the other axes leave.

    Call `torch.distributed.init_process_group` first (one rank per
    device). `topology` defaults to the hosts the ranks run on; tests pass
    an explicit `Topology(2, 2)` to emulate 2 hosts x 2 devices.
    `device_type` defaults to CUDA, and raises without it."""
    from torch.distributed.device_mesh import DeviceMesh

    degrees, topology = _hier_layout(config, topology)
    if any(v != 1 for a, v in degrees.items() if a != "dp"):
        return full_hierarchical_mesh(config, topology, device_type)
    return DeviceMesh(default_device(device_type).type,
                      torch.arange(topology.world).reshape(topology.inter,
                                                           topology.intra),
                      mesh_dim_names=DP_SUB_AXES)


def full_hierarchical_mesh(config: Optional[Mapping[str, int]] = None,
                           topology: Optional[Topology] = None,
                           device_type: Optional[str] = None):
    """`build_hierarchical_mesh`'s 7-D `HIER_MESH_AXES` mesh, ranks
    row-major in that order, whatever the degrees: with every axis but dp
    at 1 too it runs the composed path where `build_hierarchical_mesh`
    gives the 2-D mesh."""
    from torch.distributed.device_mesh import DeviceMesh

    degrees, topology = _hier_layout(config, topology)
    shape = [topology.inter if a == "dp_inter" else
             topology.intra if a == "dp_intra" else degrees[a]
             for a in HIER_MESH_AXES]
    return DeviceMesh(default_device(device_type).type,
                      torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=HIER_MESH_AXES)


def _hier_layout(config, topology) -> tuple:
    """(the degrees of `config` over the world, the Topology of its dp)."""
    world = _world("build_hierarchical_mesh")
    cfg = dict(config or {})
    if cfg.get("pp", 1) != 1:
        raise NotImplementedError(
            "pp on a hierarchical mesh: the JAX package's pipeline fails "
            "there (its shard_map nested in the fused sync's, manual over "
            "the dp pair, raises \"ValueError: The context mesh ... should "
            "match the mesh passed to shard_map\"), so the port refuses "
            "it (ROADMAP queue 3); compile_pipeline_train composes pp with "
            "dp on build_mesh")
    cfg.setdefault("dp", -1)
    degrees = MeshConfig(**cfg).resolved(world).degrees()
    dp = degrees["dp"]
    others = world // dp
    if topology is None:
        topology = _host_topology(world)
        if others > 1:   # the dp positions each host holds
            local = topology.intra // others if \
                topology.intra % others == 0 else 0
            topology = (Topology(dp // local, local)
                        if local > 1 and dp % local == 0
                        else Topology(dp, 1))
    if topology.world != dp:
        raise ValueError(
            f"dp={dp} devices cannot form a {topology.inter}x"
            f"{topology.intra} (inter x intra) topology")
    return degrees, topology


def model_submesh(mesh):
    """A hierarchical mesh's dimensions other than the dp pair, the axes
    DTensor shards the model and batch over, without those of degree 1
    (see `build_mesh` on why); the last (`tp`, size 1) where every one is
    1. None for the 2-D `(dp_inter, dp_intra)` mesh."""
    names = [a for a in mesh_axes(mesh) if a not in DP_SUB_AXES]
    if not names:
        return None
    keep = tuple(a for a in names if mesh.size(mesh_axes(mesh).index(a)) > 1)
    return mesh[keep or (names[-1],)]


def mesh_axes(mesh: Any) -> tuple:
    """The mesh's dimension names (() for None)."""
    return tuple(getattr(mesh, "mesh_dim_names", None) or ())


def dp_axis_names(mesh: Any) -> tuple:
    """The mesh dimensions carrying pure data parallelism: the
    `(dp_inter, dp_intra)` pair on a hierarchical mesh, the single `dp`
    otherwise. Empty when the mesh has neither."""
    names = mesh_axes(mesh)
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
            f"mesh axes {mesh_axes(mesh)} carry no (dp_inter, dp_intra) "
            f"sub-axes; build_hierarchical_mesh makes one")
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


def rules_for_mesh(mesh: Any, rules: Optional["LogicalRules"] = None
                   ) -> dict:
    """DEFAULT_RULES (plus overrides) rewritten for `mesh`'s dp spelling:
    on a hierarchical mesh every rule naming `dp` names the
    `(dp_inter, dp_intra)` pair instead, so logical specs like "batch"
    shard over both sub-axes without model code changing."""
    merged = {**DEFAULT_RULES, **(rules or {})}
    if not is_hierarchical_mesh(mesh):
        return merged
    out = {}
    for k, v in merged.items():
        axes = (v,) if isinstance(v, str) else v
        if axes and "dp" in axes:
            axes = tuple(a for ax in axes
                         for a in (DP_SUB_AXES if ax == "dp" else (ax,)))
            out[k] = axes
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Logical axis rules (flax-style) and a current-mesh context so model code
# can write `constrain(x, "batch", "seq", "embed")` without threading a mesh.
# ---------------------------------------------------------------------------

# logical axis -> mesh axis (or tuple of mesh axes, or None for replicated)
LogicalRules = Mapping[str, Union[str, tuple, None]]

DEFAULT_RULES: dict[str, Union[str, tuple, None]] = {
    "batch": ("dp", "fsdp"),
    "seq": "sp",            # activation sequence axis (context parallelism)
    "embed": "fsdp",        # parameter hidden axis: ZeRO-3 shard over fsdp
    "mlp": "tp",
    "heads": "tp",
    "kv": None,
    "vocab": "tp",
    "expert": "ep",
    "stage": "pp",
    "layers": None,
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of a tensor, as JAX's `PartitionSpec` holds
    them: each entry None (replicated), an axis name, or a tuple of axis
    names (the dimension split over them, the first the major)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


class Sharding(NamedTuple):
    """A mesh and one placement per mesh dimension, the counterpart of JAX's
    `NamedSharding`: ``Sharding(mesh, spec_to_placements(mesh, spec))``."""
    mesh: Any
    placements: tuple


class _MeshContext(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, Any] = dict(DEFAULT_RULES)


_ctx = _MeshContext()


class _ImplicitReplication:
    """DTensor's `implicit_replication`, nestable and shared by threads. The
    flag it sets is process-wide, and its context manager clears the flag
    on exit even while an outer one (or another thread's, such as the
    autograd engine's recompute) is still open; this keeps it set while
    any `use_mesh` block is open."""

    def __init__(self):
        self.lock = threading.Lock()
        self.depth = 0
        self.cm = None

    def __enter__(self):
        from torch.distributed.tensor.experimental import implicit_replication

        with self.lock:
            if self.depth == 0:
                self.cm = implicit_replication()
                self.cm.__enter__()
            self.depth += 1

    def __exit__(self, *exc):
        with self.lock:
            self.depth -= 1
            if self.depth == 0:
                self.cm.__exit__(None, None, None)
                self.cm = None


_implicit_replication = _ImplicitReplication()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[LogicalRules] = None):
    """Install `mesh` (and optionally override logical rules) for this
    thread. Inside it, plain tensors that meet DTensors in an op (a causal
    mask, positions) count as replicated."""
    prev_mesh, prev_rules = _ctx.mesh, _ctx.rules
    _ctx.mesh = mesh
    if rules is not None:
        _ctx.rules = {**DEFAULT_RULES, **rules}
    try:
        with _implicit_replication:
            yield mesh
    finally:
        _ctx.mesh, _ctx.rules = prev_mesh, prev_rules


def current_mesh():
    return _ctx.mesh


def current_rules() -> dict:
    """The logical rules active in this thread (a copy)."""
    return dict(_ctx.rules)


def with_current_mesh(fn):
    """fn, run under the mesh and rules active now from whichever thread
    calls it. The autograd engine runs the backward of CUDA tensors, and so
    a checkpointed block's recompute, on a thread of its own, where this
    thread's mesh is not installed: without it the recompute's `constrain`
    calls would do nothing and its shards would differ from the forward's.
    No-op without a mesh."""
    mesh, rules = _ctx.mesh, _ctx.rules
    if mesh is None:
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with use_mesh(mesh, rules):
            return fn(*args, **kwargs)
    return run


def logical_to_spec(*logical_axes: Optional[str],
                    rules: Optional[LogicalRules] = None) -> PartitionSpec:
    """Map logical axis names to a PartitionSpec via the active rules.

    Mesh axes consumed by an earlier logical axis are dropped (a mesh axis
    may only appear once in a PartitionSpec).
    """
    rules = dict(rules) if rules is not None else _ctx.rules
    used: set = set()
    parts = []
    for name in logical_axes:
        if name is None:
            parts.append(None)
            continue
        mesh_axes_ = rules.get(name)
        if mesh_axes_ is None:
            parts.append(None)
            continue
        if isinstance(mesh_axes_, str):
            mesh_axes_ = (mesh_axes_,)
        keep = tuple(a for a in mesh_axes_ if a not in used)
        used.update(keep)
        if not keep:
            parts.append(None)
        elif len(keep) == 1:
            parts.append(keep[0])
        else:
            parts.append(keep)
    while parts and parts[-1] is None:
        parts.pop()
    return PartitionSpec(*parts)


def spec_to_placements(mesh, spec: Sequence) -> tuple:
    """One placement per dimension of `mesh` for a PartitionSpec: `Shard(d)`
    where entry d names the mesh dimension, `Replicate()` elsewhere.

    Axes of degree 1 that `build_mesh` left out resolve to nothing. A
    dimension split over several axes names them in mesh order (major
    first), which is DTensor's order for nested shards."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axes(mesh)
    owner: dict = {}
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in axes:
            if a not in MESH_AXES and a not in DP_SUB_AXES:
                raise ValueError(f"unknown mesh axis {a!r} in {spec!r}")
            if a in owner:
                raise ValueError(f"mesh axis {a!r} appears twice in {spec!r}")
            owner[a] = dim
        present = [names.index(a) for a in axes if a in names]
        if present != sorted(present):
            raise ValueError(
                f"{spec!r} splits dimension {dim} over {axes}, against the "
                f"mesh's order {names}")
    return tuple(Shard(owner[a]) if a in owner else Replicate()
                 for a in names)


_constrain_suppressed = threading.local()


@contextlib.contextmanager
def suppress_constraints():
    """Disable `constrain` inside the with-block (the JAX package's
    manual pipeline lowering wraps its stage functions in it)."""
    prev = getattr(_constrain_suppressed, "on", False)
    _constrain_suppressed.on = True
    try:
        yield
    finally:
        _constrain_suppressed.on = prev


def constrain(x, *logical_axes: Optional[str]):
    """`with_sharding_constraint` by logical axis names: a DTensor is
    redistributed to the placements the active rules give these axes on the
    current mesh (a collective where they differ). No-op without a mesh,
    inside `suppress_constraints`, or on a plain tensor."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if mesh is None or getattr(_constrain_suppressed, "on", False) \
            or not isinstance(x, DTensor):
        return x
    placements = spec_to_placements(mesh, logical_to_spec(*logical_axes))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def local_window(shape: Sequence[int], mesh, placements) -> tuple:
    """This rank's index window (one slice a dimension) of a tensor of
    global `shape` under `placements` on `mesh`, as DTensor lays shards out:
    each `Shard(d)`, mesh dimensions left to right, splits the window so far
    along d into `torch.chunk`'s pieces (ceil-sized, the last ones short or
    empty) and keeps this rank's."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    win = [[0, int(n)] for n in shape]
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            lo, hi = win[p.dim % len(shape)]
            step = -(-(hi - lo) // mesh.size(i))
            start = min(lo + coord[i] * step, hi)
            win[p.dim % len(shape)] = [start, min(start + step, hi)]
    return tuple(slice(a, b) for a, b in win)


def axis_size(mesh, *axes: str) -> int:
    """The product of the axes' degrees; an axis the mesh left out (degree
    1) counts 1."""
    names = mesh_axes(mesh)
    return math.prod(mesh.size(names.index(a)) for a in axes if a in names)


def topology_from_devices() -> Topology:
    """Physical hosts x local-devices `Topology` of the default process
    group (one rank a device): hosts are the inter axis, each host's ranks
    the intra axis; hosts with fewer ranks truncate intra to the common
    minimum so the 2-D mesh stays rectangular."""
    counts = collections.Counter(_hosts(_world("topology_from_devices")))
    return Topology(inter=len(counts), intra=min(counts.values()))


__all__ = ["MESH_AXES", "DP_SUB_AXES", "HIER_MESH_AXES", "MeshConfig",
           "adaptive_mesh_config", "build_mesh", "build_hierarchical_mesh",
           "full_hierarchical_mesh", "model_submesh",
           "mesh_axes", "dp_axis_names", "is_hierarchical_mesh",
           "hier_topology", "hier_groups", "rules_for_mesh", "LogicalRules",
           "DEFAULT_RULES", "PartitionSpec", "P", "Sharding", "use_mesh",
           "current_mesh", "current_rules", "with_current_mesh", "logical_to_spec",
           "spec_to_placements", "suppress_constraints", "constrain",
           "local_window", "axis_size", "topology_from_devices"]
