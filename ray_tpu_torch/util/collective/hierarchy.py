"""Two-level (hierarchical) collectives over a hosts x local-devices topology.

Counterpart of `ray_tpu/util/collective/hierarchy.py`. The fast fabric
inside a host (NVLink here, ICI on a TPU) moves an order of magnitude more
bytes a second than the slow one between hosts. A flat allreduce pays the
slow fabric the whole payload S per member; the two-level schedule pays it
S/L (L = members per host):

    reduce-scatter over the INTRA group      (fast fabric, S bytes)
    allreduce of the scattered shard
        over the INTER group                 (slow fabric, S/L bytes)
    all-gather over the INTRA group          (fast fabric, S bytes)

The JAX package writes these as `shard_map` program bodies over a 2-D mesh.
Here each is a plain function of this member's flat vector and its two
process subgroups (`HierGroups`: a `DeviceMesh`'s `dp_intra` and `dp_inter`
dimensions, or the subgroups `dist_group` makes); each reduce is one call
of the backend's collective. The inter hop optionally runs quantized
(`quantize.QuantizedAllreduce`): intra stays full precision, only the slow
fabric carries int8/fp8.

Byte accounting keeps the JAX package's `(op, dtype, hop)` counts in
`BYTES` and the quantization saving in `SAVED` (its Prometheus counters
`collective_bytes_total` and `collective_quant_bytes_saved_total`; the
export waits for the port's metrics layer).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import socket
from typing import Callable, Dict, List, Optional

import torch

from ray_tpu_torch.util.collective._comm import Comm
from ray_tpu_torch.util.collective.types import ReduceOp

# ------------------------------------------------------------------ metrics
# collective_bytes_total{op, dtype, hop}: hop is world (flat), intra (fast
# fabric) or inter (slow fabric)
BYTES: collections.Counter = collections.Counter()
# collective_quant_bytes_saved_total, under the key "bytes"
SAVED: collections.Counter = collections.Counter()


def dtype_name(dtype) -> str:
    """A dtype as the JAX package's accounting spells it ("float32")."""
    return str(dtype).removeprefix("torch.")


def account_collective(op: str, nbytes: int, dtype: str,
                       hop: str = "world") -> None:
    """Record wire bytes for one collective call."""
    if nbytes <= 0:
        return
    BYTES[(op, dtype_name(dtype), hop)] += int(nbytes)


def account_quant_saving(saved_bytes: int) -> None:
    if saved_bytes > 0:
        SAVED["bytes"] += int(saved_bytes)


def ring_perm(world: int) -> List[tuple]:
    """The canonical one-step ring permutation [(i, i+1 mod w)] shared by
    every ring consumer (the quantized inter ring, later ring attention and
    pipeline hand-off)."""
    return [(i, (i + 1) % world) for i in range(world)]


# ----------------------------------------------------------------- topology
@dataclasses.dataclass(frozen=True)
class Topology:
    """Hosts x local-devices shape of a collective gang.

    `inter` is the slow-fabric degree (hosts), `intra` the fast-fabric
    degree (devices per host). `intra == 1` degenerates to a flat
    allreduce over `inter` members. Member (inter_pos, intra_pos) is flat
    rank inter_pos * intra + intra_pos (row-major hosts x local), the
    layout `parallel.mesh.build_hierarchical_mesh` gives a `DeviceMesh`.
    """

    inter: int
    intra: int = 1
    inter_axis: str = "inter"
    intra_axis: str = "intra"

    def __post_init__(self):
        if self.inter < 1 or self.intra < 1:
            raise ValueError(f"bad topology {self.inter}x{self.intra}")

    @property
    def world(self) -> int:
        return self.inter * self.intra

    def shard_index(self, inter_pos: int, intra_pos: int) -> int:
        """Global shard slot the two-level reduce-scatter leaves on member
        (inter_pos, intra_pos). The schedule scatters the INTRA axis first
        (full payload on the fast fabric) and the inter axis second (1/intra
        of it on the slow fabric), so shards land fast-axis-major: slot =
        intra_pos·inter + inter_pos, inverted exactly by `hier_all_gather`
        (gather inter first, then intra)."""
        return intra_pos * self.inter + inter_pos


def host_id() -> str:
    """The host a member names in its membership record:
    ``RAY_TPU_NODE_IP`` where set (as in the JAX package), else the host
    name."""
    return os.environ.get("RAY_TPU_NODE_IP") or socket.gethostname()


def infer_topology(members: List[dict], world_size: int,
                   override: Optional[Topology] = None) -> Topology:
    """Topology from membership records (`dist_group` publishes `host` and
    `local_devices` per rank), or the explicit override.

    Members on the same `host` form an intra group; the hierarchy only
    engages when every host holds the same member count (asymmetric gangs
    fall back to flat, which is always correct)."""
    if override is not None:
        return override
    hosts: Dict[str, int] = {}
    for rec in members:
        hosts[str(rec.get("host", rec.get("rank")))] = (
            hosts.get(str(rec.get("host", rec.get("rank"))), 0) + 1)
    if hosts:
        counts = set(hosts.values())
        if len(counts) == 1:
            per = counts.pop()
            if per > 1 and len(hosts) * per == world_size:
                return Topology(inter=len(hosts), intra=per)
    return Topology(inter=world_size, intra=1)


def rank_rows_by_host(members: List[dict]) -> List[List[int]]:
    """Group membership records into per-host rows of ranks (hosts in the
    order of their lowest rank, ranks sorted within a row): the hosts x
    local layout of a gang, the counterpart of the JAX package's
    `device_rows_by_process`."""
    rows: Dict[str, List[int]] = {}
    for rec in sorted(members, key=lambda r: int(r["rank"])):
        rows.setdefault(str(rec.get("host", rec["rank"])), []).append(
            int(rec["rank"]))
    return list(rows.values())


@dataclasses.dataclass(frozen=True)
class HierGroups:
    """This member's two subgroups of `topo`: `intra` over its host row
    (size topo.intra, rank = intra_pos) and `inter` over its column (size
    topo.inter, rank = inter_pos). Either may be None where its degree is
    1; the program bodies below never call a collective on a None."""

    topo: Topology
    intra: Optional[Comm]
    inter: Optional[Comm]

    @property
    def intra_pos(self) -> int:
        return self.intra.rank if self.intra is not None else 0

    @property
    def inter_pos(self) -> int:
        return self.inter.rank if self.inter is not None else 0


# ------------------------------------------------------------- the reduces
def gathered_reduce(x: torch.Tensor, comm: Comm,
                    reducer: Callable[[torch.Tensor], torch.Tensor],
                    cap_bytes: int = 32 * (1 << 20)) -> torch.Tensor:
    """All-gather-then-reduce for ops with no scatter or reduce primitive
    here (PRODUCT), without materializing an unbounded [world, ...]
    intermediate: the flat input is gathered in chunks so each gathered
    buffer stays under `cap_bytes`. `reducer` folds a [world, n] block to
    [n]; every member folds the same gathered bits, so all get the same
    result."""
    world = comm.size
    flat = x.reshape(-1)
    n = flat.numel()
    per = max(1, cap_bytes // (world * x.element_size()))
    parts = []
    for s in range(0, n, per):
        piece = flat[s:s + per].contiguous()
        g = piece.new_empty(world * piece.numel())
        comm.all_gather(g, piece)
        parts.append(reducer(g.view(world, -1)))
    if not parts:
        return x.clone()
    return torch.cat(parts).reshape(x.shape)


def _product(g: torch.Tensor) -> torch.Tensor:
    out = g[0].clone()
    for row in g[1:]:
        out *= row
    return out


def _reduce(x: torch.Tensor, comm: Comm, op: ReduceOp) -> torch.Tensor:
    """x reduced over `comm` into a new tensor."""
    if op is ReduceOp.PRODUCT:
        return gathered_reduce(x, comm, _product)
    return comm.all_reduce(x.clone(), op)


def _scatter(v: torch.Tensor, comm: Optional[Comm], op: ReduceOp
             ) -> torch.Tensor:
    """This member's slice of v reduced over `comm` (tiled: rank r keeps
    slice r). SUM is the backend's reduce-scatter; other ops reduce, then
    slice, as the JAX package's program does."""
    if comm is None or comm.size == 1:
        return v
    per = v.numel() // comm.size
    if op is ReduceOp.SUM:
        return comm.reduce_scatter(v.new_empty(per), v)
    full = _reduce(v, comm, op)
    return full[comm.rank * per:(comm.rank + 1) * per].clone()


def _gather(s: torch.Tensor, comm: Optional[Comm]) -> torch.Tensor:
    """Every member's s concatenated in rank order (tiled all-gather)."""
    if comm is None or comm.size == 1:
        return s
    return comm.all_gather(s.new_empty(s.numel() * comm.size), s)


def _check_split(v: torch.Tensor, groups: HierGroups) -> None:
    if v.dim() != 1 or v.numel() % groups.topo.intra:
        raise ValueError(
            f"need a flat vector whose size divides by intra="
            f"{groups.topo.intra}, got shape {tuple(v.shape)}")


# ------------------------------------------------------- the program bodies
def hier_phase_programs(groups: HierGroups, quantize=None,
                        op: ReduceOp = ReduceOp.SUM) -> Dict[str, Callable]:
    """The two-level schedule split at its phase boundaries, the one body
    every reduce below composes: {"rs", "ar", "ag"}.

        rs(v)                         this member's intra-scattered shard
        ar(s, residual=None, generator=None)
                                      the shard reduced over inter; with
                                      `residual`, (reduced, new residual)
        ag(s)                         the shards gathered back over intra

    A SUM's inter hop runs quantized where `quantize` is given and the hop
    has more than one member (the gather exchange of `QuantizedAllreduce`,
    with error feedback when `residual` is given); otherwise it is the
    backend's collective, at any degree, and `residual` comes back zeroed
    (nothing was quantized). Other ops reduce, then slice on the intra
    group, as the JAX package's program does. The timed step of
    `train.spmd` times each phase on its own."""

    def rs(v):
        _check_split(v, groups)
        return _scatter(v, groups.intra, op)

    def ar(s, residual=None, generator=None):
        if (quantize is not None and op is ReduceOp.SUM
                and groups.topo.inter > 1):
            if residual is not None:
                return quantize.inter_allreduce_ef(
                    s, residual, groups.inter, generator=generator)
            return quantize.inter_allreduce(s, groups.inter,
                                            generator=generator)
        # never hand back the caller's vector (rs passes it through where
        # intra is 1)
        s = (_reduce(s, groups.inter, op) if groups.inter is not None
             else s.clone())
        return s if residual is None else (s, residual * 0)

    def ag(s):
        return _gather(s, groups.intra)

    return {"rs": rs, "ar": ar, "ag": ag}


def hier_allreduce(v: torch.Tensor, groups: HierGroups,
                   op: ReduceOp = ReduceOp.SUM, quantize=None
                   ) -> torch.Tensor:
    """This member's flat [n] (n % intra == 0) fully reduced over the gang.

    SUM is reduce-scatter(intra) + allreduce(inter) + all-gather(intra);
    with `quantize` the inter hop becomes the quantized all-gather
    exchange. Non-sum ops reduce-then-slice on the intra group, keeping the
    inter hop shard-sized all the same."""
    p = hier_phase_programs(groups, quantize, op)
    return p["ag"](p["ar"](p["rs"](v)))


def hier_grad_sync(v: torch.Tensor, groups: HierGroups, quantize=None, *,
                   residual: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """Two-level gradient sum of this member's flat f32 vector [n]
    (n % world == 0; a quantized inter hop also needs n/intra % chunk == 0:
    pad with `quantize.padded_size`).

        hier_grad_sync(v, g)                     -> summed v
        hier_grad_sync(v, g, q, residual=r)      -> (summed v, new r)

    With `residual` (error feedback, at shard size [n/intra]) the inter hop
    quantizes v's shard plus r; `generator` drives stochastic rounding where
    `quantize` asks for it. The sum is NOT averaged: divide by
    `groups.topo.world` at the call site."""
    if residual is not None and quantize is None:
        raise ValueError("error_feedback requires a quantize config")
    p = hier_phase_programs(groups, quantize)
    if residual is None:
        return p["ag"](p["ar"](p["rs"](v), generator=generator))
    s, new_r = p["ar"](p["rs"](v), residual, generator)
    return p["ag"](s), new_r


def hier_allreduce_ef(v: torch.Tensor, residual: torch.Tensor,
                      groups: HierGroups, quantize) -> tuple:
    """Error-feedback SUM, (v, residual shard) -> (reduced v, new residual
    shard): `hier_grad_sync` with a residual, under the JAX package's name.
    Where the inter hop has one member nothing is quantized and the
    residual comes back zeroed."""
    return hier_grad_sync(v, groups, quantize, residual=residual)


def hier_reduce_scatter(v: torch.Tensor, groups: HierGroups,
                        op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
    """Two-level reduce-scatter: this member's fully-reduced shard
    [n/world] of its flat [n]. The inter hop moves only the intra-scattered
    shard, then scatters it again across inter. Shard assignment is
    `Topology.shard_index` (fast-axis-major), not flat rank order."""
    if v.dim() != 1 or v.numel() % groups.topo.world:
        raise ValueError(f"need a flat vector whose size divides by the "
                         f"world {groups.topo.world}")
    return _scatter(_scatter(v, groups.intra, op), groups.inter, op)


def hier_all_gather(shard: torch.Tensor, groups: HierGroups
                    ) -> torch.Tensor:
    """Two-level all-gather, the inverse of `hier_reduce_scatter`: gather
    over inter first (shard-sized on the slow fabric), then intra."""
    return _gather(_gather(shard, groups.inter), groups.intra)


__all__ = [
    "Topology", "HierGroups", "host_id", "infer_topology",
    "rank_rows_by_host",
    "hier_allreduce", "hier_allreduce_ef", "hier_grad_sync",
    "hier_phase_programs", "hier_reduce_scatter", "hier_all_gather",
    "gathered_reduce", "account_collective", "account_quant_saving",
    "ring_perm", "BYTES", "SAVED",
]
