"""Cross-process collective group over `torch.distributed`.

Counterpart of `ray_tpu/util/collective/xla_multihost.py`
(`XlaMultihostGroup`): N member processes form a gang whose collectives run
on the backend's own transport, NCCL between GPUs or gloo on the CPU. One
process per device is torch's idiom, so a member is one rank.

- Peers meet through a torch `Store` (a `FileStore` or a `TCPStore`; the
  JAX package meets through the head's KV client, which the port gets with
  its core runtime). Each group name and generation gets its own
  `PrefixStore`, so a rebuilt generation never meets a fenced one's keys.
- The group is made on that store directly (`ProcessGroupGloo` /
  `ProcessGroupNCCL`), not as torch's default process group, so several
  named groups live in one process beside a `DeviceMesh`'s.
- Each member publishes its host (``RAY_TPU_NODE_IP`` where set, as in the
  JAX package, else the host name) and local device count to the store
  (`lookup_membership` reads one back); `allreduce_device` groups the gang
  into hosts x local members with `hierarchy.infer_topology` and makes the
  two subgroups of the two-level schedule on first use.
- Inside the runtime a member also publishes worker id -> {group, rank,
  world, host} in the head's KV, as the JAX package's `xla-multihost`
  group does (`lookup_worker` reads it): the device object store then
  moves a device object between two members of one group over the group
  itself (`send_device`/`recv_device`: NCCL between cards) instead of a
  host snapshot.
- A dead peer is noticed by the backend's own timeout (`timeout_s`, gloo;
  NCCL's watchdog), not by a per-call deadline.
- `nccl` on a host without CUDA raises here; it never turns into gloo.
"""

from __future__ import annotations

import datetime
import json
import pickle
import threading
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective import hierarchy as _hier
from ray_tpu_torch.util.collective._comm import Comm
from ray_tpu_torch.util.collective.types import Backend, ReduceOp
from ray_tpu_torch.utils.tree import leaves, tree_map


def _make_pg(backend: str, store, rank: int, size: int, timeout_s: float):
    if backend == Backend.NCCL:
        return dist.ProcessGroupNCCL(store, rank, size)
    return dist.ProcessGroupGloo(store, rank, size,
                                 datetime.timedelta(seconds=timeout_s))


def open_store(spec, world_size: int, rank: int,
               timeout_s: float = 60.0) -> dist.Store:
    """A torch Store from `spec`: a Store as it is, ``"tcp://host:port"``
    (rank 0 serves it) or ``"file://<path>"`` / a plain path (a FileStore
    every member opens)."""
    if isinstance(spec, dist.Store):
        return spec
    spec = str(spec)
    if spec.startswith("tcp://"):
        host, port = spec[len("tcp://"):].rsplit(":", 1)
        return dist.TCPStore(host, int(port), world_size, rank == 0,
                             datetime.timedelta(seconds=timeout_s))
    return dist.FileStore(spec.removeprefix("file://"), world_size)


# head KV namespace of worker id -> membership (the JAX package's
# `xla_multihost._MEMBER_NS` keeps the same records)
_MEMBER_NS = "collective_members"


def _runtime_client():
    """The runtime's client in this process, or None outside it."""
    from ray_tpu_torch.core import api

    return api._client


class DistCollectiveGroup:
    """One member process of a cross-process collective gang."""

    # the device object store may move device objects over this group
    device_plane = True

    def __init__(self, store: dist.Store, group_name: str, world_size: int,
                 rank: int, backend: str = "gloo", generation: int = 0,
                 timeout_s: float = 60.0):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} out of range for world "
                             f"{world_size}")
        self.backend_name = Backend(backend)
        if self.backend_name == Backend.NCCL:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "backend 'nccl' needs a CUDA device and this host has "
                    "none; use backend='gloo' for CPU collectives")
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.generation = generation
        self._base_store = store
        self.store = dist.PrefixStore(
            f"collective/{group_name}/{generation}/", store)
        self._timeout_s = timeout_s
        # collective calls are serialized per process: two threads
        # interleaving calls on one group would mismatch the call order
        # across members
        self._op_lock = threading.Lock()
        self._comm = Comm(_make_pg(
            self.backend_name, dist.PrefixStore("world/", self.store),
            rank, world_size, timeout_s), self.backend_name)
        self._hier_groups: Optional[_hier.HierGroups] = None
        self._ef_state: Dict[tuple, torch.Tensor] = {}
        self._publish_membership()

    # ------------------------------------------------------------ membership
    def _publish_membership(self) -> None:
        local = (torch.cuda.device_count()
                 if self.backend_name == Backend.NCCL else 1)
        record = {"group": self.group_name, "rank": self.rank,
                  "world": self.world_size, "host": _hier.host_id(),
                  "local_devices": local}
        self.store.set(f"members/{self.rank}", json.dumps(record))
        client = _runtime_client()
        if client is not None:
            client.kv_put(_MEMBER_NS, client.worker_id.hex().encode(),
                          pickle.dumps(record), overwrite=True)

    def members(self) -> List[dict]:
        """Every member's record (waits until all have published)."""
        return [lookup_membership(self.store, r, wait=True)
                for r in range(self.world_size)]

    @property
    def topology(self) -> _hier.Topology:
        """The gang's hosts x local topology; its first use is collective
        (every member makes its two subgroups)."""
        return self._groups().topo

    def _groups(self) -> _hier.HierGroups:
        """The two subgroups of the hosts x local topology, made on first
        use (collectively: every member comes here in the same call)."""
        if self._hier_groups is not None:
            return self._hier_groups
        members = self.members()
        topo = _hier.infer_topology(members, self.world_size)
        rows = (_hier.rank_rows_by_host(members) if topo.intra > 1
                else [[r] for r in range(self.world_size)])
        inter_pos = next(i for i, row in enumerate(rows) if self.rank in row)
        intra_pos = rows[inter_pos].index(self.rank)

        def sub(kind, pos, rank, size):
            if size == 1:
                return None
            store = dist.PrefixStore(f"{kind}/{pos}/", self.store)
            return Comm(_make_pg(self.backend_name, store, rank, size,
                                 self._timeout_s), self.backend_name)

        self._hier_groups = _hier.HierGroups(
            topo, intra=sub("intra", inter_pos, intra_pos, topo.intra),
            inter=sub("inter", intra_pos, inter_pos, topo.inter))
        return self._hier_groups

    # ---------------------------------------------------------------- helpers
    def _tensor(self, tensor) -> torch.Tensor:
        """A tensor argument (numpy arrays are wrapped: in-place results
        land in the caller's array)."""
        return (tensor if isinstance(tensor, torch.Tensor)
                else torch.from_numpy(tensor))

    # ------------------------------------------------------------ collectives
    def allreduce(self, tensor, op: ReduceOp = ReduceOp.SUM):
        """In place: the caller's tensor holds the reduced value after."""
        t = self._tensor(tensor)
        with self._op_lock:
            if op is ReduceOp.PRODUCT:
                t.copy_(_hier.gathered_reduce(t, self._comm, _hier._product))
            else:
                self._comm.all_reduce(t, op)
        return tensor

    def reduce(self, tensor, dst_rank: int = 0,
               op: ReduceOp = ReduceOp.SUM):
        """The reduced value lands in dst_rank's tensor; the others keep
        theirs."""
        t = self._tensor(tensor)
        with self._op_lock:
            out = _hier._reduce(t, self._comm, op)
        if self.rank == dst_rank:
            t.copy_(out)
        return tensor

    def broadcast(self, tensor, src_rank: int = 0):
        t = self._tensor(tensor)
        with self._op_lock:
            self._comm.broadcast(t, src_rank)
        return tensor

    def allgather(self, tensor) -> List[torch.Tensor]:
        t = self._tensor(tensor)
        flat = t.reshape(-1)
        wire = flat if flat.dtype != torch.float8_e4m3fn else flat.view(
            torch.uint8)
        with self._op_lock:
            out = self._comm.all_gather(
                wire.new_empty(self.world_size * wire.numel()),
                wire.contiguous())
        out = out.view(t.dtype).view((self.world_size,) + tuple(t.shape))
        return [out[i] for i in range(self.world_size)]

    def reducescatter(self, tensor, op: ReduceOp = ReduceOp.SUM
                      ) -> torch.Tensor:
        """Input [world, ...]; returns this rank's reduced slice."""
        t = self._tensor(tensor)
        if t.shape[0] != self.world_size:
            raise ValueError(f"reducescatter input leading dim {t.shape[0]} "
                             f"!= world {self.world_size}")
        with self._op_lock:
            if op is ReduceOp.SUM:
                out = self._comm.reduce_scatter(
                    t.new_empty(t[0].numel()), t.reshape(-1).contiguous())
                return out.view(t.shape[1:])
            return _hier._reduce(t, self._comm, op)[self.rank]

    def barrier(self) -> None:
        with self._op_lock:
            self._comm.barrier()

    def send(self, tensor, dst_rank: int) -> None:
        if dst_rank == self.rank:
            raise ValueError("send to self")
        with self._op_lock:
            self._comm.send(self._tensor(tensor), dst_rank)

    def recv(self, tensor, src_rank: int):
        if src_rank == self.rank:
            raise ValueError("recv from self")
        with self._op_lock:
            self._comm.recv(self._tensor(tensor), src_rank)
        return tensor

    def send_device(self, tensor: torch.Tensor, dst_rank: int) -> None:
        """Send a tensor that lives on this member's device."""
        self.send(tensor, dst_rank)

    def recv_device(self, shape, dtype, src_rank: int) -> torch.Tensor:
        """Receive into a new tensor on this member's device."""
        out = torch.empty(shape, dtype=dtype, device=self.device)
        return self.recv(out, src_rank)

    # --------------------------------------- hierarchical device-plane path
    def allreduce_device(self, tensor: torch.Tensor,
                         op: ReduceOp = ReduceOp.SUM, *, quantize=None,
                         average: bool = False, ef_key: str = ""
                         ) -> torch.Tensor:
        """Hierarchical allreduce of a FLOATING tensor (f32 or narrower);
        returns a new tensor of its dtype and shape on its device (the input
        is not mutated).

        The payload, staged through f32 and padded, is reduce-scattered over
        this member's host (intra), its shard allreduced across hosts
        (inter) and gathered back. With `quantize` the inter hop runs the
        int8/fp8 all-gather exchange with per-chunk scales (every member
        dequantizes and sums in rank order: the ring's bits, with no
        send/recv). Error-feedback residuals persist between calls, keyed
        by (`ef_key`, shard size, quant config): callers syncing SEVERAL
        same-sized buffers pass a distinct `ef_key` per buffer, or their
        residuals mix."""
        x = self._tensor(tensor)
        if not x.is_floating_point():
            raise TypeError(
                f"allreduce_device needs a floating dtype, got {x.dtype}; "
                f"integer tensors take the flat allreduce()")
        if x.element_size() > 4:
            raise TypeError(
                f"allreduce_device stages through f32 and would silently "
                f"truncate {x.dtype} precision; use the flat allreduce() "
                f"(dtype-preserving) or downcast explicitly")
        if quantize is not None and op is not ReduceOp.SUM:
            raise ValueError(
                f"quantized allreduce supports SUM only (got {op.name}): "
                f"the int8/fp8 exchange accumulates contributions in f32 "
                f"source-rank order, which has no analog for other "
                f"reductions — drop quantize= for {op.name}")
        with self._op_lock:
            g = self._groups()
            t = g.topo
            n = x.numel()
            colpad = -(-max(n, 1) // t.intra)
            if quantize is not None:
                colpad = quantize.padded_size(colpad)
            flat = torch.zeros(t.intra * colpad, dtype=torch.float32,
                               device=x.device)
            flat[:n] = x.reshape(-1)
            if quantize is not None and quantize.error_feedback:
                rkey = (ef_key, colpad, quantize.key())
                r = self._ef_state.get(rkey)
                if r is None:
                    r = flat.new_zeros(colpad)
                out, self._ef_state[rkey] = _hier.hier_grad_sync(
                    flat, g, quantize, residual=r)
            else:
                out = _hier.hier_allreduce(flat, g, op, quantize)
            if average:
                out = out / self.world_size
        self._account_hier(op, colpad, quantize)
        return out[:n].reshape(x.shape).to(x.dtype)

    def _account_hier(self, op: ReduceOp, colpad: int, quantize) -> None:
        t = self.topology
        fp32_wire = 2 * (t.inter - 1) * colpad * 4 * t.intra // max(t.inter, 1)
        if quantize is not None and op is ReduceOp.SUM:
            wire = (t.inter - 1) * quantize.wire_bytes(colpad) * t.intra
            _hier.account_collective("allreduce", wire, quantize.dtype,
                                     hop="inter")
            _hier.account_quant_saving(max(0, fp32_wire - wire))
        else:
            _hier.account_collective("allreduce", fp32_wire, "float32",
                                     hop="inter")
        if t.intra > 1:
            # scatter + regather on the host-local fabric
            _hier.account_collective("allreduce", 2 * t.intra * colpad * 4,
                                     "float32", hop="intra")

    def allreduce_tree(self, tree, *, average: bool = True, quantize=None):
        """Fused gradient sync: the tree's leaves (sorted-key order) in one
        f32 buffer, ONE hierarchical allreduce, each leaf cast back to its
        dtype and shape."""
        parts = leaves(tree)
        if not parts:
            return tree
        fused = torch.cat([p.reshape(-1).to(torch.float32) for p in parts])
        out = self.allreduce_device(fused, ReduceOp.SUM, quantize=quantize,
                                    average=average)
        pieces = iter(out.split([p.numel() for p in parts]))
        return tree_map(lambda p: next(pieces).view(p.shape).to(p.dtype),
                        tree)

    def destroy(self) -> None:
        """Withdraw the membership record; NCCL communicators are shut
        down (gloo's close when the group is collected)."""
        self.store.delete_key(f"members/{self.rank}")
        client = _runtime_client()
        if client is not None:
            client.kv_del(_MEMBER_NS, client.worker_id.hex().encode())
        self._ef_state.clear()
        if self.backend_name == Backend.NCCL:
            g = self._hier_groups
            for comm in (self._comm,) + ((g.intra, g.inter) if g else ()):
                if comm is not None:
                    comm.pg.shutdown()


# never a record (records are JSON objects): compare_set returns it as the
# value of a key that is absent
_ABSENT = "\0absent"


def lookup_membership(store: dist.Store, rank: int,
                      wait: bool = False) -> Optional[dict]:
    """A member's published record in a group's store (`group.store`), or
    None (waits for it when `wait`).

    Without `wait` the record is read in one store op that never blocks:
    `compare_set` with an expected value no record has returns the record
    when the key exists and the expected value when it does not, and sets
    nothing either way. A `check` then a `get` would race a member that
    withdraws its record between the two (`destroy`), and the `get` would
    then block for the store's whole timeout."""
    key = f"members/{rank}"
    if wait:
        return json.loads(store.get(key))
    raw = store.compare_set(key, _ABSENT, _ABSENT)
    return None if raw == _ABSENT.encode() else json.loads(raw)


def lookup_worker(client, worker_id_hex: str) -> Optional[dict]:
    """Head-KV lookup: the membership record of worker `worker_id_hex`
    ({group, rank, world, host, local_devices}), or None. The device object
    store reads it to pick the gang route between two members."""
    blob = client.kv_get(_MEMBER_NS, worker_id_hex.encode())
    return pickle.loads(blob) if blob else None


__all__ = ["DistCollectiveGroup", "lookup_membership", "lookup_worker",
           "open_store"]
