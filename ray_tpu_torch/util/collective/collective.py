"""The collective API, counterpart of `ray_tpu/util/collective/collective.py`.

The same module functions: named groups, ranks, and the ops `allreduce` …
`synchronize`, each counted in `hierarchy.BYTES` at the world hop as the JAX
package's `collective_bytes_total` counts it. A group here is a
`DistCollectiveGroup` (`nccl` or `gloo`) whose members meet through a torch
`Store`, in one of two ways:

- `store=` given: a Store, ``"file://<path>"`` or ``"tcp://host:port"``;
- no `store=`, inside the port's runtime (`ray_tpu_torch.init`): rank 0
  serves a `TCPStore` on a free port and puts its address in the head's KV
  under the group's name and generation; the other members read it there.
  `create_collective_group` (from the driver) writes the member actors'
  ranks to the head's KV as the JAX package does, and each member attaches
  on its first op. An NCCL member first takes its own card,
  ``cuda:{local rank}`` (its rank among the members on its host): a fresh
  actor's current device is 0, and two members of one host would collide.

The JAX package's `kv` group (collectives carried by the head's KV) has no
counterpart: members meet through the KV here and then run gloo or NCCL.
The reshard functions wait for item 5, the ops' tracing spans for item 23.
"""

from __future__ import annotations

import os
import pickle
import threading
import time
import uuid
from datetime import timedelta
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.util.collective.dist_group import (DistCollectiveGroup,
                                                      lookup_membership,
                                                      open_store)
from ray_tpu_torch.util.collective.hierarchy import account_collective
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

_groups: Dict[str, DistCollectiveGroup] = {}
_generations: Dict[str, int] = {}
# the store key of each group met through the runtime ("" when imperative,
# the declaration's key when attached)
_runtime_keys: Dict[str, str] = {}
# groups left by this process as rank 0 whose store it still serves to the
# members that have not left yet
_serving: List[DistCollectiveGroup] = []
_lock = threading.Lock()
# head KV namespaces: group membership declared by create_collective_group
# (the JAX package's name) and the address of each group's store
_META_NS = "collective_meta"
_STORE_NS = "collective_store"


def _client():
    """The runtime's client in this process, or None outside the runtime."""
    from ray_tpu_torch.core import api

    return api._client


def init_collective_group(world_size: int, rank: int, backend: str = "gloo",
                          group_name: str = "default", *, store=None,
                          timeout_s: float = 60.0) -> None:
    """Imperative init: every member calls this with its own rank and the
    same `store`, or with no store inside the runtime."""
    backend = Backend(backend)
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
        _groups[group_name] = _make_group(backend, group_name, world_size,
                                          rank, store, timeout_s)


def _make_group(backend, group_name, world_size, rank, store,
                timeout_s, key: str = "") -> DistCollectiveGroup:
    generation = _generations.get(group_name, 0)
    if store is None:
        store = _runtime_store(backend, group_name, generation, world_size,
                               rank, timeout_s, key)
        _runtime_keys[group_name] = key
    return DistCollectiveGroup(
        open_store(store, world_size, rank, timeout_s), group_name,
        world_size, rank, backend=backend, generation=generation,
        timeout_s=timeout_s)


def _store_key(group_name: str, generation: int, key: str) -> bytes:
    return f"{group_name}/{generation}/{key}".encode()


def _runtime_store(backend, group_name: str, generation: int,
                   world_size: int, rank: int, timeout_s: float,
                   key: str) -> dist.Store:
    """Meet through the head's KV: rank 0 serves a TCPStore on a free port
    and publishes "host:port"; the others wait for it. An NCCL member then
    takes ``cuda:{local rank}`` before its group is made."""
    client = _client()
    if client is None:
        raise ValueError(
            "members meet through a torch Store: pass store= (a Store, "
            "'file://<path>' or 'tcp://host:port'), or call this inside "
            "the runtime (ray_tpu_torch.init), whose head KV they meet "
            "through")
    kv_key = _store_key(group_name, generation, key)
    timeout = timedelta(seconds=timeout_s)
    if rank == 0:
        host = os.environ.get("RAY_TPU_NODE_IP") or "127.0.0.1"
        store = dist.TCPStore(host, 0, world_size, True, timeout,
                              wait_for_workers=False)
        client.kv_put(_STORE_NS, kv_key, f"{host}:{store.port}".encode())
    else:
        deadline = time.monotonic() + timeout_s
        while (addr := client.kv_get(_STORE_NS, kv_key)) is None:
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"collective group {group_name!r}: rank 0 published no "
                    f"store within {timeout_s:g} s")
            time.sleep(0.02)
        host, port = addr.decode().rsplit(":", 1)
        store = dist.TCPStore(host, int(port), world_size, False, timeout)
    if Backend(backend) == Backend.NCCL:
        torch.cuda.set_device(_local_rank(store, group_name, generation,
                                          world_size, rank))
    return store


def _local_rank(store: dist.Store, group_name: str, generation: int,
                world_size: int, rank: int) -> int:
    """This member's rank among the members on its host (each publishes
    its host to the store and reads the others')."""
    from ray_tpu_torch.util.collective.hierarchy import host_id

    prefix = f"collective/{group_name}/{generation}/hosts/"
    store.set(f"{prefix}{rank}", host_id())
    hosts = [store.get(f"{prefix}{r}").decode() for r in range(world_size)]
    return sum(1 for r in range(rank) if hosts[r] == hosts[rank])


def create_collective_group(actors: list, world_size: int, ranks: list,
                            backend: str = "gloo",
                            group_name: str = "default") -> None:
    """Declarative init from the driver: the member actors' ranks go to the
    head's KV, and each member attaches on its first op."""
    Backend(backend)
    if len(actors) != len(ranks) or len(actors) != world_size:
        raise ValueError("actors/ranks must both have world_size entries")
    client = _client()
    if client is None:
        raise RuntimeError("create_collective_group needs the runtime: call "
                           "ray_tpu_torch.init first")
    meta = {"world_size": world_size, "backend": backend,
            "ranks": {a._actor_id.hex(): r for a, r in zip(actors, ranks)},
            # each declaration meets under its own store key, so a later
            # group of the same name never reads a stale address
            "key": uuid.uuid4().hex}
    if not client.kv_put(_META_NS, group_name.encode(), pickle.dumps(meta),
                         overwrite=False):
        raise RuntimeError(f"collective group {group_name!r} already exists")


def _lazy_attach(group_name: str) -> Optional[DistCollectiveGroup]:
    """Join a group declared by create_collective_group, if this process
    is one of its actors (called under `_lock`)."""
    client = _client()
    if client is None or client.current_actor_id is None:
        return None
    blob = client.kv_get(_META_NS, group_name.encode())
    if blob is None:
        return None
    meta = pickle.loads(blob)
    rank = meta["ranks"].get(client.current_actor_id.hex())
    if rank is None:
        raise RuntimeError(
            f"this process is not a member of group {group_name!r}")
    group = _make_group(Backend(meta["backend"]), group_name,
                        meta["world_size"], rank, None, 60.0,
                        key=meta["key"])
    _groups[group_name] = group
    return group


def get_group(group_name: str = "default") -> DistCollectiveGroup:
    """The live group object, for what the module functions don't expose
    (allreduce_device, allreduce_tree, topology); a member actor of a
    group declared by create_collective_group attaches here."""
    with _lock:
        group = _groups.get(group_name) or _lazy_attach(group_name)
    if group is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized; call "
            "init_collective_group or create_collective_group first")
    return group


def rebuild_collective_group(world_size: int, rank: int,
                             backend: str = "gloo",
                             group_name: str = "default", *, store=None,
                             timeout_s: float = 60.0) -> None:
    """Destroy this process's membership of `group_name` and re-init at a
    new world size / rank under the NEXT generation's store prefix, so a
    member of the fenced generation can never meet the new one. Every
    surviving member calls this once per membership change; `store`
    defaults to the old generation's."""
    backend = Backend(backend)
    with _lock:
        old = _groups.pop(group_name, None)
        if old is not None:
            old.destroy()
            store = store if store is not None else old._base_store
        _generations[group_name] = _generations.get(group_name, 0) + 1
        _groups[group_name] = _make_group(backend, group_name, world_size,
                                          rank, store, timeout_s)


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def destroy_collective_group(group_name: str = "default") -> None:
    """Leave `group_name` and delete its declaration from the head's KV, so
    the name can be declared again. Rank 0 of a group met through the
    runtime serves its store and deletes the store's address; it keeps the
    store up until every other member has left too."""
    with _lock:
        group = _groups.pop(group_name, None)
        key = _runtime_keys.pop(group_name, None)
        client = _client()
        if group is not None:
            group.destroy()
            if key is not None and group.rank == 0:
                client.kv_del(_STORE_NS, _store_key(
                    group_name, group.generation, key))
                _serving.append(group)
            _serving[:] = [g for g in _serving if _others_remain(g)]
        if client is not None:
            client.kv_del(_META_NS, group_name.encode())


def _others_remain(group: DistCollectiveGroup) -> bool:
    """Whether a member other than rank 0 still has its membership record
    in the group's store (a member withdraws it when it leaves)."""
    return any(lookup_membership(group.store, r) is not None
               for r in range(1, group.world_size))


def get_rank(group_name: str = "default") -> int:
    return get_group(group_name).rank


def get_collective_group_size(group_name: str = "default") -> int:
    return get_group(group_name).world_size


# --------------------------------------------------------------- collectives
def _account(op_name: str, tensor=None) -> None:
    """collective_bytes_total{op, dtype, hop="world"} for one call (the JAX
    package's `_op_span` without its span)."""
    if tensor is not None:
        t = torch.as_tensor(tensor)
        account_collective(op_name, t.numel() * t.element_size(),
                           str(t.dtype), hop="world")


def allreduce(tensor, op: ReduceOp = ReduceOp.SUM,
              group_name: str = "default"):
    _account("allreduce", tensor)
    return get_group(group_name).allreduce(tensor, op)


def reduce(tensor, dst_rank: int = 0, op: ReduceOp = ReduceOp.SUM,
           group_name: str = "default"):
    _account("reduce", tensor)
    return get_group(group_name).reduce(tensor, dst_rank, op)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    _account("broadcast", tensor)
    return get_group(group_name).broadcast(tensor, src_rank)


def allgather(tensor_list: Optional[list], tensor,
              group_name: str = "default"):
    """Reference signature: fills tensor_list with world_size tensors."""
    _account("allgather", tensor)
    parts = get_group(group_name).allgather(tensor)
    if tensor_list is not None:
        tensor_list[:] = parts
    return parts


def reducescatter(tensor, op: ReduceOp = ReduceOp.SUM,
                  group_name: str = "default"):
    _account("reducescatter", tensor)
    return get_group(group_name).reducescatter(tensor, op)


def barrier(group_name: str = "default") -> None:
    get_group(group_name).barrier()


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    get_group(group_name).send(tensor, dst_rank)


def recv(tensor, src_rank: int, group_name: str = "default"):
    return get_group(group_name).recv(tensor, src_rank)


def synchronize(device=None) -> None:
    """Block until all queued device work completes (the reference syncs
    the CUDA stream); nothing to wait for on a host without CUDA."""
    if torch.cuda.is_available():
        torch.cuda.synchronize(device)


__all__ = [
    "init_collective_group", "create_collective_group",
    "rebuild_collective_group", "get_group",
    "destroy_collective_group", "is_group_initialized", "get_rank",
    "get_collective_group_size", "allreduce", "reduce", "broadcast",
    "allgather", "reducescatter", "barrier", "send", "recv", "synchronize",
]
