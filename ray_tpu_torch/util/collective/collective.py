"""The collective API, counterpart of `ray_tpu/util/collective/collective.py`.

The same module functions: named groups, ranks, and the ops `allreduce` …
`synchronize`, each counted in `hierarchy.BYTES` at the world hop as the JAX
package's `collective_bytes_total` counts it. A group here is a
`DistCollectiveGroup` (`nccl` or `gloo`) whose members meet through a torch
`Store`: pass `store=` as a Store, ``"file://<path>"`` or
``"tcp://host:port"``. The JAX package meets through the head's KV client
instead; the port's core runtime (ROADMAP item 15) is not ported yet, so
`create_collective_group` (actors) raises, the `kv` group waits for item 16,
the reshard functions for item 5, and the ops' tracing spans for item 23.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

import torch

from ray_tpu_torch.util.collective.dist_group import (DistCollectiveGroup,
                                                      open_store)
from ray_tpu_torch.util.collective.hierarchy import account_collective
from ray_tpu_torch.util.collective.types import Backend, ReduceOp

_groups: Dict[str, DistCollectiveGroup] = {}
_generations: Dict[str, int] = {}
_lock = threading.Lock()


def init_collective_group(world_size: int, rank: int, backend: str = "gloo",
                          group_name: str = "default", *, store=None,
                          timeout_s: float = 60.0) -> None:
    """Imperative init: every member calls this with its own rank and the
    same `store`."""
    backend = Backend(backend)
    with _lock:
        if group_name in _groups:
            raise RuntimeError(f"group {group_name!r} already initialized")
        _groups[group_name] = _make_group(backend, group_name, world_size,
                                          rank, store, timeout_s)


def _make_group(backend, group_name, world_size, rank, store,
                timeout_s) -> DistCollectiveGroup:
    if store is None:
        raise ValueError(
            "members meet through a torch Store: pass store= (a Store, "
            "'file://<path>' or 'tcp://host:port'); the runtime's own "
            "rendezvous comes with the core client (ROADMAP item 15)")
    return DistCollectiveGroup(
        open_store(store, world_size, rank, timeout_s), group_name,
        world_size, rank, backend=backend,
        generation=_generations.get(group_name, 0), timeout_s=timeout_s)


def create_collective_group(actors: list, world_size: int, ranks: list,
                            backend: str = "gloo",
                            group_name: str = "default") -> None:
    """Declarative init names the member actors, which the port does not
    have yet."""
    raise NotImplementedError(
        "create_collective_group needs the port's actors and head KV (ROADMAP "
        "item 15); every member calls init_collective_group(store=...) "
        "instead")


def get_group(group_name: str = "default") -> DistCollectiveGroup:
    """The live group object, for what the module functions don't expose
    (allreduce_device, allreduce_tree, topology)."""
    with _lock:
        group = _groups.get(group_name)
    if group is None:
        raise RuntimeError(
            f"collective group {group_name!r} is not initialized; call "
            "init_collective_group first")
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
    with _lock:
        group = _groups.pop(group_name, None)
    if group is not None:
        group.destroy()


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
