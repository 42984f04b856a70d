"""Per-process device object store: zero-copy `torch.Tensor` handoff.

Counterpart of `ray_tpu/core/device_store.py` (capability parity with the
reference's RDT / GPU object store,
`python/ray/experimental/gpu_object_manager/gpu_object_manager.py:22-56`):
device-resident values (CUDA tensors, or nested dicts, lists and tuples
holding them) stay in the producing process, and only a small meta
(kind="device") travels through the control plane. A same-process `get()`
returns the LIVING value with no copy (the same tensor, the same
`data_ptr`); a cross-process `get()` asks the owner for a snapshot
(`device_transport`) or, between members of one collective gang, receives
the tensors over the gang's own transport (NCCL on the card).

Why per-process: a CUDA allocation belongs to the process that made it.
Sharing one between processes would take CUDA IPC, which the JAX package
has no counterpart of (it stages through shm); the design is owner-resident
values plus on-demand transfer.

Lifetime rides the distributed refcounting layer: the head's directory
entry for a device object pins it; when the head drops the object it tells
the owner to release the value.

Like `serialization`, this module never imports torch: it looks torch up
in `sys.modules` (a process that never touched torch holds no tensor).
"""

from __future__ import annotations

import sys
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.core.ids import ObjectID


def tree_leaves(value: Any) -> list:
    """The leaves of nested dicts, lists and tuples (torch's pytree order;
    `value` itself when torch is not loaded or it is not a container)."""
    torch = sys.modules.get("torch")
    if torch is None:
        if isinstance(value, dict):
            return [x for v in value.values() for x in tree_leaves(v)]
        if isinstance(value, (list, tuple)):
            return [x for v in value for x in tree_leaves(v)]
        return [value]
    from torch.utils import _pytree

    return _pytree.tree_leaves(value)


def _nbytes_estimate(value: Any) -> int:
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    import numpy as np

    if isinstance(value, np.ndarray):
        return value.nbytes
    leaves = tree_leaves(value)
    return sum(_nbytes_estimate(leaf) for leaf in leaves
               if leaf is not value)


def is_device_value(value: Any) -> bool:
    """A `torch.Tensor` (the JAX package asks for a `jax.Array`)."""
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(value, torch.Tensor)


class DeviceObjectStore:
    """Values held alive by the owning process, keyed by ObjectID."""

    def __init__(self):
        self._objects: Dict[ObjectID, Any] = {}
        self._lock = threading.Lock()

    def put(self, oid: ObjectID, value: Any) -> int:
        with self._lock:
            self._objects[oid] = value
        return _nbytes_estimate(value)

    def get(self, oid: ObjectID) -> Any:
        with self._lock:
            return self._objects[oid]

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._objects

    def pop(self, oid: ObjectID) -> Optional[Any]:
        with self._lock:
            return self._objects.pop(oid, None)

    def __len__(self) -> int:
        with self._lock:
            return len(self._objects)
