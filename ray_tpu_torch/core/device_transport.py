"""Device-object data plane: shm-staged snapshots of CUDA tensors.

Counterpart of `ray_tpu/core/device_transport.py`: the cross-process `get()`
of a device object (`put_device`, `tensor_transport="device"`) moves the
tensor bytes through the node's shm store, never through a pickle stream.
Parity target: the reference's accelerator tensor channel
(`python/ray/experimental/channel/torch_tensor_accelerator_channel.py`):
metadata rides the control plane, bulk bytes ride a data plane the consumer
maps.

- **Owner.** `stage_snapshot` serializes the value with
  `device_snapshot=True`. Each tensor leaf becomes an out-of-band buffer
  and, in band, its shape, dtype and whether it came from CUDA. A CUDA
  leaf's buffer is a `DeviceLeafBuffer`: when the store writes the frame
  into the arena's reserved range, the leaf is copied from the card
  STRAIGHT into that range (`copy_` into a `torch.frombuffer` view of the
  arena), one device-to-host copy a leaf, never `.cpu()` then a memcpy.
  `STATS["d2h_copies"]` counts them and `STATS["snapshots_staged"]` the
  snapshots. The snapshot is cached on the owner under `snapshot_oid` and
  freed with the device object, so repeated consumers pay one staging.
- **Consumer.** A same-node consumer maps the shm segment; a cross-node
  one pulls it through the chunked transfer (`object_transfer`, 4 MiB
  chunks). Inside `rematerialize_context` (`load_snapshot`) a leaf that
  came from CUDA lands on the consumer's DEFAULT DEVICE: in a process that
  holds a card, ``cuda:<torch.cuda.current_device()>``, at the cost of one
  host-to-device copy from the mapped view (`STATS["h2d_copies"]`); in a
  process started without a card, the CPU. A leaf that was a CPU tensor
  stays on the CPU.
- **A CPU consumer pays one copy.** The JAX package adopts the mapped shm
  view without a copy (DLPack), which is safe because a `jax.Array` is
  immutable. A CPU `torch.Tensor` is not, and torch has no read-only
  tensor: an alias of the cached snapshot would let one consumer's in-place
  op change what every later consumer reads. So a CPU leaf is cloned out of
  the view (one host copy) and the `device_dlpack` flag is not read here.
- **Between gang members** the leaves ride the gang's own transport
  instead (`IciLeaf`, `client._try_ici_fetch`): NCCL on the card, gloo on
  the CPU, and no snapshot is staged.
"""

from __future__ import annotations

import collections
import hashlib
import threading
import warnings
from typing import Any

from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.store import ObjectMeta

_tls = threading.local()
_stats_lock = threading.Lock()
# per-process counts: snapshots staged by this owner, the device-to-host
# copies they made (one a CUDA leaf), and the host-to-device copies made
# rematerializing leaves on this consumer's card
STATS: collections.Counter = collections.Counter()


def _count(key: str, n: int = 1) -> None:
    with _stats_lock:
        STATS[key] += n


def snapshot_oid(device_oid: ObjectID) -> ObjectID:
    """Deterministic snapshot id: retries/races on the same device object
    stage to the same id, and any node can derive it without the owner."""
    return ObjectID(hashlib.blake2b(
        device_oid.binary() + b":snap", digest_size=16).digest())


class DeviceLeafBuffer:
    """An out-of-band buffer whose bytes are still on the card: `write_to`
    copies them straight into the destination (the store's reserved
    range), once."""

    __slots__ = ("tensor", "nbytes")

    def __init__(self, tensor):
        self.tensor = tensor
        self.nbytes = tensor.numel() * tensor.element_size()

    def _flat_bytes(self):
        import torch

        return self.tensor.reshape(-1).view(torch.uint8)

    def write_to(self, view: memoryview) -> int:
        import torch

        if self.nbytes:
            dst = torch.frombuffer(view, dtype=torch.uint8, count=self.nbytes)
            dst.copy_(self._flat_bytes())
            _count("d2h_copies")
        return self.nbytes

    def __bytes__(self) -> bytes:
        """The bytes on the host (an inline snapshot, below the store's
        shm threshold)."""
        _count("d2h_copies")
        return self._flat_bytes().cpu().numpy().tobytes()


def reduce_leaf(torch, t, deferred: dict):
    """(rebuild, args) for a tensor leaf under `device_snapshot`: its bytes
    as one out-of-band buffer, and in band only its dtype, shape and
    whether it came from CUDA. A CUDA leaf's buffer is deferred (a
    `DeviceLeafBuffer`, looked up by the serializer's buffer callback in
    `deferred`)."""
    import pickle

    t = t.detach()
    if not t.is_contiguous():
        t = t.contiguous()
    dtype, shape = str(t.dtype)[len("torch."):], tuple(t.shape)
    if t.device.type == "cpu":
        raw = t.reshape(-1).view(torch.uint8).numpy()
        return (_remat_leaf, (pickle.PickleBuffer(raw), dtype, shape, False))
    pb = pickle.PickleBuffer(bytearray())
    deferred[id(pb)] = (pb, DeviceLeafBuffer(t))
    return (_remat_leaf, (pb, dtype, shape, True))


def consumer_device():
    """This process's default device for a rematerialized CUDA leaf: its
    current card, or the CPU when it holds none."""
    import torch

    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _remat_leaf(buf, dtype: str, shape: tuple, from_cuda: bool):
    """Unpickle hook for a staged tensor leaf. Outside a
    `rematerialize_context` (a plain host read) it is a CPU tensor viewing
    the buffer. Inside, a leaf that came from CUDA lands on the consumer's
    default device (one host-to-device copy from the mapped view, or one
    host copy without a card) and a CPU leaf is copied out of the view:
    never an alias of the shared snapshot (module docstring)."""
    import numpy as np
    import torch

    raw = np.frombuffer(buf, dtype=np.uint8)
    with warnings.catch_warnings():
        # a mapped snapshot may be read-only; the view is never written
        warnings.simplefilter("ignore", UserWarning)
        host = (torch.from_numpy(raw).view(getattr(torch, dtype))
                .reshape(shape) if raw.size else
                torch.empty(shape, dtype=getattr(torch, dtype)))
    if not getattr(_tls, "remat", False):
        return host
    dev = consumer_device() if from_cuda else torch.device("cpu")
    if dev.type == "cuda":
        _count("h2d_copies")
        return host.to(dev)
    return host.clone()


class IciLeaf:
    """Placeholder for a tensor leaf in a device-object skeleton shipped
    over the control plane while the tensor itself rides the gang's
    transport: NCCL send/recv between cards, gloo on the CPU (the JAX
    package's pair-mesh ppermute over ICI)."""

    __slots__ = ("index",)

    def __init__(self, index: int):
        self.index = index

    def __reduce__(self):
        return (IciLeaf, (self.index,))


class rematerialize_context:
    def __enter__(self):
        _tls.remat = True
        return self

    def __exit__(self, *exc):
        _tls.remat = False
        return False


def stage_snapshot(client, device_oid: ObjectID, value: Any) -> ObjectMeta:
    """Owner-side: write a host snapshot of `value` into the node shm
    store (one device-to-host copy a CUDA leaf, straight into the store's
    range; no pickle of tensor bytes). Runs in an executor thread, never
    on the owner's event loop."""
    from ray_tpu_torch.core import serialization

    ser = serialization.serialize(value, device_snapshot=True)
    oid = snapshot_oid(device_oid)
    meta = client.store.put_serialized(oid, ser)
    meta.node_id = client.node_id
    meta.owner = client.worker_id
    _count("snapshots_staged")
    return meta


def load_snapshot(value_bytes) -> Any:
    """Consumer-side: deserialize a pulled/mapped snapshot, placing CUDA
    leaves on this process's default device."""
    from ray_tpu_torch.core import serialization

    with rematerialize_context():
        return serialization.deserialize(value_bytes)
