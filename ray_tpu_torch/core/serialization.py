"""Object serialization: pickle5 with out-of-band buffers.

Equivalent capability to the reference's msgpack+cloudpickle envelope with
pickle5 out-of-band buffers (`python/ray/_private/serialization.py`) — but we
only need the Python path, and torch tensors and numpy arrays are the hot
case:

- protocol-5 `buffer_callback` captures large contiguous buffers (numpy
  arrays, bytes) without copying them into the pickle stream;
- a `torch.Tensor`, on the CPU or on CUDA, is lowered to its bytes on the
  host: one out-of-band buffer plus a dtype tag and the shape. The consumer
  gets a CPU tensor of the same dtype and shape (bf16 stays 2-byte words:
  it has no numpy dtype, so the bytes travel as uint8, never widened). This
  is the counterpart of the JAX package's `jax.Array` lowering; zero-copy
  device handoff is the device object store's job (`device_store`);
- under `device_snapshot=True` (a device object's shm snapshot,
  `device_transport`) a tensor leaf is reduced through `_remat_leaf`
  instead: its bytes out of band (a CUDA leaf's are copied from the card
  straight into the store's range when the frame is written), and in band
  only its shape, dtype and whether it came from CUDA;
- the resulting (meta, buffers) pair maps directly onto a shared-memory
  segment: header + concatenated buffers, so readers reconstruct numpy
  arrays and tensors as zero-copy views onto shm.

Like the JAX package's reducer, which looks up `sys.modules.get("jax")`,
this one looks up `sys.modules.get("torch")` and never imports torch: a
process that never touched torch cannot hold a tensor to serialize.
"""

from __future__ import annotations

import io
import pickle
import sys
from typing import Any, List, Optional


def np_copy_into(dst_view: memoryview, offset: int, data) -> int:
    """memcpy `data` into `dst_view` at `offset`; returns bytes written.

    Plain memoryview slice assignment into an mmap-backed buffer takes
    CPython's byte-wise fallback (~30 MB/s); numpy slice assignment is a
    real memcpy (~25x faster). Every bulk copy into shm must ride this."""
    import numpy as np

    src = np.frombuffer(data, dtype=np.uint8)
    np.frombuffer(dst_view, dtype=np.uint8)[offset:offset + src.nbytes] = src
    return src.nbytes


class SerializedObject:
    """Pickle meta + list of out-of-band buffers (zero-copy where possible)."""

    __slots__ = ("meta", "buffers", "contained", "borrow_tokens")

    def __init__(self, meta: bytes, buffers: List[memoryview],
                 contained: Optional[List] = None,
                 borrow_tokens: Optional[List] = None):
        self.meta = meta
        self.buffers = buffers
        # ObjectIDs of ObjectRefs pickled inside this payload — the
        # reference-counting layer pins them while the container lives
        self.contained = contained or []
        # (ObjectID, token) borrow pins opened while pickling nested refs;
        # a sender whose payload provably never reaches a deserializer
        # (terminally failed call) self-commits these to avoid pin leaks
        self.borrow_tokens = borrow_tokens or []

    @property
    def total_bytes(self) -> int:
        return len(self.meta) + sum(b.nbytes for b in self.buffers)

    def to_bytes(self) -> bytes:
        """Flatten into one contiguous frame: [n_buffers][meta_len][meta]
        [buf_len buf]*  (lengths are 8-byte little-endian)."""
        parts = [len(self.buffers).to_bytes(8, "little"),
                 len(self.meta).to_bytes(8, "little"), self.meta]
        for b in self.buffers:
            parts.append(b.nbytes.to_bytes(8, "little"))
            parts.append(bytes(b) if not isinstance(b, bytes) else b)
        return b"".join(parts)

    def write_into(self, out: memoryview) -> int:
        """Serialize into a preallocated buffer (e.g. a shm segment)."""
        off = 0

        def put(data):
            nonlocal off
            off += np_copy_into(out, off, data)

        put(len(self.buffers).to_bytes(8, "little"))
        put(len(self.meta).to_bytes(8, "little"))
        put(self.meta)
        for b in self.buffers:
            put(b.nbytes.to_bytes(8, "little"))
            if hasattr(b, "write_to"):
                # a device leaf (device_transport.DeviceLeafBuffer): copied
                # from the card straight into `out`, once
                off += b.write_to(out[off:off + b.nbytes])
                continue
            mv = memoryview(b)
            if not mv.contiguous:
                mv = memoryview(bytes(mv))
            put(mv.cast("B"))
        return off

    @property
    def frame_bytes(self) -> int:
        return 16 + len(self.meta) + sum(8 + b.nbytes for b in self.buffers)

    @classmethod
    def from_view(cls, view: memoryview) -> "SerializedObject":
        """Parse a frame, keeping buffers as zero-copy views into `view`."""
        off = 0
        n_buffers = int.from_bytes(view[off:off + 8], "little"); off += 8
        meta_len = int.from_bytes(view[off:off + 8], "little"); off += 8
        meta = bytes(view[off:off + meta_len]); off += meta_len
        buffers = []
        for _ in range(n_buffers):
            blen = int.from_bytes(view[off:off + 8], "little"); off += 8
            buffers.append(view[off:off + blen]); off += blen
        return cls(meta, buffers)


import cloudpickle


def _reduce_tensor(torch, t):
    """(rebuild, args) for a dense tensor: its bytes as one PickleBuffer
    (out of band under protocol 5), the dtype's name and the shape. A
    CUDA tensor is copied to the host here, once."""
    param = (type(t) is torch.nn.Parameter, bool(t.requires_grad))
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    raw = t.contiguous().reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor, (pickle.PickleBuffer(raw), str(t.dtype)[6:],
                              tuple(t.shape), param))


def _rebuild_tensor(buf, dtype: str, shape: tuple, param=(False, False)):
    """Inverse of `_reduce_tensor`: a CPU tensor viewing `buf` (zero-copy
    when the buffer is writable memory, such as a shm segment; a copy when
    the bytes arrived in band)."""
    import torch

    dt = getattr(torch, dtype)
    mv = memoryview(buf).cast("B")
    if mv.nbytes == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        if mv.readonly:
            mv = memoryview(bytearray(mv))
        t = torch.frombuffer(mv, dtype=torch.uint8).view(dt).reshape(shape)
    if param[0]:
        return torch.nn.Parameter(t, requires_grad=param[1])
    return t


class _Pickler(cloudpickle.Pickler):
    """cloudpickle (closures/lambdas ship by value) + a reducer that lowers
    torch tensors (CPU or CUDA) to host bytes (device memory is
    process-local; zero-copy device paths belong to the device object
    store, not byte serialization)."""

    def reducer_override(self, obj):
        from ray_tpu_torch.core.object_ref import ObjectRef, _reconstruct_ref
        from ray_tpu_torch.core import refcount

        if type(obj) is ObjectRef:
            # record nested refs so the refcounting layer can pin them for
            # the container's lifetime (reference: borrowed refs serialized
            # into task args / returned values); the borrow token is kept
            # here too so failed handoffs can be self-released
            self.contained_refs.append(obj.id)
            token = refcount.note_serialized(obj.id)
            if token is not None:
                self.borrow_tokens.append((obj.id, token))
            return (_reconstruct_ref, (obj.id, token))
        torch = sys.modules.get("torch")
        if torch is not None and type(obj) in (torch.Tensor,
                                               torch.nn.Parameter):
            if obj.layout is not torch.strided or obj.is_quantized:
                return super().reducer_override(obj)
            if self.device_snapshot:
                from ray_tpu_torch.core.device_transport import reduce_leaf

                return reduce_leaf(torch, obj, self.deferred)
            return _reduce_tensor(torch, obj)
        return super().reducer_override(obj)

    contained_refs: List = None  # set per instance in serialize()
    borrow_tokens: List = None
    device_snapshot: bool = False
    # id(PickleBuffer) -> (PickleBuffer, DeviceLeafBuffer) for CUDA leaves
    # of a device snapshot, swapped in by the buffer callback
    deferred: dict = None


# top-level bytes/bytearray get a marker meta + out-of-band buffer: pickle5's
# buffer_callback only captures PickleBuffer-aware types, so plain bytes would
# be copied INTO the pickle stream (measured ~1.4 vs 4.2 GB/s through the shm
# store). The marker cannot collide with a pickle stream (those start \x80).
_BYTES_META = b"RTPU:bytes"
_BYTEARRAY_META = b"RTPU:bytearray"


def serialize(value: Any, device_snapshot: bool = False) -> SerializedObject:
    if type(value) is bytes:
        return SerializedObject(_BYTES_META, [memoryview(value)])
    if type(value) is bytearray:
        return SerializedObject(_BYTEARRAY_META, [memoryview(value)])
    buffers: List[memoryview] = []
    deferred: dict = {}

    def callback(pb: pickle.PickleBuffer):
        leaf = deferred.pop(id(pb), None)
        buffers.append(pb.raw() if leaf is None else leaf[1])
        return False  # out-of-band

    sink = io.BytesIO()
    p = _Pickler(sink, protocol=5, buffer_callback=callback)
    p.contained_refs = []
    p.borrow_tokens = []
    p.device_snapshot = device_snapshot
    p.deferred = deferred
    p.dump(value)
    return SerializedObject(sink.getvalue(), buffers,
                            contained=p.contained_refs,
                            borrow_tokens=p.borrow_tokens)


def deserialize(obj: SerializedObject) -> Any:
    if obj.meta == _BYTES_META:
        return bytes(obj.buffers[0])
    if obj.meta == _BYTEARRAY_META:
        return bytearray(obj.buffers[0])
    return pickle.loads(obj.meta, buffers=[pickle.PickleBuffer(b) for b in obj.buffers])


def dumps(value: Any) -> bytes:
    return serialize(value).to_bytes()


def loads(data: bytes) -> Any:
    return deserialize(SerializedObject.from_view(memoryview(data)))


def loads_view(view: memoryview) -> Any:
    """Deserialize from a BORROWED view without retaining it: the result
    owns its memory, so the caller may release/reuse the backing storage
    (a shm ring slot) immediately after. The common meta-only frame (no
    out-of-band buffers — e.g. serve request dicts) costs zero buffer
    copies; frames with out-of-band buffers (numpy) pay exactly one copy
    per buffer — half the memcpy pair of the staging-buffer read path."""
    obj = SerializedObject.from_view(view)
    if obj.meta == _BYTES_META:
        return bytes(obj.buffers[0])
    if obj.meta == _BYTEARRAY_META:
        return bytearray(obj.buffers[0])
    if obj.buffers:
        obj = SerializedObject(
            obj.meta, [memoryview(bytes(b)) for b in obj.buffers])
    return deserialize(obj)
