"""Node-local shared-memory object store with spill-to-disk.

Capability-equivalent of the reference's plasma store + external storage
(`src/ray/object_manager/plasma/`, `python/ray/_private/external_storage.py`):
immutable sealed objects in node-shared memory, zero-copy reads from any
process on the node, LRU spill to disk under memory pressure.

Two backends:
- **native arena** (default when the C++ toolchain is present): one mmap'd
  shm segment per node managed by `ray_tpu_torch/csrc/arena_store.cc` — embedded
  allocator, object table, LRU, refcount pinning (the plasma equivalent).
  The node's head daemon creates it and drives watermark spilling; every
  other process attaches by name.
- **per-object segments** (fallback, and overflow path when the arena is
  full): Python `multiprocessing.shared_memory`, one segment per object.

Small objects stay inline and never touch shm (the reference's in-process
memory store fast path).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import OrderedDict
from multiprocessing import shared_memory
from typing import Dict, Optional

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.serialization import SerializedObject
from ray_tpu_torch.utils import fs as _fs

_fsopen = _fs.open  # spill files may live on fsspec storage (URIs)

from ray_tpu_torch.utils.platform import STATE_DIR

INLINE_THRESHOLD = 100 * 1024  # small objects ride the control plane inline

# Every shm segment this package creates starts with this prefix. It is its
# own (the JAX package's is "rtpu_"), so neither package's cleanup glob can
# match the other's segments when both run clusters on one host.
SHM_PREFIX = "rtpt_"


def default_store_bytes() -> int:
    """Reference-parity sizing (`python/ray/_private/node.py:1409`
    determine_plasma_store_config): 30% of system memory, capped by what
    /dev/shm can actually hold. The old fixed 2 GiB default forced big
    put workloads through watermark spilling and fresh page-faulting
    overflow segments — the measured multi-client put regression."""
    try:
        ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    except (ValueError, OSError):
        ram = 8 << 30
    try:
        st = os.statvfs("/dev/shm")
        shm_free = st.f_bavail * st.f_frsize
    except OSError:
        shm_free = ram // 2
    return max(512 << 20, min(int(ram * 0.30), int(shm_free * 0.80)))
ARENA_HIGH_WATERMARK = 0.85    # head starts spilling above this fill ratio
ARENA_LOW_WATERMARK = 0.75     # ...down to this


@dataclasses.dataclass
class ObjectMeta:
    object_id: ObjectID
    size: int
    kind: str                      # "inline" | "shm" | "arena" | "spilled"
    segment: Optional[str] = None  # shm segment name (or arena name)
    inline: Optional[bytes] = None # inline payload (kind == "inline")
    spill_path: Optional[str] = None
    node_id: Optional[object] = None
    owner: Optional[object] = None  # WorkerID of owner
    error: bool = False             # payload is a serialized exception
    contained: Optional[list] = None  # ObjectIDs of refs nested inside


class PendingObject:
    """An allocated-but-unsealed local object being filled by a remote pull
    (plasma Create/Seal semantics, `src/ray/object_manager/plasma/store.h`)."""

    def __init__(self, store: "SharedMemoryStore", obj_id: ObjectID, size: int,
                 buf: Optional[bytearray] = None, shm=None,
                 segment: Optional[str] = None):
        self.store = store
        self.object_id = obj_id
        self.size = size
        self._buf = buf
        self._shm = shm
        self._segment = segment
        self.view = (memoryview(buf) if buf is not None
                     else memoryview(shm.buf)[:size])

    def write(self, offset: int, data) -> None:
        from ray_tpu_torch.core.serialization import np_copy_into

        np_copy_into(self.view, offset, data)

    def seal(self) -> ObjectMeta:
        self.view.release()
        if self._buf is not None:
            return ObjectMeta(self.object_id, self.size, "inline",
                              inline=bytes(self._buf))
        meta = ObjectMeta(self.object_id, self.size, "shm",
                          segment=self._segment)
        self.store._meta_by_segment[self._segment] = meta
        return meta

    def abort(self) -> None:
        self.view.release()
        if self._shm is None:
            return
        with self.store._lock:
            self.store._segments.pop(self._segment, None)
            self.store.used -= self.size
        try:
            self._shm.close()
            _unlink(self._shm)
        except (FileNotFoundError, BufferError):
            pass


def _unregister_tracker(shm: shared_memory.SharedMemory) -> None:
    """We manage segment lifetime explicitly; stop resource_tracker from
    unlinking segments when an attaching process exits."""
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")  # type: ignore[attr-defined]
    except Exception:
        pass


def _unlink(shm: shared_memory.SharedMemory) -> None:
    """`shm.unlink()` without its resource-tracker unregister: every segment
    here was unregistered when made or attached (`_unregister_tracker`),
    and a second unregister makes the tracker process print a KeyError."""
    import _posixshmem

    _posixshmem.shm_unlink(shm._name)  # type: ignore[attr-defined]


class SharedMemoryStore:
    """Per-node store. The node's daemon owns creation/eviction; other
    processes attach read-only by segment name."""

    def __init__(self, session: str, capacity_bytes: int = 2 << 30,
                 spill_dir: Optional[str] = None, create_arena: bool = False,
                 namespace: Optional[str] = None):
        self.session = session
        self.capacity = capacity_bytes
        self.used = 0
        # Store namespace: scopes segment/arena names to one logical node.
        # With RAY_TPU_STORE_ISOLATION set, stores REFUSE to read objects
        # from other namespaces even though shm is machine-global — the
        # forced-remote-fetch test mode that makes single-machine clusters
        # behave like real multi-host slices (object data must then travel
        # through the node data servers, reference object_manager.cc).
        self.namespace = (namespace if namespace is not None
                          else _config.get("store_namespace"))
        self.isolated = _config.get("store_isolation")
        # RAY_TPU_SPILL_DIR may be an fsspec URI (s3://..., memory://) —
        # remote spill storage, reference external_storage.py:398
        # ExternalStorageSmartOpenImpl
        self.spill_dir = (spill_dir
                          or _config.get("spill_dir")
                          or os.path.join(
                              STATE_DIR, session,
                              f"spill_{self.namespace}" if self.namespace
                              else "spill"))
        # a config-provided dir (RAY_TPU_SPILL_DIR) is typically SHARED
        # across every node of the cluster (and may hold user data):
        # shutdown must never sweep it — only dirs this store derived (or
        # was handed) for itself are its to destroy
        self._sweepable_spill = bool(spill_dir) or not _config.get("spill_dir")
        self._segments: "OrderedDict[str, shared_memory.SharedMemory]" = OrderedDict()
        self._meta_by_segment: Dict[str, ObjectMeta] = {}
        self._pinned: Dict[str, int] = {}
        self._lock = threading.Lock()
        # invoked with the retargeted meta after a spill — lets a node
        # daemon tell the head to update the canonical directory entry
        self.on_spill = None
        # native arena backend (plasma equivalent); the head creates, others
        # lazily attach. None until first use; False = unavailable.
        self.owns_arena = create_arena
        self._arena = None
        self._arena_metas: Dict[bytes, ObjectMeta] = {}  # head-side, for spill
        if create_arena and not _config.get("disable_native_store"):
            from ray_tpu_torch.core import native_store

            try:
                self._arena = native_store.Arena.create(
                    self._arena_name(), capacity_bytes)
            except Exception:
                self._arena = False

    @property
    def _seg_prefix(self) -> str:
        # derived at each use: a driver that joins a cluster learns its
        # session after its store is made, and the segments it creates
        # must carry it, or the session's cleanup glob misses them
        tag = f"{self.namespace}_" if self.namespace else ""
        return f"{SHM_PREFIX}{tag}{self.session[:8]}_"

    def _arena_name(self) -> str:
        tag = f"{self.namespace}_" if self.namespace else ""
        return f"{SHM_PREFIX}arena_{tag}{self.session[:16]}"

    def readable(self, meta: ObjectMeta) -> bool:
        """Whether this store may read the object locally. Always true
        outside isolation mode (shm is machine-global); under isolation,
        only objects in our own namespace are local."""
        if not self.isolated or meta.kind == "inline":
            return True
        if meta.kind == "shm":
            return bool(meta.segment) and meta.segment.startswith(self._seg_prefix)
        if meta.kind == "arena":
            return meta.segment == self._arena_name()
        if meta.kind == "spilled":
            return bool(meta.spill_path) and meta.spill_path.startswith(self.spill_dir)
        return True

    def _get_arena(self):
        if self._arena is not None:
            return self._arena or None
        if _config.get("disable_native_store"):
            self._arena = False
            return None
        from ray_tpu_torch.core import native_store

        try:
            self._arena = native_store.Arena.attach(self._arena_name())
        except Exception:
            self._arena = False  # no arena for this session; use segments
        return self._arena or None

    # -- creation ----------------------------------------------------------
    def put_serialized(self, obj_id: ObjectID, ser: SerializedObject) -> ObjectMeta:
        size = ser.frame_bytes
        if size <= INLINE_THRESHOLD:
            return ObjectMeta(obj_id, size, "inline", inline=ser.to_bytes())
        meta = self._try_put_arena(obj_id, ser, size)
        if meta is not None:
            return meta
        # random suffix: a retried task must not collide with a segment left
        # behind by a dead attempt for the same return object id
        name = f"{self._seg_prefix}{obj_id.hex()[:12]}_{os.urandom(3).hex()}"
        with self._lock:
            self._ensure_capacity(size)
            shm = shared_memory.SharedMemory(create=True, size=size, name=name)
            _unregister_tracker(shm)
            self._segments[name] = shm
            self.used += size
        ser.write_into(memoryview(shm.buf))
        meta = ObjectMeta(obj_id, size, "shm", segment=name)
        self._meta_by_segment[name] = meta
        return meta

    def _try_put_arena(self, obj_id: ObjectID, ser: SerializedObject,
                       size: int) -> Optional[ObjectMeta]:
        arena = self._get_arena()
        if arena is None:
            return None
        from ray_tpu_torch.core.native_store import ArenaError, ObjectExistsError

        oid = obj_id.binary()
        try:
            try:
                buf = arena.create_buffer(oid, size)
            except ObjectExistsError:
                if arena.contains(oid):
                    # a racing duplicate execution (retry/reconstruction)
                    # already sealed this object — puts are idempotent by
                    # object id; NEVER delete the winner's data
                    return ObjectMeta(obj_id, size, "arena",
                                      segment=arena.name)
                # a dead attempt left an unsealed entry; reclaim it
                arena.delete(oid, force=True)
                buf = arena.create_buffer(oid, size)
            ser.write_into(buf)
            buf.release()
            arena.seal(oid)
        except ArenaError:
            # full (or unhealthy): overflow to a per-object segment; the head
            # spills arena objects at the watermark to make future room
            return None
        if self.owns_arena:
            self._maybe_spill_arena()
        return ObjectMeta(obj_id, size, "arena", segment=arena.name)

    def adopt(self, meta: ObjectMeta) -> bool:
        """Track an object created by another process on this node
        (accounting, LRU ordering, spill eligibility). Returns False when
        this store cannot see the object — the caller then forwards
        adoption to the node that can (isolation / real multi-host)."""
        if not self.readable(meta):
            return False  # another node's object: not ours to track
        if meta.kind == "arena":
            if self.owns_arena:
                self._arena_metas[meta.object_id.binary()] = meta
                self._maybe_spill_arena()
            return True
        if meta.kind != "shm" or meta.segment is None:
            return True
        with self._lock:
            if meta.segment in self._segments:
                self._meta_by_segment[meta.segment] = meta
                return True
            self._ensure_capacity(meta.size)
            try:
                shm = shared_memory.SharedMemory(name=meta.segment)
            except FileNotFoundError:
                return False
            _unregister_tracker(shm)
            self._segments[meta.segment] = shm
            self._meta_by_segment[meta.segment] = meta
            self.used += meta.size
        return True

    # -- reads -------------------------------------------------------------
    def get_serialized(self, meta: ObjectMeta) -> SerializedObject:
        if meta.kind == "inline":
            return SerializedObject.from_view(memoryview(meta.inline))
        if not self.readable(meta):
            # foreign namespace: surfaced identically to a missing segment
            # so callers fall into the remote-pull path
            raise FileNotFoundError(meta.segment or meta.spill_path)
        if meta.kind == "spilled":
            with _fsopen(meta.spill_path, "rb") as f:
                return SerializedObject.from_view(memoryview(f.read()))
        if meta.kind == "arena":
            arena = self._get_arena()
            if arena is None:
                raise FileNotFoundError(meta.segment)
            try:
                # pins the object (plasma semantics: zero-copy views stay
                # valid until release/free); raises KeyError when the head
                # evicted/spilled it — surfaced as FileNotFoundError so the
                # caller refreshes the meta and reads the spill file
                view = arena.get(meta.object_id.binary(), pin=True)
            except KeyError:
                raise FileNotFoundError(meta.segment) from None
            return SerializedObject.from_view(view)
        with self._lock:
            shm = self._segments.get(meta.segment)
            if shm is not None:
                self._segments.move_to_end(meta.segment)  # LRU touch
        if shm is None:
            shm = shared_memory.SharedMemory(name=meta.segment)
            _unregister_tracker(shm)
            with self._lock:
                self._segments.setdefault(meta.segment, shm)  # cache attachment
        # NOTE: the returned buffers alias shm memory; callers must copy or
        # finish deserializing before the object is freed.
        return SerializedObject.from_view(memoryview(shm.buf))

    def get_raw(self, meta: ObjectMeta, offset: int = 0,
                length: Optional[int] = None):
        """Raw frame bytes [offset, offset+length) of a local object, for
        the node data server's chunked reads.

        Returns (memoryview of the window, release_cb|None). The caller
        must invoke release_cb (if set) when done — arena reads pin the
        object against eviction while the view is alive."""
        end = meta.size if length is None else min(offset + length, meta.size)
        if meta.kind == "inline":
            return memoryview(meta.inline)[offset:end], None
        if not self.readable(meta):
            raise FileNotFoundError(meta.segment or meta.spill_path)
        if meta.kind == "spilled":
            # window read — a whole-file read per 4 MiB chunk would make
            # pulls of spilled objects O(size^2) in disk I/O
            with _fsopen(meta.spill_path, "rb") as f:
                f.seek(offset)
                return memoryview(f.read(end - offset)), None
        if meta.kind == "arena":
            arena = self._get_arena()
            if arena is None:
                raise FileNotFoundError(meta.segment)
            oid = meta.object_id.binary()
            try:
                view = arena.get(oid, pin=True)
            except KeyError:
                raise FileNotFoundError(meta.segment) from None
            return memoryview(view)[offset:end], lambda: arena.release(oid)
        with self._lock:
            shm = self._segments.get(meta.segment)
        if shm is None:
            shm = shared_memory.SharedMemory(name=meta.segment)
            _unregister_tracker(shm)
            with self._lock:
                self._segments.setdefault(meta.segment, shm)
        return memoryview(shm.buf)[offset:end], None

    def allocate_raw(self, obj_id: ObjectID, size: int) -> "PendingObject":
        """Writable destination for an incoming remote object (pull target).

        Deliberately bypasses the arena: pulled copies are process-managed
        caches the puller must be able to unlink itself, and foreign-created
        arena entries would be invisible to the arena owner's spill
        accounting."""
        if size <= INLINE_THRESHOLD:
            return PendingObject(self, obj_id, size, buf=bytearray(size))
        name = f"{self._seg_prefix}{obj_id.hex()[:12]}_p{os.urandom(3).hex()}"
        with self._lock:
            self._ensure_capacity(size)
            shm = shared_memory.SharedMemory(create=True, size=size, name=name)
            _unregister_tracker(shm)
            self._segments[name] = shm
            self.used += size
        return PendingObject(self, obj_id, size, shm=shm, segment=name)

    # -- lifetime ----------------------------------------------------------
    def pin(self, meta: ObjectMeta) -> None:
        with self._lock:
            if meta.segment:
                self._pinned[meta.segment] = self._pinned.get(meta.segment, 0) + 1

    def unpin(self, meta: ObjectMeta) -> None:
        with self._lock:
            if meta.segment and meta.segment in self._pinned:
                self._pinned[meta.segment] -= 1
                if self._pinned[meta.segment] <= 0:
                    del self._pinned[meta.segment]

    def release(self, meta: ObjectMeta) -> None:
        """Drop this process's mapping/pin without destroying the object
        (freeing is the owner node's job)."""
        if meta.kind == "arena":
            arena = self._get_arena()
            if arena is not None:
                arena.release(meta.object_id.binary())
            return
        if meta.kind != "shm" or not meta.segment:
            return
        with self._lock:
            shm = self._segments.pop(meta.segment, None)
            self._meta_by_segment.pop(meta.segment, None)
        if shm is not None:
            try:
                shm.close()
            except BufferError:
                pass  # live memoryviews still reference it; mapping stays

    def release(self, meta: ObjectMeta) -> None:
        """Drop this process's pin of an arena object it read through
        `get_serialized` and no longer views (a no-op for other kinds)."""
        if meta.kind == "arena":
            arena = self._get_arena()
            if arena is not None:
                arena.release(meta.object_id.binary())

    def delete_unregistered(self, meta: ObjectMeta) -> None:
        """Free an object this process sealed without registering it with
        the head (a device object's snapshot): no daemon tracks it, so an
        arena entry is deleted here, pins and all."""
        if meta.kind == "arena":
            arena = self._get_arena()
            if arena is not None:
                arena.release(meta.object_id.binary())
                arena.delete(meta.object_id.binary(), force=True)
            return
        self.free(meta)

    def free(self, meta: ObjectMeta) -> None:
        if meta.kind == "arena":
            arena = self._get_arena()
            if arena is None:
                return
            arena.release(meta.object_id.binary())
            if self.owns_arena:
                self._arena_metas.pop(meta.object_id.binary(), None)
                arena.delete(meta.object_id.binary(), force=True)
            return
        if meta.kind == "shm" and meta.segment:
            with self._lock:
                shm = self._segments.pop(meta.segment, None)
                self._meta_by_segment.pop(meta.segment, None)
                if shm is not None:
                    self.used -= meta.size
            if shm is None:
                try:
                    shm = shared_memory.SharedMemory(name=meta.segment)
                except FileNotFoundError:
                    return
                _unregister_tracker(shm)
            shm.close()
            try:
                _unlink(shm)
            except FileNotFoundError:
                pass
        elif meta.kind == "spilled" and meta.spill_path:
            try:
                _fs.rm(meta.spill_path)
            except OSError:
                pass

    # -- spilling ----------------------------------------------------------
    def _maybe_spill_arena(self) -> None:
        """Head-side watermark spilling (plasma eviction + external storage):
        above the high watermark, move LRU unpinned arena objects to disk and
        retarget their metas; readers with stale metas refresh via the head."""
        arena = self._get_arena()
        if arena is None or not self.owns_arena:
            return
        used, cap, _ = arena.stats()
        if used <= ARENA_HIGH_WATERMARK * cap:
            return
        needed = used - int(ARENA_LOW_WATERMARK * cap)
        _fs.makedirs(self.spill_dir)
        for oid in arena.evict_candidates(needed):
            meta = self._arena_metas.pop(oid, None)
            if meta is None:
                continue  # not yet adopted (registration in flight): skip
            try:
                view = arena.get(oid, pin=False)
            except KeyError:
                continue
            path = _fs.join(self.spill_dir, oid.hex())
            with _fsopen(path, "wb") as f:
                f.write(view)
            del view
            if not arena.delete(oid, force=False):
                # pinned between candidate selection and delete: keep it
                try:
                    _fs.rm(path)
                except OSError:
                    pass
                self._arena_metas[oid] = meta
                continue
            meta.kind = "spilled"
            meta.spill_path = path
            # segment name retained: readers go by kind/spill_path, and the
            # head uses it to tell a stale pre-spill re-registration (same
            # segment) from a retry's distinct duplicate copy (fresh name)
            if self.on_spill is not None:
                self.on_spill(meta)

    def _ensure_capacity(self, incoming: int) -> None:
        """Spill LRU unpinned segments until `incoming` fits. Lock held."""
        if self.used + incoming <= self.capacity:
            return
        _fs.makedirs(self.spill_dir)
        for name in list(self._segments):
            if self.used + incoming <= self.capacity:
                break
            if name in self._pinned:
                continue
            shm = self._segments.pop(name)
            meta = self._meta_by_segment.pop(name, None)
            path = _fs.join(self.spill_dir, name)
            with _fsopen(path, "wb") as f:
                f.write(shm.buf)
            self.used -= (meta.size if meta else shm.size)
            try:
                shm.close()
            except BufferError:
                pass  # exported views keep the mapping alive; data persists
            try:
                # independent of close(): a BufferError above must not leak
                # the /dev/shm file for the machine's lifetime
                _unlink(shm)
            except FileNotFoundError:
                pass
            if meta is not None:
                # readers that already attached keep a valid mapping; new
                # readers see the updated meta and read the spill file
                meta.kind = "spilled"
                meta.spill_path = path
                meta.segment = None
                if self.on_spill is not None:
                    self.on_spill(meta)

    def shutdown(self, sweep_spill: bool = True) -> None:
        with self._lock:
            for shm in self._segments.values():
                shm.close()
                try:
                    _unlink(shm)
                except FileNotFoundError:
                    pass
            self._segments.clear()
            self.used = 0
        if self._arena:
            try:
                self._arena.close(unlink=self.owns_arena)
            except Exception:
                pass
            self._arena = False
        if sweep_spill and self._sweepable_spill \
                and (self.owns_arena or self.namespace):
            # spill files are session-scoped storage this node owns: a
            # shut-down node must not leak them on disk forever. Callers
            # rebuilding a store mid-session (head snapshot restore) pass
            # sweep_spill=False — those files are the data being
            # restored. Only the node-owning store sweeps (the head's, or
            # a namespaced per-node store): without a namespace the dir
            # is SHARED across the session's processes, and a single
            # daemon's teardown must not delete its neighbors' files.
            try:
                _fs.rmtree(self.spill_dir)
            except OSError:
                pass
