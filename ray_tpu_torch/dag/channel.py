"""Python wrapper over the native mutable shm channel (csrc/channel.cc).

Single-writer / N-reader handoff over an N-slot ring; values are
serialized with the core serializer. This is the data plane of compiled
DAGs (reference: `python/ray/experimental/channel/shared_memory_channel.py`).
Counterpart of `ray_tpu/dag/channel.py`; its segments are named
``rtpt_chan_*`` (the JAX package's ``rtpu_chan_*``).

``num_slots=1`` is the classic single-slot mutable object (writer blocks
until every reader consumed the previous value). ``num_slots=k`` turns the
slot into a ring: the writer runs up to k values ahead of the slowest
reader cursor before blocking, which is what lets a compiled DAG keep
`max_inflight` iterations pipelined across stages.

A torch tensor travels with its bytes out of band (`serialization`), in
the same slot as its meta. `read` returns a tensor that owns its memory;
`read_zc` returns one that ALIASES the slot and is writable, valid only
until its `SlotView` is released.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.native_store import _build_and_load


# every ring segment of the port starts with this (its store segments with
# "rtpt_" too, `store.SHM_PREFIX`)
CHANNEL_PREFIX = "rtpt_chan_"


class ChannelError(Exception):
    pass


class ChannelClosedError(ChannelError):
    pass


def _lib():
    lib = _build_and_load()
    if lib is None:
        raise ChannelError(
            "native channel library unavailable (csrc/channel.cc did not "
            "build: no C++ compiler?)")
    if not hasattr(lib.rtpu_chan_create, "_configured"):
        lib.rtpu_chan_create.restype = ctypes.c_void_p
        lib.rtpu_chan_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                         ctypes.c_uint32, ctypes.c_uint32]
        lib.rtpu_chan_attach.restype = ctypes.c_void_p
        lib.rtpu_chan_attach.argtypes = [ctypes.c_char_p]
        lib.rtpu_chan_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.rtpu_chan_shutdown.argtypes = [ctypes.c_void_p]
        lib.rtpu_chan_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_uint64, ctypes.c_int64]
        lib.rtpu_chan_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int64]
        lib.rtpu_chan_reserve.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_void_p)]
        lib.rtpu_chan_commit.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_chan_read_view.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_int64]
        lib.rtpu_chan_ack.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.rtpu_chan_capacity.restype = ctypes.c_uint64
        lib.rtpu_chan_capacity.argtypes = [ctypes.c_void_p]
        lib.rtpu_chan_num_readers.restype = ctypes.c_uint32
        lib.rtpu_chan_num_readers.argtypes = [ctypes.c_void_p]
        lib.rtpu_chan_num_slots.restype = ctypes.c_uint32
        lib.rtpu_chan_num_slots.argtypes = [ctypes.c_void_p]
        lib.rtpu_chan_stats.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_uint64)]
        lib.rtpu_chan_create._configured = True
    return lib


# ------------------------------------------------------------------ metrics
# dag_channel_wait_seconds: time spent BLOCKED on channel handoffs (writer
# waiting for a free ring slot / reader waiting for the next value) — the
# compiled hot path's analogue of rpc_latency_seconds. Paired with
# dag_channel_ops_total so wait-RATIO math has an unbiased denominator:
# the histogram's _count alone undercounts because read_raw (the remote-
# reader serving path) historically skipped it, and any wait-ratio
# computed against a biased op count overstates stall share. Lazily
# created so plain channel users outside a runtime never touch the
# metrics registry.
_wait_hist = None
_ops_counter = None
_wait_enabled = None


def _observe_wait(op: str, dt: float) -> None:
    global _wait_hist, _ops_counter, _wait_enabled
    if _wait_enabled is None:
        try:
            from ray_tpu_torch.core import config as _config

            _wait_enabled = bool(_config.get("rpc_metrics"))
        except Exception:
            _wait_enabled = False
    if not _wait_enabled:
        return
    if _wait_hist is None:
        try:
            from ray_tpu_torch.util import metrics

            _wait_hist = metrics.Histogram(
                "dag_channel_wait_seconds",
                "Time blocked on compiled-DAG channel handoffs",
                boundaries=[1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01,
                            0.05, 0.1, 0.5, 1.0, 5.0],
                tag_keys=("op",))
            _ops_counter = metrics.Counter(
                "dag_channel_ops_total",
                "Completed channel ops (every op, including the zero-wait "
                "fast path) — the denominator for wait-ratio math over "
                "dag_channel_wait_seconds",
                tag_keys=("op",))
        except Exception:
            _wait_enabled = False
            return
    _wait_hist.observe(dt, tags={"op": op})
    _ops_counter.inc(1.0, tags={"op": op})


class Channel:
    """A named ring channel. Writers block when the ring is full across
    all reader cursors; readers block until their next value arrives."""

    def __init__(self, name: Optional[str] = None, capacity: int = 4 << 20,
                 num_readers: int = 1, num_slots: int = 1,
                 _create: bool = True):
        self.name = name or f"{CHANNEL_PREFIX}{os.urandom(6).hex()}"
        self.capacity = capacity
        self.num_readers = num_readers
        self.num_slots = max(1, int(num_slots))
        self._last_seq = 0
        self._oplock = threading.Lock()
        self._close_lock = threading.Lock()
        lib = _lib()
        if _create:
            self._h = lib.rtpu_chan_create(self.name.encode(), capacity,
                                           num_readers, self.num_slots)
            self._owner = True
        else:
            self._h = lib.rtpu_chan_attach(self.name.encode())
            self._owner = False
        if not self._h:
            raise ChannelError(f"cannot open channel {self.name}")
        self._lib_ref = lib

    @classmethod
    def attach(cls, name: str) -> "Channel":
        ch = cls.__new__(cls)
        ch.name = name
        ch._last_seq = 0
        ch._oplock = threading.Lock()
        ch._close_lock = threading.Lock()
        lib = _lib()
        ch._h = lib.rtpu_chan_attach(name.encode())
        if not ch._h:
            raise ChannelError(f"cannot attach channel {name}")
        ch._owner = False
        ch._lib_ref = lib
        # the shm header is the source of truth: an attached handle keeps
        # the creator's reader count and ring depth, so re-serializing it
        # (__reduce__ -> attach) loses nothing and capacity checks stay
        # honest
        ch.capacity = lib.rtpu_chan_capacity(ch._h)
        ch.num_readers = lib.rtpu_chan_num_readers(ch._h)
        ch.num_slots = lib.rtpu_chan_num_slots(ch._h)
        return ch

    @staticmethod
    def _wrap(ptr: int, n: int) -> memoryview:
        # writable view over n bytes of the mapped slot (no copy)
        return memoryview((ctypes.c_char * n).from_address(ptr)).cast("B")

    def write(self, value: Any, timeout: Optional[float] = None) -> None:
        # zero-copy path: reserve the next ring slot and serialize INTO it
        # (SerializedObject.write_into), instead of flattening to a bytes
        # staging buffer and memcpy'ing that into the slot — one copy per
        # hop instead of two
        sobj = serialization.serialize(value)
        n = sobj.frame_bytes
        if n > self.capacity:
            raise ChannelError(
                f"value of {n} bytes exceeds channel capacity "
                f"{self.capacity}")
        ptr = ctypes.c_void_p()
        t0 = time.perf_counter()
        # _oplock serializes native ops on THIS handle so close() can
        # never munmap the segment under a thread still inside the
        # native call; shutdown() (lock-free) wakes a blocked op first
        with self._oplock:
            if not self._h:
                raise ChannelClosedError(self.name)
            rc = self._lib_ref.rtpu_chan_reserve(
                self._h, n,
                -1 if timeout is None else int(timeout * 1000),
                ctypes.byref(ptr))
            if rc == 0:
                # single-writer contract: the reserved slot is invisible
                # to readers until commit publishes the seq bump, so
                # serializing in place here cannot race a reader
                sobj.write_into(self._wrap(ptr.value, n))
                rc = self._lib_ref.rtpu_chan_commit(self._h, n)
        _observe_wait("write", time.perf_counter() - t0)
        if rc == -2:
            raise ChannelClosedError(self.name)
        if rc == -3:
            raise TimeoutError(f"write to {self.name} timed out")
        if rc == -4:
            raise ChannelError(
                f"value of {n} bytes exceeds channel capacity "
                f"{self.capacity}")
        if rc != 0:
            raise ChannelError(f"write failed rc={rc}")

    def _read_view(self, last_seq: int, timeout: Optional[float], op: str):
        """Shared view-read core: block for the value after `last_seq`,
        return (seq, len, ptr) WITHOUT copying or acking. Caller must ack
        via rtpu_chan_ack once done with the slot bytes."""
        seq = ctypes.c_uint64()
        ln = ctypes.c_uint64()
        ptr = ctypes.c_void_p()
        t0 = time.perf_counter()
        with self._oplock:
            if not self._h:
                raise ChannelClosedError(self.name)
            rc = self._lib_ref.rtpu_chan_read_view(
                self._h, last_seq, ctypes.byref(seq), ctypes.byref(ln),
                ctypes.byref(ptr),
                -1 if timeout is None else int(timeout * 1000))
        _observe_wait(op, time.perf_counter() - t0)
        if rc == -2:
            raise ChannelClosedError(self.name)
        if rc == -3:
            raise TimeoutError(f"read from {self.name} timed out")
        if rc != 0:
            raise ChannelError(f"read failed rc={rc}")
        return seq.value, ln.value, ptr.value

    def _ack(self, seq: int) -> None:
        # quick non-blocking native call; _close_lock (never held across a
        # blocking op) keeps close() from munmapping under it
        with self._close_lock:
            if self._h:
                self._lib_ref.rtpu_chan_ack(self._h, seq)

    def read(self, timeout: Optional[float] = None) -> Any:
        """Consume the next value. Zero-copy slot path: deserialize
        straight from a view over the ring slot, then ack — no staging
        buffer memcpy, no string_at copy. Meta-only frames (dicts etc.)
        deserialize with zero buffer copies; out-of-band buffers (numpy,
        tensors) pay exactly one owning copy (the result must outlive the
        slot)."""
        seq, ln, ptr = self._read_view(self._last_seq, timeout, "read")
        try:
            value = serialization.loads_view(self._wrap(ptr, ln))
        finally:
            self._ack(seq)
        self._last_seq = seq
        return value

    def read_zc(self, timeout: Optional[float] = None) -> "SlotView":
        """Consume the next value as a PINNED zero-copy view: the ring
        slot is not acked (so the writer cannot reclaim it) until the
        returned SlotView is released. `value()` deserializes fully
        aliasing the slot — out-of-band numpy buffers and tensors point
        INTO shm with no copy at all (a tensor so made is writable: an
        in-place op on it writes the slot). The caller must release() (or use the context
        manager) exactly once; a leaked view wedges the writer when the
        ring wraps back to that slot."""
        seq, ln, ptr = self._read_view(self._last_seq, timeout, "read")
        self._last_seq = seq
        return SlotView(self, seq, self._wrap(ptr, ln))

    def read_raw(self, last_seq: int, timeout: Optional[float] = None
                 ) -> tuple:
        """Stateless read: block for the value after `last_seq`, return
        (seq, serialized bytes). The per-reader cursor lives with the
        CALLER — this is what lets one attached channel serve any number
        of remote readers through the dag_chan_read RPC (reference
        remote-reader mutable objects,
        `core_worker/experimental_mutable_object_provider.cc`)."""
        seq, ln, ptr = self._read_view(last_seq, timeout, "raw_read")
        try:
            # one owning copy (the bytes cross an RPC); the staging-buffer
            # path paid two (slot->buf memcpy + string_at)
            data = bytes(self._wrap(ptr, ln))
        finally:
            self._ack(seq)
        return seq, data

    def snapshot(self) -> dict:
        """Lock-free telemetry snapshot of the shm ring header: the native
        side reads the counters WITHOUT the channel mutex, so a monitoring
        thread can sample a channel whose writer or reader is currently
        stalled inside it. Stall attribution: `writer_stall_s` accrues
        while the writer blocks on a full ring (slow READER is the
        bottleneck); `reader_stall_s` accrues while a reader blocks on an
        empty ring (slow WRITER / upstream is the bottleneck)."""
        arr = (ctypes.c_uint64 * 8)()
        with self._close_lock:
            if not self._h:
                raise ChannelClosedError(self.name)
            self._lib_ref.rtpu_chan_stats(self._h, arr)
        return {
            "name": self.name,
            "seq": int(arr[0]),
            "occupancy": int(arr[1]),
            "num_slots": int(arr[2]),
            "writer_stall_s": arr[3] / 1e9,
            "reader_stall_s": arr[4] / 1e9,
            "writes": int(arr[5]),
            "reads": int(arr[6]),
            "closed": bool(arr[7]),
        }

    def shutdown(self) -> None:
        """Set the closed flag and wake blocked peers WITHOUT unmapping
        (close() would pull the mapping out from under a thread still
        blocked in read/write on this handle). Any attached handle may
        fence a channel this way — the teardown path for channels whose
        creator process died. `_close_lock` (never held across a
        blocking native call) guards the handle against a concurrent
        close() freeing it mid-use."""
        with self._close_lock:
            if self._h:
                self._lib_ref.rtpu_chan_shutdown(self._h)

    def close(self, unlink: bool = False) -> None:
        # shutdown first (under _close_lock only, which no blocking op
        # holds): wakes any op blocked inside the native call so it
        # releases _oplock; then munmap under BOTH locks — close can
        # never pull the mapping out from under a concurrent
        # read/write, and a concurrent close()/shutdown() can never
        # touch the freed handle (lock order: _oplock then _close_lock)
        self.shutdown()
        with self._oplock:
            with self._close_lock:
                if self._h:
                    self._lib_ref.rtpu_chan_close(self._h,
                                                  1 if unlink else 0)
                    self._h = None

    def __reduce__(self):
        # channels travel by name; receivers attach (and recover the true
        # num_readers / num_slots from the shm header)
        return (Channel.attach, (self.name,))


class SlotView:
    """One ring value viewed in place (``Channel.read_zc``): ``view()``
    and ``value()`` alias the shm slot directly; the slot stays pinned —
    the writer blocks before overwriting it — until ``release()``: consume
    the bytes where they already are, give the slot back explicitly."""

    __slots__ = ("_chan", "seq", "_mv", "_released")

    def __init__(self, chan: "Channel", seq: int, mv: memoryview):
        self._chan = chan
        self.seq = seq
        self._mv = mv
        self._released = False

    def view(self) -> memoryview:
        if self._released:
            raise ChannelError(f"slot view {self.seq} already released")
        return self._mv

    def value(self) -> Any:
        """Deserialize fully aliasing the slot: out-of-band buffers
        (numpy arrays, tensors) point INTO shm — zero copies. The result
        is only valid until release(); consumers that outlive the slot
        must copy what they keep (or use Channel.read, which owns its
        result)."""
        return serialization.deserialize(
            serialization.SerializedObject.from_view(self.view()))

    def release(self) -> None:
        """Ack the slot (idempotent), letting the writer reclaim it."""
        if not self._released:
            self._released = True
            self._mv = None
            self._chan._ack(self.seq)

    def __enter__(self) -> "SlotView":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class RemoteChannelReader:
    """Read end of a channel hosted in ANOTHER node's process, over the
    host process's direct server (`dag_chan_read`). Cross-node compiled
    DAGs use these for every edge that spans nodes — host-side pipeline
    stages across machines (SURVEY §3.7).

    Per-reader state (the seq cursor) lives here; the serving side holds
    one shared attachment, so N remote readers cost one channel."""

    def __init__(self, name: str, addr):
        self.name = name
        self.addr = (addr[0], int(addr[1]))
        self._last_seq = 0

    def read(self, timeout: Optional[float] = None) -> Any:
        import time as _time

        from ray_tpu_torch.core.api import _global_client

        client = _global_client()
        deadline = None if timeout is None else _time.monotonic() + timeout
        t0 = _time.perf_counter()
        while True:
            # bounded per-RPC wait keeps the serving side's reader threads
            # from being parked indefinitely by an idle consumer
            wait = 1.0
            if deadline is not None:
                wait = min(wait, deadline - _time.monotonic())
                if wait <= 0:
                    raise TimeoutError(f"read from {self.name} timed out")
            reply = client.direct_request(
                self.addr, "dag_chan_read", name=self.name,
                last_seq=self._last_seq, max_wait=wait)
            if reply.get("closed"):
                raise ChannelClosedError(self.name)
            if reply.get("data") is None:
                continue   # server-side wait elapsed; retry until deadline
            self._last_seq = reply["seq"]
            _observe_wait("remote_read", _time.perf_counter() - t0)
            return serialization.loads(reply["data"])

    def close(self, unlink: bool = False) -> None:
        pass   # the hosting process owns the channel's lifetime


# ----------------------------------------------------------- ring telemetry
# Per-lane ring series, published on the EXISTING per-process metrics push
# (gauges -> /metrics, one workload row per plane -> the head's hotpath
# aggregation). Zero new RPC channels: this is host-side sampling of the
# shm header the hot path already maintains.
_ring_gauges = None


def publish_ring_stats(plane: str, key: str, snaps: dict) -> None:
    """Publish ring telemetry for one compiled plane (a serve chain or a
    pipeline stage set). `snaps` maps lane label -> Channel.snapshot()
    dict. Gauges carry per-lane series; the aggregated workload row
    (kind "hotpath") carries the plane totals the watchdog and
    /api/hotpath consume. Best-effort: telemetry must never take down
    the plane it watches."""
    global _ring_gauges
    try:
        from ray_tpu_torch.util import metrics

        if _ring_gauges is None:
            tags = ("plane", "key", "lane")
            _ring_gauges = {
                "occ": metrics.Gauge(
                    "dag_ring_occupancy",
                    "Live values in the shm ring (written, not yet acked "
                    "by every reader), per lane", tag_keys=tags),
                "stall": metrics.Gauge(
                    "dag_ring_stall_seconds",
                    "Cumulative blocked time on the ring by side: "
                    "side=writer means the ring was full (slow reader), "
                    "side=reader means it was empty (slow writer)",
                    tag_keys=tags + ("side",)),
            }
        occ = wstall = rstall = writes = reads = 0.0
        depth = 0
        for lane, s in snaps.items():
            t = {"plane": plane, "key": key, "lane": str(lane)}
            _ring_gauges["occ"].set(float(s["occupancy"]), tags=t)
            _ring_gauges["stall"].set(
                s["writer_stall_s"], tags={**t, "side": "writer"})
            _ring_gauges["stall"].set(
                s["reader_stall_s"], tags={**t, "side": "reader"})
            occ += s["occupancy"]
            wstall += s["writer_stall_s"]
            rstall += s["reader_stall_s"]
            writes += s["writes"]
            reads += s["reads"]
            depth = max(depth, s["num_slots"])
        metrics.publish_workload("hotpath", f"{plane}:{key}", {
            "plane": plane,
            "lanes": len(snaps),
            "depth": depth,
            "occupancy": occ,
            "writer_stall_s": round(wstall, 6),
            "reader_stall_s": round(rstall, 6),
            "writes": writes,
            "reads": reads,
        })
    except Exception:
        pass
