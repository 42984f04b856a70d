"""Content-addressed weight plane: replica cold start as a P2P pull.

Counterpart of `ray_tpu/serve/weight_store.py`. A published param tree
becomes content-addressed objects on the object data plane, and a cold
replica streams them from its peers instead of re-reading the checkpoint
from a central path.

- **publish**: the replica (or trainer, or driver) that holds a param tree
  flattens it into one contiguous byte stream (leaf order and "/"-joined
  keys as `gpt2.save_params` writes them: sorted keys, as JAX flattens a
  dict), cuts the stream into fixed-size SEGMENT objects sealed as raw
  `bytes` (`ray_tpu_torch.put`), and seals a small manifest blob with the
  stream layout (per-leaf shape, numpy dtype string, offset; the segment
  table; the architecture sidecar; a blake2b content hash). One
  fire-and-forget push binds `weights_id -> manifest oid` on the head; the
  binding rides the next cluster_view broadcast as a directory weights row
  (`core/object_directory.py`). The manifest and the byte stream are the
  JAX package's, byte for byte (format `ray_tpu.weights.v1`), so a stream
  packed by either package restores in the other.
- **resolve**: a cold replica resolves `weights_id -> manifest` from its
  process-cached directory, residency-checked, with ZERO head RPCs.
- **pull**: leaves are read through `WindowedReader`s whose loader does
  RANGE fetches: a raw-bytes segment has its payload at a fixed frame
  offset (`_payload_off`), so rows [r0, r1) of a leaf map to exact byte
  windows served by the data server's `fetch_chunk(meta, offset, length)`
  (`core/object_transfer.py`). `load_params` streams each leaf with
  `stream_window` straight onto the engine's device, so peak host bytes
  stay ~`max_in_flight * chunk_bytes` whatever the model's size. Sources
  come from the gossiped directory (primary first, then pulled replicas),
  so pulls fail over across nodes; a miss degrades to a whole-segment
  `get` and finally to the checkpoint-path read: correctness never
  depends on the store.
- **LoRA hot-swap**: adapter deltas publish as small padded blobs under
  `lora::<base>::<adapter>` bindings; `OpenAIServer._engine_for` pulls
  them P2P before falling back to the adapter npz on disk.

Multi-tenant: hit/miss/byte counters are tagged per tenant; cold-start
latency lands in the `replica_cold_start_seconds` histogram tagged by
source (p2p vs checkpoint), and the resolve/pull/reshard phases emit the
`weights_resolve`, `weights_pull` and `weights_reshard` tracing spans.
"""

from __future__ import annotations

import hashlib
import io
import pickle
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

WEIGHTS_FORMAT = "ray_tpu.weights.v1"
ADAPTER_FORMAT = "ray_tpu.lora.v1"

# raw `bytes` objects serialize as [8B n_buffers][8B meta_len][meta]
# [8B buf_len][payload] (core/serialization.py), so the payload starts at
# a FIXED offset inside the sealed frame — which is what makes exact
# byte-range reads through fetch_chunk possible without a header fetch
def _payload_off() -> int:
    from ray_tpu_torch.core import serialization

    return 16 + len(serialization._BYTES_META) + 8


def _min_blob_bytes() -> int:
    # objects below the inline threshold ride actor replies, never the
    # sealed-object plane: a directory binding for one could not serve a
    # P2P pull (see prefix_store's inline_skipped). Small blobs
    # (manifests, adapters) are padded past it; pickle ignores the tail.
    from ray_tpu_torch.core.store import INLINE_THRESHOLD

    return int(INLINE_THRESHOLD) + 4096


def _flag_int(env: str, default: int) -> int:
    import os

    try:
        return int(os.environ.get(env, default))
    except (TypeError, ValueError):
        return default


# ------------------------------------------------------------------ metrics
_metrics = None


def _get_metrics():
    global _metrics
    if _metrics is None:
        from ray_tpu_torch.util import metrics as m

        _metrics = {
            "hits": m.Counter(
                "weight_store_hits_total",
                "Weight-store resolutions that delivered a full param "
                "tree / adapter from the P2P plane", tag_keys=("tenant",)),
            "misses": m.Counter(
                "weight_store_misses_total",
                "Weight-store resolutions that fell back to the "
                "checkpoint-path read (no resident binding, or the "
                "stream failed mid-pull)", tag_keys=("tenant",)),
            "bytes": m.Counter(
                "weight_store_bytes_total",
                "Weight bytes fetched from the cluster weight store",
                tag_keys=("tenant",)),
            "cold_start": m.Histogram(
                "replica_cold_start_seconds",
                "Wall seconds a replica spent materializing its params, "
                "by source (p2p = streamed from peers, checkpoint = "
                "central-path read)",
                boundaries=(0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60, 120),
                tag_keys=("source",)),
        }
    return _metrics


def observe_cold_start(seconds: float, source: str) -> None:
    """Record one replica cold start (engine init calls this for BOTH
    sources so the histogram compares them on /metrics)."""
    try:
        _get_metrics()["cold_start"].observe(float(seconds),
                                             tags={"source": source})
    except Exception:
        pass


def _client():
    """The process's ray client, or None outside an initialized runtime
    (standalone engines in unit tests): every store operation silently
    no-ops without a cluster."""
    try:
        from ray_tpu_torch.core import api as core_api

        if not core_api.is_initialized():
            return None
        return core_api._global_client()
    except Exception:
        return None


def adapter_store_key(base_weights_id: str, adapter_id: str) -> str:
    """Directory binding key for a LoRA adapter delta: scoped to the BASE
    weights identity so same-named adapters of different bases never
    collide."""
    return f"lora::{base_weights_id}::{adapter_id}"


def _tree_flatten_keyed(tree) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs of a tree of nested dicts, in sorted-key order
    (JAX's dict order) with the `gpt2.save_params` "/"-joined keying:
    publish and restore flatten the SAME way, so leaves match by position
    and by name, and a JAX-packed stream lines up with the port's."""
    if not isinstance(tree, dict):
        return [("", tree)]
    out = []
    for k in sorted(tree):
        for sub, leaf in _tree_flatten_keyed(tree[k]):
            out.append((f"{k}/{sub}" if sub else str(k), leaf))
    return out


def _host_array(leaf) -> np.ndarray:
    """A leaf on the host as numpy (one device-to-host copy of a CUDA
    tensor)."""
    if type(leaf).__module__.startswith("torch"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class _StreamPacker:
    """Cuts an incoming byte stream into fixed-size segment objects.

    Segments are exactly `segment_bytes` except the last, which absorbs
    the remainder (and is merged backward if it would fall below the
    inline threshold — every published segment must be pullable)."""

    def __init__(self, segment_bytes: int):
        self.segment_bytes = int(segment_bytes)
        self._buf = bytearray()
        self._h = hashlib.blake2b(digest_size=16)
        self.segments: List[dict] = []   # {"ref", "off", "nbytes"}
        self.total = 0

    def feed(self, data) -> None:
        mv = memoryview(data).cast("B")
        self._h.update(mv)
        self._buf += mv
        self.total += mv.nbytes
        # cut only while a full segment PLUS an above-inline tail remain
        # buffered: the invariant keeps the final segment (cut in
        # `finish`) at or above the inline floor, so every published
        # segment is pullable
        while len(self._buf) >= self.segment_bytes + _min_blob_bytes():
            self._cut(self.segment_bytes)

    def _cut(self, n: int) -> None:
        import ray_tpu_torch

        chunk = bytes(self._buf[:n])
        del self._buf[:n]
        off = sum(s["nbytes"] for s in self.segments)
        self.segments.append({"ref": ray_tpu_torch.put(chunk), "off": off,
                              "nbytes": len(chunk)})

    def finish(self) -> str:
        if self._buf:
            self._cut(len(self._buf))
        return "blake2b:" + self._h.hexdigest()


class _FlatLeaf:
    """One leaf of a published stream as a 1-D reader (`.shape`, `.dtype`,
    `.read(((a, b),))`): elements [a, b) of the leaf in C order are one
    byte range of the stream, fetched exactly."""

    def __init__(self, store: "WeightStoreClient", manifest: dict,
                 ent: dict, tenant: str):
        self.dtype = np.dtype(ent["dtype"])
        self.shape = (int(ent["nbytes"]) // self.dtype.itemsize,)
        self._args = (store, manifest, int(ent["off"]), tenant)

    def read(self, window) -> np.ndarray:
        store, manifest, off, tenant = self._args
        (a, b), = window
        isz = self.dtype.itemsize
        return np.frombuffer(store._read_stream(manifest, off + a * isz,
                                                (b - a) * isz, tenant),
                             dtype=self.dtype)


class WeightStoreClient:
    """One process's facade over the cluster weight tier (thread-safe:
    engine init, the publish executor, and adapter swaps share it)."""

    def __init__(self, fetch_timeout_s: float = 60.0,
                 max_published: int = 8):
        self.fetch_timeout_s = float(fetch_timeout_s)
        self.max_published = int(max_published)
        self.segment_bytes = _flag_int("RAY_TPU_WEIGHT_SEGMENT_BYTES",
                                       4 << 20)
        self.stream_chunk_bytes = _flag_int(
            "RAY_TPU_WEIGHT_STREAM_CHUNK_BYTES", 1 << 20)
        self.stream_in_flight = _flag_int(
            "RAY_TPU_WEIGHT_STREAM_IN_FLIGHT", 2)
        # weights_id -> {"manifest", "manifest_ref", "segment_refs"}:
        # pinned publications (the refs keep the bytes alive); bounded
        # LRU with explicit withdraw on eviction, like prefix_store pins
        self._published: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        # lifetime counters (stats()/tests; tagged Counters feed /metrics)
        self.hits = 0
        self.misses = 0
        self.bytes_fetched = 0
        self.range_fetches = 0
        self.local_reads = 0
        self.whole_pulls = 0
        self.published = 0
        self.inline_skipped = 0
        self.reannounced = 0
        self.last_load_stats: dict = {}
        # head-restart resilience: re-push bindings for live pins on
        # reconnect (the prefix_store pattern)
        self._reconnect_cb = None
        self._ensure_reconnect_hook(_client())
        # pre-import the streaming machinery NOW (engine init time):
        # first-import cost belongs to process startup, not inside a
        # replica's timed cold-start load
        try:
            from ray_tpu_torch.util import tracing  # noqa: F401
            from ray_tpu_torch.util.collective import reshard  # noqa: F401
        except Exception:
            pass

    # ----------------------------------------------------------- plumbing
    def _ensure_reconnect_hook(self, client) -> None:
        if client is None or self._reconnect_cb is not None:
            return
        import weakref

        ref = weakref.WeakMethod(self.reannounce)

        def _on_reconnect(_ref=ref, _client=client):
            m = _ref()
            if m is None:
                try:
                    _client.remove_reconnect_callback(_on_reconnect)
                except Exception:
                    pass
                return
            m()

        try:
            client.add_reconnect_callback(_on_reconnect)
            self._reconnect_cb = _on_reconnect
        except Exception:
            self._reconnect_cb = None

    def _count_miss(self, tenant: str) -> None:
        with self._lock:
            self.misses += 1
        try:
            _get_metrics()["misses"].inc(tags={"tenant": tenant})
        except Exception:
            pass

    def _count_hit(self, tenant: str) -> None:
        with self._lock:
            self.hits += 1
        try:
            _get_metrics()["hits"].inc(tags={"tenant": tenant})
        except Exception:
            pass

    def _count_bytes(self, n: int, tenant: str) -> None:
        with self._lock:
            self.bytes_fetched += int(n)
        try:
            _get_metrics()["bytes"].inc(int(n), tags={"tenant": tenant})
        except Exception:
            pass

    # -------------------------------------------------------------- publish
    def _put_blob(self, value: dict):
        """Seal a small control blob (manifest / adapter) as raw bytes,
        padded past the inline threshold so it is pullable and enters the
        gossiped directory (pickle stops at STOP; padding is inert)."""
        import ray_tpu_torch

        payload = pickle.dumps(value, protocol=4)
        pad = _min_blob_bytes() - len(payload)
        if pad > 0:
            payload += b"\x00" * pad
        return ray_tpu_torch.put(payload)

    def _pin(self, weights_id: str, ent: dict, client) -> None:
        evicted: List[Tuple[str, bytes]] = []
        with self._lock:
            old = self._published.pop(weights_id, None)
            self._published[weights_id] = ent
            self.published += 1
            while len(self._published) > self.max_published:
                wid, oldent = self._published.popitem(last=False)
                evicted.append((wid, oldent["manifest_ref"].id.binary()))
        if old is not None:
            evicted.append((weights_id, old["manifest_ref"].id.binary()))
        for wid, oid in evicted:
            # dropping the refs releases the bytes through the refcount
            # plane; the explicit withdraw retires the binding promptly.
            # oid-scoped: the head keeps a binding another publisher has
            # since rebound to its own live manifest
            try:
                client.head_push("withdraw_weights", weights_id=wid,
                                 oid=oid)
            except Exception:
                pass

    def _announced_ok(self, ref, client) -> bool:
        """Sealed past the inline threshold? Inline blobs never enter the
        directory, so a binding for one could never serve a pull."""
        from ray_tpu_torch.core.object_directory import PULLABLE_KINDS

        meta = client.local_metas.get(ref.id)
        if meta is None or meta.kind not in PULLABLE_KINDS:
            with self._lock:
                self.inline_skipped += 1
            return False
        return True

    def publish_stream(self, weights_id: str,
                       leaves: Iterator[Tuple[str, tuple, Any,
                                              Iterator[np.ndarray]]],
                       arch: Optional[dict] = None) -> Optional[dict]:
        """Publish a weight byte stream: `leaves` yields
        (key, global_shape, dtype, row-block iterator) in template order;
        blocks are consumed one at a time, so peak publisher memory is
        ~one segment + one block regardless of model size. Returns the
        manifest, or None when there is no cluster / the stream is too
        small to live on the object plane."""
        client = _client()
        if client is None:
            return None
        self._ensure_reconnect_hook(client)
        packer = _StreamPacker(self.segment_bytes)
        params_meta: Dict[str, dict] = {}
        for key, shape, dtype, blocks in leaves:
            dt = np.dtype(dtype)
            off = packer.total
            n = 0
            for block in blocks:
                block = np.ascontiguousarray(np.asarray(block, dtype=dt))
                packer.feed(block.view(np.uint8).reshape(-1))
                n += block.nbytes
            params_meta[key] = {"shape": tuple(int(s) for s in shape),
                                "dtype": dt.str, "off": off, "nbytes": n}
        if packer.total == 0:
            return None
        content = packer.finish()
        if packer.total < _min_blob_bytes():
            # sub-inline model: its lone segment rides actor replies, not
            # the plane — count and skip (prefix_store semantics)
            with self._lock:
                self.inline_skipped += 1
            return None
        if not all(self._announced_ok(s["ref"], client)
                   for s in packer.segments):
            return None
        manifest = {"format": WEIGHTS_FORMAT, "weights_id": weights_id,
                    "hash": content, "arch": dict(arch) if arch else None,
                    "segment_bytes": self.segment_bytes,
                    "params": params_meta,
                    "segments": [{"oid": s["ref"].id.binary(),
                                  "off": s["off"], "nbytes": s["nbytes"]}
                                 for s in packer.segments],
                    "total_bytes": packer.total}
        try:
            manifest_ref = self._put_blob(manifest)
            if not self._announced_ok(manifest_ref, client):
                return None
            client.head_push("announce_weights", weights_id=weights_id,
                             oid=manifest_ref.id.binary())
        except Exception:
            return None
        self._pin(weights_id, {"manifest": manifest,
                               "manifest_ref": manifest_ref,
                               "segment_refs": [s["ref"]
                                                for s in packer.segments]},
                  client)
        return manifest

    def publish_params(self, params, weights_id: str,
                       arch: Optional[dict] = None) -> Optional[dict]:
        """Publish an in-memory param tree (the replica that just paid
        the checkpoint-path read shares it with the rest of the fleet)."""
        pairs = _tree_flatten_keyed(params)

        def leaves():
            for key, leaf in pairs:
                a = _host_array(leaf)
                yield key, a.shape, a.dtype, iter([a])

        return self.publish_stream(weights_id, leaves(), arch=arch)

    def publish_sharded(self, path: str,
                        weights_id: Optional[str] = None,
                        arch: Optional[dict] = None) -> Optional[dict]:
        """Publish a `train/checkpoint.save_sharded` checkpoint straight
        from its windowed readers: rows stream from the npz seek-reads
        into the segment packer, so a multi-GB sharded checkpoint
        publishes under a bounded host budget."""
        from ray_tpu_torch.train.checkpoint import open_sharded

        readers, _manifest = open_sharded(path)

        def leaves():
            for key in sorted(readers):
                r = readers[key]
                shape, dt = tuple(r.shape), np.dtype(r.dtype)
                if not shape:
                    yield key, shape, dt, iter(
                        [np.asarray(r.read(()), dt)])
                    continue
                row_bytes = dt.itemsize * int(
                    np.prod(shape[1:], dtype=np.int64) or 1)
                step = max(1, self.segment_bytes // max(1, row_bytes))

                def blocks(r=r, shape=shape, step=step):
                    for r0 in range(0, shape[0], step):
                        r1 = min(r0 + step, shape[0])
                        yield r.read(((r0, r1),)
                                     + tuple((0, s) for s in shape[1:]))

                yield key, shape, dt, blocks()

        return self.publish_stream(weights_id or path, leaves(), arch=arch)

    def reannounce(self) -> int:
        """Re-push bindings for every pinned publication (fired by the
        client's reconnect hook after a head restart)."""
        client = _client()
        if client is None:
            return 0
        with self._lock:
            pins = [(wid, ent["manifest_ref"].id.binary())
                    for wid, ent in self._published.items()]
        n = 0
        for wid, oid in pins:
            try:
                client.head_push("announce_weights", weights_id=wid,
                                 oid=oid)
                n += 1
            except Exception:
                pass
        with self._lock:
            self.reannounced += n
        return n

    # -------------------------------------------------------------- resolve
    def resolve(self, weights_id: str) -> Optional[dict]:
        """weights_id -> manifest, zero head RPCs: this process's pins
        first (no gossip round trip for same-process publications), then
        the broadcast-fed directory binding (residency-checked) with the
        manifest blob pulled over the data plane."""
        with self._lock:
            ent = self._published.get(weights_id)
            if ent is not None:
                self._published.move_to_end(weights_id)
                return ent["manifest"]
        client = _client()
        if client is None:
            return None
        try:
            binding = client.object_dir.weights_binding(weights_id)
        except Exception:
            binding = None
        if binding is None:
            return None
        import ray_tpu_torch
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef

        try:
            blob = ray_tpu_torch.get(ObjectRef(ObjectID(binding["oid"])),
                               timeout=self.fetch_timeout_s)
            manifest = pickle.loads(blob)
        except Exception:
            return None
        if (not isinstance(manifest, dict)
                or manifest.get("format") != WEIGHTS_FORMAT):
            return None
        return manifest

    # ----------------------------------------------------------- range pull
    def _local_meta(self, client, oid):
        """A locally-readable meta for the segment, if any: publisher's
        own seal, this process's pulled LRU, the node daemon's
        PullManager cache — or any same-node copy advertised in the
        gossiped directory (shared-memory store: a segment sealed by a
        NEIGHBOR process on this node mmaps directly, no socket; a
        remote node's meta fails the probe and falls through to the
        ranged fetch)."""
        for m in (client.local_metas.get(oid),
                  client._pulled.get(oid),
                  client._daemon_pulled.get(oid)):
            if m is not None and client._probe_readable(m):
                return m
        try:
            m = client.object_dir.lookup_meta(oid)
        except Exception:
            m = None
        if m is not None and client._probe_readable(m):
            return m
        return None

    def _fetch_range(self, oid_bytes: bytes, offset: int, length: int,
                     tenant: str = "base") -> bytearray:
        """Exact byte window [offset, offset+length) of a segment's
        PAYLOAD. Local zero-copy read when any resident copy exists;
        otherwise a ranged `fetch_chunk` against the directory's sources
        (primary, then PullManager replicas — multi-source failover);
        finally a whole-segment pull through the normal get() path. Any
        raise means the caller falls back to the checkpoint path."""
        import asyncio

        from ray_tpu_torch.core import protocol
        from ray_tpu_torch.core.ids import ObjectID

        client = _client()
        if client is None:
            raise RuntimeError("no ray_tpu_torch runtime")
        oid = ObjectID(oid_bytes)
        pay = _payload_off()
        local = self._local_meta(client, oid)
        if local is not None:
            view, release = client.store.get_raw(local, pay + offset,
                                                 length)
            try:
                data = bytearray(view)
            finally:
                if release is not None:
                    release()
            with self._lock:
                self.local_reads += 1
            self._count_bytes(length, tenant)
            return data
        meta = client.object_dir.lookup_meta(oid)
        if meta is None:
            meta = client.local_metas.get(oid)
        if meta is not None:
            timeout = self.fetch_timeout_s + length / (4 << 20)

            async def _go():
                last: Optional[BaseException] = None
                for addr in client._sources_from_view(meta):
                    key = (addr[0], addr[1])
                    try:
                        conn = client._data_conns.get(key)
                        if conn is None or conn.closed:
                            conn = await protocol.connect(
                                key[0], key[1], name=f"data-{key[1]}")
                            client._data_conns[key] = conn
                        return await asyncio.wait_for(
                            conn.request("fetch_chunk", meta=meta,
                                         offset=pay + offset,
                                         length=length),
                            timeout=timeout)
                    except (protocol.RpcError, OSError, FileNotFoundError,
                            asyncio.TimeoutError) as e:
                        last = e
                        continue
                raise last or FileNotFoundError(f"no sources for {oid}")

            try:
                fut = asyncio.run_coroutine_threadsafe(_go(), client.loop)
                data = bytearray(fut.result(timeout=timeout + 5))
                with self._lock:
                    self.range_fetches += 1
                self._count_bytes(length, tenant)
                return data
            except Exception:
                pass  # ranged path lost every source: try a whole pull
        # last resort before the checkpoint fallback: pull the WHOLE
        # segment through get() (node PullManager: in-flight dedup,
        # replica failover, head cold-miss fallback, LRU cache — later
        # ranges of this segment then read locally)
        import ray_tpu_torch
        from ray_tpu_torch.core.object_ref import ObjectRef

        blob = ray_tpu_torch.get(ObjectRef(oid), timeout=self.fetch_timeout_s)
        with self._lock:
            self.whole_pulls += 1
        self._count_bytes(length, tenant)
        return bytearray(blob[offset:offset + length])

    def prefetch_segments(self, manifest: dict, tenant: str = "base",
                          max_parallel: int = 4) -> int:
        """Bulk-pull every non-resident segment through the node
        PullManager (parallel whole-object gets) so the subsequent
        windowed reads all hit the local zero-copy path. A FULL restore
        touches every byte anyway: one pipelined pull per segment beats
        a socket round trip per leaf window. Partial consumers (TP ranks
        pulling only their rows) skip this and range-fetch. Returns the
        number of segments pulled; failures are left for the ranged path
        to retry source-by-source."""
        import ray_tpu_torch
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef

        client = _client()
        if client is None:
            return 0
        cold = [seg["oid"] for seg in manifest.get("segments", ())
                if self._local_meta(client, ObjectID(seg["oid"])) is None]
        if not cold:
            return 0
        from concurrent.futures import ThreadPoolExecutor

        def _pull(oid_bytes: bytes) -> int:
            try:
                ray_tpu_torch.get(ObjectRef(ObjectID(oid_bytes)),
                            timeout=self.fetch_timeout_s)
                return 1
            except Exception:
                return 0   # ranged fetch will fail over per source
        if len(cold) == 1:
            pulled = _pull(cold[0])
        else:
            with ThreadPoolExecutor(
                    max_workers=min(max_parallel, len(cold)),
                    thread_name_prefix="weight-prefetch") as pool:
                pulled = sum(pool.map(_pull, cold))
        with self._lock:
            self.whole_pulls += pulled
        return pulled

    def _read_stream(self, manifest: dict, offset: int, length: int,
                     tenant: str) -> bytearray:
        """Assemble stream bytes [offset, offset+length) from the
        overlapping segments."""
        out = []
        need0, need1 = int(offset), int(offset) + int(length)
        for seg in manifest["segments"]:
            s0 = int(seg["off"])
            s1 = s0 + int(seg["nbytes"])
            lo, hi = max(need0, s0), min(need1, s1)
            if lo >= hi:
                continue
            out.append(self._fetch_range(seg["oid"], lo - s0, hi - lo,
                                         tenant=tenant))
        # one window inside one segment (the common case) is its own
        # buffer: no second copy on the host
        data = out[0] if len(out) == 1 else bytearray().join(out)
        if len(data) != length:
            raise FileNotFoundError(
                f"weight stream window [{need0}, {need1}) short: got "
                f"{len(data)} of {length} bytes")
        return data

    # ---------------------------------------------------------------- open
    def open(self, weights_id: str, tenant: str = "base"
             ) -> Optional[Tuple[Dict[str, Any], dict]]:
        """`weights_id` -> ({leaf key: WindowedReader}, manifest), the
        `train/checkpoint.open_sharded` contract served off the P2P
        plane: each reader's loader does exact range fetches, so
        `reshard_streaming` (or any windowed consumer) pulls only the
        rows it needs. None when no resident binding exists."""
        from ray_tpu_torch.util.collective.reshard import WindowedReader

        manifest = self.resolve(weights_id)
        if manifest is None:
            return None
        readers: Dict[str, Any] = {}
        for key, ent in manifest["params"].items():
            shape = tuple(ent["shape"])
            dt = np.dtype(ent["dtype"])
            if not shape:
                def loader(k, r0, r1, _ent=ent, _dt=dt):
                    data = self._read_stream(manifest, _ent["off"],
                                             _dt.itemsize, tenant)
                    return np.frombuffer(data, dtype=_dt)

                readers[key] = WindowedReader((), dt, [((), key)], loader)
                continue
            trailing = shape[1:]
            row_bytes = dt.itemsize * int(
                np.prod(trailing, dtype=np.int64) or 1)

            def loader(k, r0, r1, _ent=ent, _dt=dt, _shape=shape,
                       _row=row_bytes):
                data = self._read_stream(manifest,
                                         _ent["off"] + r0 * _row,
                                         (r1 - r0) * _row, tenant)
                return np.frombuffer(data, dtype=_dt).reshape(
                    (r1 - r0,) + _shape[1:])

            readers[key] = WindowedReader(
                shape, dt, [(tuple((0, s) for s in shape), key)], loader)
        return readers, manifest

    # ------------------------------------------------------------- adapters
    def publish_adapter(self, adapter_key: str,
                        adapter: dict) -> Optional[dict]:
        """Publish a LoRA adapter delta ({path: {A, B, alpha}}) as one
        padded blob bound under `adapter_key` — small enough that range
        fetch buys nothing, hot-swapped often enough that P2P residency
        buys a lot."""
        client = _client()
        if client is None:
            return None
        self._ensure_reconnect_hook(client)
        blob = {"format": ADAPTER_FORMAT, "adapter": {
            path: {k: (_host_array(v) if k in ("A", "B") else v)
                   for k, v in spec.items()}
            for path, spec in adapter.items()}}
        try:
            ref = self._put_blob(blob)
            if not self._announced_ok(ref, client):
                return None
            client.head_push("announce_weights", weights_id=adapter_key,
                             oid=ref.id.binary())
        except Exception:
            return None
        manifest = {"format": ADAPTER_FORMAT, "weights_id": adapter_key}
        self._pin(adapter_key, {"manifest": manifest, "manifest_ref": ref,
                                "segment_refs": [], "adapter": adapter},
                  client)
        return manifest

    def fetch_adapter(self, adapter_key: str,
                      tenant: str = "base") -> Optional[dict]:
        """Pull an adapter delta from the store; None on any miss (the
        caller loads the adapter npz from disk instead)."""
        with self._lock:
            ent = self._published.get(adapter_key)
            if ent is not None and "adapter" in ent:
                self._published.move_to_end(adapter_key)
        if ent is not None and "adapter" in ent:
            self._count_hit(tenant)
            return ent["adapter"]
        client = _client()
        if client is None:
            return None
        try:
            binding = client.object_dir.weights_binding(adapter_key)
        except Exception:
            binding = None
        if binding is None:
            self._count_miss(tenant)
            return None
        import ray_tpu_torch
        from ray_tpu_torch.core.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef

        try:
            blob = pickle.loads(ray_tpu_torch.get(
                ObjectRef(ObjectID(binding["oid"])),
                timeout=self.fetch_timeout_s))
        except Exception:
            self._count_miss(tenant)
            return None
        if (not isinstance(blob, dict)
                or blob.get("format") != ADAPTER_FORMAT):
            self._count_miss(tenant)
            return None
        size = sum(int(np.asarray(v).nbytes)
                   for spec in blob["adapter"].values()
                   for k, v in spec.items() if k in ("A", "B"))
        self._count_hit(tenant)
        self._count_bytes(size, tenant)
        return blob["adapter"]

    # ------------------------------------------------------------ high level
    def load_params(self, weights_id: str, base_cfg=None, device=None,
                    device_of: Optional[Callable] = None,
                    tenant: str = "base"):
        """Materialize a full GPT-2 param tree from the store: resolve the
        manifest from the gossiped directory, stream every leaf with
        `stream_window` straight onto its device (peak host ~= in_flight *
        chunk_bytes), and return `(params, cfg)` exactly like
        `gpt2.load_params`. None on ANY miss: the caller falls back to the
        checkpoint-path read.

        `device_of(key, shape)` gives each leaf's destination device (the
        JAX package's `sharding_of`); by default every leaf goes to
        `device` (CUDA unless the caller asks for the CPU).

        Each leaf streams as its flat byte range, in `chunk_bytes` pieces
        (`_FlatLeaf`): a row larger than a chunk never lands whole on the
        host (GPT-2-125M's stacked [12, 768, 3072] `mlp/wi` has 9 MiB rows;
        the JAX package's leading-dim windows hold one whole)."""
        import dataclasses
        import time as _time

        import torch

        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.util import tracing as _tracing
        from ray_tpu_torch.util.collective.reshard import (last_stream_stats,
                                                           stream_window)
        from ray_tpu_torch.utils.platform import default_device
        from ray_tpu_torch.utils.tree import nest

        t0 = _time.perf_counter()
        with _tracing.start_span(
                "weights_resolve",
                attributes={"ray_tpu.op": "weights_resolve",
                            "weights_id": str(weights_id)[:80]}):
            manifest = self.resolve(weights_id)
        if manifest is None:
            self._count_miss(tenant)
            return None
        arch = manifest.get("arch")
        if arch:
            base = base_cfg or gpt2.GPT2Config()
            cfg = dataclasses.replace(base, **arch)
        elif base_cfg is not None:
            cfg = base_cfg
        else:
            self._count_miss(tenant)
            return None
        pairs = _tree_flatten_keyed(nest(gpt2.param_shapes(cfg)))
        for key, shape in pairs:
            ent = manifest["params"].get(key)
            if ent is None or tuple(ent["shape"]) != tuple(shape):
                self._count_miss(tenant)
                return None   # arch drift: let the checkpoint path decide
        if device_of is None:
            dev = default_device(device)
            device_of = lambda key, shape: dev  # noqa: E731
        flat = {}
        peak = 0
        resolve_s = _time.perf_counter() - t0
        try:
            with _tracing.start_span(
                    "weights_pull",
                    attributes={"ray_tpu.op": "weights_pull",
                                "bytes": int(manifest["total_bytes"]),
                                "leaves": len(pairs)}):
                if _flag_int("RAY_TPU_WEIGHT_PREFETCH", 1):
                    # full restore: bulk-pull cold segments up front so
                    # every window below is a local zero-copy read
                    self.prefetch_segments(manifest, tenant=tenant)
                for key, shape in pairs:
                    ent = manifest["params"][key]
                    leaf = _FlatLeaf(self, manifest, ent, tenant)
                    with _tracing.start_span(
                            "weights_reshard",
                            attributes={"ray_tpu.op": "weights_reshard",
                                        "leaf": key[:80]}):
                        t = stream_window(
                            leaf, ((0, leaf.shape[0]),),
                            device_of(key, shape),
                            chunk_bytes=self.stream_chunk_bytes,
                            max_in_flight=self.stream_in_flight)
                    peak = max(peak, last_stream_stats.get(
                        "peak_host_bytes", 0))
                    flat[key] = t.view(shape).to(cfg.param_dtype)
        except Exception:
            self._count_miss(tenant)
            return None
        if any(t.device.type == "cuda" for t in flat.values()):
            torch.cuda.synchronize()
        params = nest(flat)
        self._count_hit(tenant)
        self.last_load_stats = {
            "weights_id": weights_id, "leaves": len(pairs),
            "bytes": int(manifest["total_bytes"]),
            "peak_host_bytes": int(peak),
            "chunk_bytes": self.stream_chunk_bytes,
            "max_in_flight": self.stream_in_flight,
            "resolve_s": resolve_s,
            "seconds": _time.perf_counter() - t0}
        return params, cfg

    # ---------------------------------------------------------------- stats
    def stats(self) -> dict:
        with self._lock:
            return {"published": self.published,
                    "pinned": len(self._published),
                    "inline_skipped": self.inline_skipped,
                    "reannounced": self.reannounced,
                    "store_hits": self.hits,
                    "store_misses": self.misses,
                    "store_bytes_fetched": self.bytes_fetched,
                    "range_fetches": self.range_fetches,
                    "local_reads": self.local_reads,
                    "whole_pulls": self.whole_pulls,
                    "last_load": dict(self.last_load_stats)}


# process-wide store, rebuilt when the runtime is (re)initialized so pins
# never outlive their cluster
_store: Optional[WeightStoreClient] = None
_store_client_id: Optional[int] = None
_store_lock = threading.Lock()


def get_store() -> Optional[WeightStoreClient]:
    """The process's weight-store client, or None outside an initialized
    runtime."""
    client = _client()
    if client is None:
        return None
    global _store, _store_client_id
    with _store_lock:
        if _store is None or _store_client_id != id(client):
            _store = WeightStoreClient()
            _store_client_id = id(client)
        return _store


def maybe_publish_params_async(params, weights_id: str,
                               arch: Optional[dict] = None) -> bool:
    """Background publish of a param tree UNLESS the cluster already
    holds a resident binding (the dedup check runs before paying the
    flatten/hash/put work). The replica that just paid the central
    checkpoint read shares it without blocking its own init; failures
    are silent — the next replica simply pays the path read too."""
    client = _client()
    store = get_store()
    if client is None or store is None:
        return False
    with store._lock:
        if weights_id in store._published:
            return False
    try:
        if client.object_dir.weights_binding(weights_id) is not None:
            return False       # another replica already published it
    except Exception:
        pass

    def _go():
        try:
            store.publish_params(params, weights_id, arch=arch)
        except Exception:
            pass

    threading.Thread(target=_go, daemon=True,
                     name="weight-store-publish").start()
    return True
