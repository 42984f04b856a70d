"""Cross-node object data plane: chunked pulls + the node pull manager.

Capability parity with the reference object manager
(`src/ray/object_manager/object_manager.h`, `pull_manager.h:49`
admission-controlled pulls, `push_manager.h:27`, chunking in
`chunk_object_reader.cc`), re-designed for this runtime: every node (the
head in-process, worker nodes in their node daemon) runs a tiny data
server that serves `fetch_chunk` reads straight out of the node-local shm
store; a consumer that misses locally resolves serving nodes from the
gossiped object directory (head `locate_object` on cold miss), pulls
chunks with a pipelined window, and seals a local cached copy.

Pull-based only: the scheduler already co-locates most consumers with
producers, and a pull is self-admitting (the puller bounds its own
concurrency) where pushes would need receiver-side flow control.

The **PullManager** is the grown-up version of the original single-source
helper: one in-flight pull per object id with shared waiters, multi-source
failover across advertised replicas, per-chunk retry/backoff riding the
chaos plane, an LRU replica cache whose contents are announced back into
the object directory, and bandwidth/latency accounting
(`object_pull_bytes_total`, `object_pull_seconds` on `/metrics`). Node
daemons own one and serve `pull_object` to their local workers, so each
object crosses the network once per node; the head runs one for its own
node's workers; drivers embed one for direct pulls.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core.store import ObjectMeta, SharedMemoryStore
from ray_tpu_torch.core.ids import ObjectID

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.core import protocol


def CHUNK() -> int:
    return _config.get("transfer_chunk_bytes")


def WINDOW() -> int:
    return _config.get("transfer_window")


def SERVER_CONCURRENCY() -> int:
    return _config.get("transfer_server_reads")


# ------------------------------------------------------------------ metrics
_metrics = None


def _get_metrics():
    """Lazy data-plane series (one registry per process; daemon registries
    ride gossip to the head's /metrics, drivers/workers use the pusher)."""
    global _metrics
    if _metrics is None:
        from ray_tpu_torch.util import metrics as m

        _metrics = {
            "bytes": m.Counter(
                "object_pull_bytes_total",
                "Bytes pulled over the object data plane",
                tag_keys=("role",)),
            "pulls": m.Counter(
                "object_pulls_total",
                "Completed cross-node object pulls",
                tag_keys=("role",)),
            "retries": m.Counter(
                "object_pull_retries_total",
                "Chunk retries + source failovers during pulls",
                tag_keys=("role",)),
            "seconds": m.Histogram(
                "object_pull_seconds",
                "Wall time of completed object pulls",
                boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5,
                            1.0, 2.5, 5.0, 10.0, 30.0],
                tag_keys=("role",)),
        }
    return _metrics


def make_data_handlers(get_store: Callable[[], Optional[SharedMemoryStore]],
                       get_pull_manager: Callable[[], Optional["PullManager"]]
                       = lambda: None):
    """Handler table for a node's data server. `get_store` is a thunk so
    the daemon can start serving before its store exists (registration
    assigns the session first); `get_pull_manager` likewise exposes the
    node's pull manager to local workers (`pull_object` RPC) once it is
    wired up."""
    sems: Dict[int, asyncio.Semaphore] = {}

    def _sem() -> asyncio.Semaphore:
        # one semaphore per event loop (handlers may serve from the head
        # loop in-process and from tests' loops)
        key = id(asyncio.get_running_loop())
        if key not in sems:
            sems[key] = asyncio.Semaphore(SERVER_CONCURRENCY())
        return sems[key]

    async def fetch_chunk(meta: ObjectMeta, offset: int, length: int):
        import pickle

        async with _sem():
            store = get_store()
            if store is None:
                raise FileNotFoundError("store not initialized")
            try:
                view, release = store.get_raw(meta, offset, length)
            except FileNotFoundError:
                # the requester resolved US from a replica announcement:
                # its meta describes the PRIMARY's storage (a segment
                # that only exists there) — translate by object id to
                # our pull manager's local replica copy
                manager = get_pull_manager()
                local = (manager.cached(meta.object_id)
                         if manager is not None else None)
                if local is None or local.size != meta.size:
                    raise
                view, release = store.get_raw(local, offset, length)
            if len(view) != length:
                if release is not None:
                    view.release()
                    release()
                raise FileNotFoundError(
                    f"object {meta.object_id} short read at {offset}: "
                    f"{len(view)} != {length}")
            if release is not None:
                # pinned (arena) read: copy before unpinning — the mapping
                # could be reused by a new allocation once unpinned
                try:
                    return bytes(view)
                finally:
                    view.release()
                    release()
            # shm/spill/inline: ship the slice out-of-band with no copy
            # (the segment mapping stays alive via the store's cache)
            return pickle.PickleBuffer(view)

    async def pull_object_rpc(meta: ObjectMeta, sources=None, trace=None):
        """Node-level pull on behalf of a co-located worker: the daemon's
        pull manager fetches the object into the NODE store once (in-flight
        dedup + replica cache), and every local worker maps the same copy —
        each object crosses the network once per node. `trace` carries the
        consuming task's W3C context so the daemon-side pull span joins
        that trace."""
        manager = get_pull_manager()
        if manager is None:
            raise FileNotFoundError("no pull manager on this node")
        store = get_store()
        if store is not None and store.readable(meta):
            try:  # already local (producer lives here / raced another pull)
                view, rel = store.get_raw(meta, 0, 0)
                view.release()
                if rel is not None:
                    rel()
                return meta
            except FileNotFoundError:
                pass
        from ray_tpu_torch.util import tracing

        with tracing.adopt_context(trace):
            local = await manager.pull(
                meta, sources=[tuple(s) for s in sources or ()])
        return local

    async def data_ping() -> bool:
        return True

    return {"fetch_chunk": fetch_chunk, "pull_object": pull_object_rpc,
            "data_ping": data_ping}


async def pull_object(conn, meta: ObjectMeta, store: SharedMemoryStore,
                      role: str = "client") -> ObjectMeta:
    """Pull one object over an established data connection into the local
    store. Chunks are requested with a pipelined window of WINDOW in
    flight (the admission-control role of the reference PullManager's
    chunked gets); a failed chunk is retried with backoff while the
    connection is alive (injected chaos drops/delays on the data edge are
    absorbed here). Returns the local cached-copy meta."""
    pending = store.allocate_raw(meta.object_id, meta.size)
    retries = max(int(_config.get("transfer_chunk_retries")), 0)
    backoff = float(_config.get("transfer_retry_backoff_s"))

    def _permanent(e: BaseException) -> bool:
        """Not-found style failures are deterministic — the object is not
        (or no longer) at this source; retrying the chunk only delays the
        caller's failover to the next advertised source. Retry is for the
        transient class: injected drops, lost frames, timeouts."""
        return isinstance(e, FileNotFoundError) or (
            isinstance(e, protocol.RemoteError)
            and "FileNotFoundError" in str(e))

    async def _fetch(o: int, ln: int, attempt: int):
        """Fetch one chunk; retry backoff sleeps INSIDE this task, so a
        failing chunk never head-of-line-blocks the rest of the window.
        A chaos `drop` raises ConnectionLost at send time while the
        connection stays alive — normalized into the same failure path
        as a dropped reply."""
        if attempt:
            _get_metrics()["retries"].inc(tags={"role": role})
            await asyncio.sleep(min(backoff * (2 ** (attempt - 1)), 1.0))
            if conn.closed:
                raise protocol.ConnectionLost(
                    f"connection {conn.name} closed")
        try:
            fut = conn.request_future("fetch_chunk", meta=meta,
                                      offset=o, length=ln)
        except protocol.ConnectionLost:
            if conn.closed:
                raise
            raise protocol.ConnectionLost("injected drop at send")
        data = await fut
        got = memoryview(data).nbytes if data is not None else 0
        if got != ln:
            # a silently short chunk would seal a zero-padded buffer
            # that deserializes to corrupt data downstream
            raise FileNotFoundError(
                f"short chunk for {meta.object_id} at {o}: {got} != {ln}")
        return data

    tasks: Dict[asyncio.Task, Tuple[int, int, int]] = {}
    try:
        chunk = CHUNK()
        offsets = list(range(0, meta.size, chunk)) or [0]
        idx = 0
        while idx < len(offsets) or tasks:
            while idx < len(offsets) and len(tasks) < WINDOW():
                o = offsets[idx]
                idx += 1
                ln = min(chunk, meta.size - o)
                t = asyncio.ensure_future(_fetch(o, ln, 0))
                tasks[t] = (o, ln, 0)
            done, _ = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_COMPLETED)
            for t in done:
                o, ln, attempt = tasks.pop(t)
                try:
                    data = t.result()
                except (protocol.RpcError, FileNotFoundError) as e:
                    if _permanent(e) or attempt >= retries or (
                            isinstance(e, protocol.ConnectionLost)
                            and conn.closed):
                        raise
                    # chunk-level retry: dropped/failed fetches (chaos
                    # plane, transient server errors) re-request with
                    # backoff instead of abandoning the whole pull
                    nt = asyncio.ensure_future(_fetch(o, ln, attempt + 1))
                    tasks[nt] = (o, ln, attempt + 1)
                    continue
                if ln:
                    pending.write(o, data)
        local = pending.seal()
    except BaseException:
        for t in tasks:
            t.cancel()
        pending.abort()
        raise
    local.error = meta.error
    local.owner = meta.owner
    return local


class PullManager:
    """Admission-controlled, deduplicated, failover-capable object pulls
    for one process (reference `pull_manager.h:49`).

    - one in-flight pull per object id; concurrent requesters share it
      (shielded, so one canceled waiter doesn't kill the transfer);
    - multi-source failover: sources beyond the first are tried in order
      when a pull attempt fails (node died, object moved, chaos);
    - `resolve(meta)` (optional, async) supplies sources when the caller
      has none — the daemon resolves from its cached object directory and
      cluster view, falling back to the head;
    - completed pulls land in an LRU replica cache bounded by
      `cache_bytes`; evicted replicas are unlinked and `on_replica_gone`
      fires so the directory forgets them.
    """

    def __init__(self, get_store: Callable[[], Optional[SharedMemoryStore]],
                 *, role: str = "node",
                 resolve: Optional[Callable] = None,
                 cache_bytes: Optional[int] = None,
                 on_replica: Optional[Callable[[ObjectMeta], None]] = None,
                 on_replica_gone: Optional[Callable[[ObjectID], None]] = None,
                 max_concurrent: int = 4):
        self.get_store = get_store
        self.role = role
        self.resolve = resolve
        self.cache_bytes = (cache_bytes if cache_bytes is not None
                            else _config.get("replica_cache_bytes"))
        self.on_replica = on_replica
        self.on_replica_gone = on_replica_gone
        self._tasks: Dict[ObjectID, asyncio.Task] = {}
        self._conns: Dict[Tuple[str, int], protocol.Connection] = {}
        self._connecting: Dict[Tuple[str, int], asyncio.Task] = {}
        self._sem = asyncio.Semaphore(max_concurrent)
        self._replicas: "OrderedDict[ObjectID, ObjectMeta]" = OrderedDict()
        self._replica_bytes = 0
        # lifetime counters, gossiped in sched_stats (observable without
        # scraping /metrics)
        self.stats = {"object_pulls": 0, "object_pull_bytes": 0,
                      "object_pull_failovers": 0}

    # ------------------------------------------------------------- cache
    def cached(self, oid: ObjectID) -> Optional[ObjectMeta]:
        local = self._replicas.get(oid)
        if local is not None:
            self._replicas.move_to_end(oid)
        return local

    def replica_ids(self) -> List[ObjectID]:
        return list(self._replicas)

    def replica_count(self) -> int:
        return len(self._replicas)

    def drop(self, oid: ObjectID, announce: bool = False) -> None:
        """Forget (and unlink) a cached replica — the canonical object was
        freed, or the cache evicted it."""
        local = self._replicas.pop(oid, None)
        if local is None:
            return
        self._replica_bytes -= local.size
        store = self.get_store()
        if store is not None:
            try:
                store.free(local)
            except Exception:
                pass
        if announce and self.on_replica_gone is not None:
            self.on_replica_gone(oid)

    def _note_replica(self, local: ObjectMeta) -> None:
        old = self._replicas.pop(local.object_id, None)
        if old is not None:
            self._replica_bytes -= old.size
        self._replicas[local.object_id] = local
        self._replica_bytes += local.size
        while self._replica_bytes > self.cache_bytes and len(self._replicas) > 1:
            evict_oid = next(iter(self._replicas))
            self.drop(evict_oid, announce=True)
        if old is None and self.on_replica is not None:
            self.on_replica(local)

    # -------------------------------------------------------------- pulls
    async def pull(self, meta: ObjectMeta,
                   sources: Optional[List[Tuple[str, int]]] = None
                   ) -> ObjectMeta:
        """Produce a locally-readable meta for `meta`, pulling at most
        once per object id regardless of concurrent callers."""
        oid = meta.object_id
        local = self.cached(oid)
        if local is not None:
            return local
        task = self._tasks.get(oid)
        if task is None:
            task = asyncio.ensure_future(self._pull_once(meta, sources))
            self._tasks[oid] = task
            task.add_done_callback(
                lambda t, o=oid: self._tasks.pop(o, None))
        return await asyncio.shield(task)

    async def _conn_to(self, addr: Tuple[str, int]) -> protocol.Connection:
        conn = self._conns.get(addr)
        if conn is not None and not conn.closed:
            return conn
        # connect-once per address: a cold burst of concurrent pulls to
        # one source must share a single connection attempt, not race N
        # connects and leak the N-1 that lose the dict write
        pending = self._connecting.get(addr)
        if pending is None:
            pending = asyncio.ensure_future(protocol.connect(
                addr[0], addr[1], name=f"data-{addr[1]}"))
            self._connecting[addr] = pending
            pending.add_done_callback(
                lambda t, a=addr: self._connecting.pop(a, None))
        conn = await asyncio.shield(pending)
        self._conns[addr] = conn
        return conn

    async def _pull_once(self, meta: ObjectMeta,
                         sources: Optional[List[Tuple[str, int]]]
                         ) -> ObjectMeta:
        store = self.get_store()
        if store is None:
            raise FileNotFoundError("store not initialized")
        candidates = [tuple(s) for s in sources or ()]
        if not candidates and self.resolve is not None:
            candidates = [tuple(s) for s in await self.resolve(meta) or ()]
        if not candidates:
            raise FileNotFoundError(
                f"object {meta.object_id} has no known source")
        from ray_tpu_torch.util import tracing

        with tracing.start_span(
                "object_pull",
                attributes={"ray_tpu.op": "object_pull",
                            "object_id": meta.object_id.hex()[:16],
                            "size": meta.size, "via": self.role}):
            return await self._pull_candidates(meta, store, candidates,
                                               sources)

    async def _pull_candidates(self, meta, store, candidates, sources):
        last_exc: Optional[BaseException] = None
        t0 = time.perf_counter()
        resolved_extra = False
        i = -1
        while i + 1 < len(candidates):
            i += 1
            addr = candidates[i]
            if i:
                self.stats["object_pull_failovers"] += 1
                _get_metrics()["retries"].inc(tags={"role": self.role})
            try:
                conn = await self._conn_to(addr)
                async with self._sem:  # pull admission control
                    local = await pull_object(conn, meta, store,
                                              role=self.role)
            except (protocol.RpcError, OSError, FileNotFoundError) as e:
                last_exc = e
                if (i + 1 == len(candidates) and sources
                        and not resolved_extra and self.resolve is not None):
                    # every caller-hinted source failed (stale view, node
                    # moved): one resolver pass may know fresher replicas
                    resolved_extra = True
                    for s in await self.resolve(meta) or ():
                        if tuple(s) not in candidates:
                            candidates.append(tuple(s))
                continue
            elapsed = time.perf_counter() - t0
            m = _get_metrics()
            m["bytes"].inc(local.size, tags={"role": self.role})
            m["pulls"].inc(tags={"role": self.role})
            m["seconds"].observe(elapsed, tags={"role": self.role})
            self.stats["object_pulls"] += 1
            self.stats["object_pull_bytes"] += local.size
            self._note_replica(local)
            return local
        raise last_exc if last_exc is not None else FileNotFoundError(
            f"object {meta.object_id} unreachable")

    async def close(self) -> None:
        for conn in list(self._conns.values()):
            try:
                await conn.close()
            except Exception:
                pass
        self._conns.clear()
