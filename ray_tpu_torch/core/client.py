"""CoreClient: the per-process runtime embedded in drivers and workers.

Capability-equivalent of the reference's core worker
(`src/ray/core_worker/core_worker.h:168`) Python-side: task submission,
object put/get/wait, actor calls over direct worker<->worker connections,
blocked/unblocked notifications to the scheduler. The asyncio loop runs in a
background thread; the public API is synchronous (like `ray.get`).

Counterpart of `ray_tpu/core/client.py`. A torch tensor put or returned
here travels as host bytes (`serialization`); a device object
(`put_device`, an actor method with `tensor_transport="device"`) stays in
its owner's device store (`device_store`) and reaches other processes as a
shm snapshot
(`device_transport`) or, between members of one collective gang, over the
gang's own transport (NCCL on the card).
"""

from __future__ import annotations

import asyncio
import concurrent.futures as _cf
import functools
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from collections import OrderedDict, deque

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.core import object_transfer, protocol, refcount, serialization
from ray_tpu_torch.core.exceptions import (ActorDiedError, GetTimeoutError,
                                     ObjectLostError, RayTpuError,
                                     WorkerCrashedError)
from ray_tpu_torch.core.function_manager import FunctionManager
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.store import INLINE_THRESHOLD, ObjectMeta, SharedMemoryStore
from ray_tpu_torch.core.serialization import SerializedObject
from ray_tpu_torch.util import tracing as _tracing

ARGS_INLINE_LIMIT = 512 * 1024  # args bigger than this go through the store


class _Lease:
    """A worker granted to this client for direct task pushes. `via` is
    the granting node daemon's scheduler address (two-level path) or None
    when the head granted it — releases route back to the granter."""

    __slots__ = ("worker_id", "addr", "inflight", "last_used", "dead", "via",
                 "acquire_mode")

    def __init__(self, worker_id: WorkerID, addr: Tuple[str, int],
                 via: Optional[Tuple[str, int]] = None):
        self.worker_id = worker_id
        self.addr = addr
        self.inflight = 0
        self.last_used = time.monotonic()
        self.dead = False
        self.via = via
        self.acquire_mode = None  # flight recorder: local|spillback|head


class CoreClient:
    def __init__(self, head_host: str, head_port: int, session: str,
                 is_driver: bool, handlers: Optional[dict] = None):
        self.head_host, self.head_port = head_host, head_port
        self.session = session
        self.is_driver = is_driver
        self.worker_id = WorkerID.generate()
        # capacity enforcement/spill is the head's job; client stores only
        # create/attach segments
        self.store = SharedMemoryStore(session, capacity_bytes=1 << 62)
        self.local_metas: Dict[ObjectID, ObjectMeta] = {}
        self._registered: set = set()     # object ids known to head
        self.fn_manager = FunctionManager(self)
        from ray_tpu_torch.core.device_store import DeviceObjectStore

        self.device_store = DeviceObjectStore()
        self._extra_handlers = dict(handlers or {})
        # head liveness probes (answered on the client's loop thread, so a
        # blocked user thread doesn't read as dead)
        self._extra_handlers.setdefault("health_ping", self._on_health_ping)
        self._extra_handlers.setdefault("pubsub", self._on_pubsub)
        # head->process push when the directory drops one of our device
        # objects (refcount reached zero)
        self._extra_handlers.setdefault("free_device_object",
                                        self._on_free_device_object)
        self._extra_handlers.setdefault("evicted_object",
                                        self._on_evicted_object)
        self._extra_handlers.setdefault("lease_revoke",
                                        self._on_lease_revoke_msg)
        # cooperative stack dump (the reference dashboard's py-spy
        # reporter, without needing ptrace): every process answers with
        # the live stacks of all its threads
        self._extra_handlers.setdefault("dump_stacks", self._on_dump_stacks)
        if is_driver:
            # streamed worker-log lines (task/actor prints) land at the
            # submitting terminal by default (reference print_logs)
            self._extra_handlers.setdefault("log_lines", self._on_log_lines)
        self._direct: Dict[Tuple[str, int], protocol.Connection] = {}
        self._actor_addr_cache: Dict[ActorID, Tuple[str, int]] = {}
        # compiled-DAG channels hosted by THIS process (created via the
        # dag_chan_create direct RPC); plus the serving-side read pool
        self._dag_channels: Dict[str, Any] = {}
        self._dag_read_pool = None
        # user pubsub subscriptions: channel -> [callback]
        self._pubsub_callbacks: Dict[str, list] = {}
        # post-reconnect hooks (pool_reconcile pattern for client-held
        # state): after a successful head reconnect each callback runs
        # once so publishers re-announce state the restarted head lost
        # (e.g. prefix-store pin tables). Fired on the loop thread —
        # callbacks must be non-blocking (pushes, not round trips).
        self._reconnect_callbacks: list = []
        self.loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(target=self._run_loop, daemon=True,
                                             name="ray_tpu-client-loop")
        self.conn: Optional[protocol.Connection] = None
        self.direct_server: Optional[protocol.Server] = None
        self.direct_port: Optional[int] = None
        self.node_info: dict = {}
        self.current_actor_id: Optional[ActorID] = None  # set when hosting an actor
        # in-flight actor calls: return ObjectID -> concurrent Future of reply
        self._pending_calls: Dict[ObjectID, Any] = {}
        self._pending_lock = threading.Lock()
        self._actor_order_locks: Dict[ActorID, asyncio.Lock] = {}
        # per-actor count of live fallback sends (loop-confined): while
        # nonzero, fast-path sends must queue behind them for order
        self._fallbacks_pending: Dict[ActorID, int] = {}
        self._started = threading.Event()
        self._blocked_depth = 0
        self._blocked_lock = threading.Lock()
        self.node_id: Optional[NodeID] = None
        # head-restart survival (reference GCS-client reconnect): bounded
        # reconnect window; 0 restores die-on-disconnect behavior.
        # last_reconnect_ts lets recovery-aware paths (fn_manager.load)
        # treat misses right after a restart as transient.
        self._reconnect_s = _config.get("reconnect_timeout_s")
        self.last_reconnect_ts = 0.0
        self._register_ts = 0.0  # when node_info (head_uptime_s) was taken
        self._closing = False
        self._connected = threading.Event()
        self._connected.set()
        # head-scheduled submissions not yet observed complete, keyed by
        # first return id: a restarted head lost its queue, so these are
        # replayed on reconnect (client-side re-queue; bounded FIFO)
        self._inflight_specs: "OrderedDict[ObjectID, dict]" = OrderedDict()
        self._inflight_lock = threading.Lock()
        # cross-node pull machinery (loop-confined): data-server conns,
        # in-flight pull dedup, LRU-bounded cache of pulled copies
        self._data_conns: Dict[Tuple[str, int], protocol.Connection] = {}
        self._pull_tasks: Dict[ObjectID, asyncio.Task] = {}
        # owner-side staged host snapshots of device objects + in-flight
        # staging dedup (freed with the device object)
        self._device_snapshots: Dict[ObjectID, ObjectMeta] = {}
        self._staging: Dict[ObjectID, asyncio.Future] = {}
        self._conn_opening: Dict[Tuple[str, int], asyncio.Future] = {}
        # worker leases for direct task pushes (reference
        # NormalTaskSubmitter lease reuse): shape key -> _Lease
        self._leases: Dict[tuple, "_Lease"] = {}
        self._draining: list = []  # revoked leases with in-flight pushes
        self._lease_acquiring: set = set()
        self._lease_lock = threading.Lock()
        self._lease_idle_s = _config.get("lease_idle_s")
        self._lease_reaper_started = False
        # two-level scheduling: head-pushed cluster resource view + cached
        # connections to node-daemon schedulers; grants via a daemon never
        # touch the head (stats observable for tests/diagnostics)
        from ray_tpu_torch.core.resource_view import ClusterView

        self.cluster_view = ClusterView()
        # gossiped object directory: location announcements piggybacked on
        # cluster_view pushes — a warm get() of a remote object resolves
        # meta + serving node from cache, zero head RPCs
        # (core/object_directory.py)
        from ray_tpu_torch.core.object_directory import ObjectDirectory

        self.object_dir = ObjectDirectory()
        # metas of copies the LOCAL node's pull manager fetched for us
        # (daemon/head data server `pull_object`): the node owns the
        # replica's lifetime, so these are plain pointers, never freed by
        # this process (unlike _pulled, whose copies are ours to unlink)
        self._daemon_pulled: "OrderedDict[ObjectID, ObjectMeta]" = OrderedDict()
        data_port = os.environ.get("RAY_TPU_NODE_DATA_PORT")
        self._node_data_addr = (("127.0.0.1", int(data_port))
                                if data_port else None)
        self._sched_conns: Dict[Tuple[str, int], protocol.Connection] = {}
        self.lease_stats = {"daemon_grants": 0, "head_grants": 0,
                            "spills": 0, "peer_grants": 0}
        # headless resilience: cold-path tasks park in per-shape local
        # dispatch queues while the head is unreachable/suspect and drain
        # through daemon/peer-granted leases — the head stops being a
        # required hop on the cold task path. `_head_suspect_until` is
        # armed when a head lease RPC times out with the connection still
        # "open" (a paused head keeps TCP alive).
        self._lease_parked: Dict[tuple, deque] = {}
        self._lease_parked_ts: Dict[tuple, float] = {}
        self._parked_exec_tasks: set = set()
        self._head_suspect_until = 0.0
        # epoch fencing: the cluster epoch observed from the head
        # (registration reply + cluster_view pushes); lease traffic to
        # node-daemon schedulers is tagged with it, and a daemon that has
        # reconciled with a newer head refuses the stale-epoch grant
        self.cluster_epoch = 0
        # flight recorder, driver side: scheduling-phase events for traced
        # tasks (submit → lease-acquire[mode] → dispatch → run) consumed by
        # ray_tpu.timeline(); recorded only while tracing is enabled, so
        # the untraced hot path pays one boolean check
        self.sched_events: "deque[dict]" = deque(
            maxlen=_config.get("flight_recorder_head_events"))
        self._pull_sem: Optional[asyncio.Semaphore] = None
        self._pulled: "OrderedDict[ObjectID, ObjectMeta]" = OrderedDict()
        self._pulled_lock = threading.Lock()  # loop inserts, user threads free
        self._pulled_bytes = 0
        self._pull_cache_cap = _config.get("pull_cache_bytes")
        self.on_disconnect = None
        # invoked synchronously inside the start coroutine, right after the
        # head acks registration and before any pushed task handler can run
        self.on_registered = None
        # batched loop handoff: every call_soon_threadsafe pays a self-pipe
        # write to wake the loop; a pipelined burst (2000 actor calls) paid
        # it 2000 times. One queue + one scheduled drain per wakeup keeps
        # submission order (single FIFO) while collapsing the syscalls.
        self._loop_calls: deque = deque()
        self._loop_calls_lock = threading.Lock()
        self._loop_calls_scheduled = False

    # ----------------------------------------------------------- lifecycle
    def _run_loop(self):
        asyncio.set_event_loop(self.loop)
        protocol.enable_eager_tasks(self.loop)
        self.loop.run_forever()

    async def _on_free_device_object(self, object_id):
        oid = ObjectID(object_id)
        self.device_store.pop(oid)
        snap = self._device_snapshots.pop(oid, None)
        if snap is not None:
            # the staged host copy dies with the value. Its arena entry is
            # deleted here, pins and all: no ref is left, so no consumer is
            # between its fetch and its copy-out (the JAX package only
            # drops its own pin, and the snapshot stays in the arena)
            try:
                self.store.delete_unregistered(snap)
            except Exception:
                pass
        return True

    async def _on_health_ping(self):
        return True

    # ------------------------------------------- compiled-DAG channel plane
    # Reference: remote-reader mutable objects
    # (`python/ray/experimental/channel/shared_memory_channel.py`,
    # `src/ray/core_worker/experimental_mutable_object_provider.cc`) — a
    # channel lives in its WRITER's process; cross-node readers read
    # through these RPCs on the writer process's direct server.

    async def _on_dag_chan_create(self, name, capacity, num_readers,
                                  num_slots=1):
        from ray_tpu_torch.dag.channel import Channel

        if name not in self._dag_channels:
            ch = Channel(name=name, capacity=capacity,
                         num_readers=num_readers, num_slots=num_slots)
            ch._rlock = threading.Lock()
            self._dag_channels[name] = ch
        return True

    async def _on_dag_chan_read(self, name, last_seq, max_wait):
        from ray_tpu_torch.dag.channel import Channel, ChannelClosedError

        ch = self._dag_channels.get(name)
        if ch is None:
            # a reader of a channel another local process created (the
            # driver co-located with a worker): serve from an attachment
            try:
                ch = Channel.attach(name)
            except Exception:
                return {"closed": True}
            ch._rlock = threading.Lock()
            self._dag_channels[name] = ch
        if self._dag_read_pool is None:
            self._dag_read_pool = _cf.ThreadPoolExecutor(
                max_workers=16, thread_name_prefix="dag-read")

        def blocking():
            # one read at a time per channel: the cursor is the caller's,
            # but a close must not unmap under a read in flight
            with ch._rlock:
                try:
                    seq, data = ch.read_raw(last_seq, timeout=max_wait)
                    return {"seq": seq, "data": data}
                except TimeoutError:
                    return {"seq": last_seq, "data": None}
                except ChannelClosedError:
                    return {"closed": True}

        return await asyncio.get_running_loop().run_in_executor(
            self._dag_read_pool, blocking)

    async def _on_dag_chan_close(self, name, unlink):
        ch = self._dag_channels.pop(name, None)
        if ch is not None:
            # shutdown first: wakes any read blocked in the pool (new
            # ops see closed); the munmap-ing close then runs under the
            # read lock OFF the event loop, so it can never pull the
            # mapping out from under an in-flight blocking() read
            ch.shutdown()

            def _close():
                with ch._rlock:
                    ch.close(unlink=unlink)

            if self._dag_read_pool is not None:
                self._dag_read_pool.submit(_close)
            else:
                _close()
        return True

    async def _on_pubsub(self, channel, msg):
        """Head pubsub fan-in. actor_state transitions poison stale direct
        connections: when the head declares an actor's worker dead while
        its SOCKET is still open (hung process reaped by health checks),
        in-flight direct calls would otherwise wait on a frozen peer
        forever — closing the connection fails them into the resend path,
        which re-resolves the restarted actor's address (reference:
        ActorTaskSubmitter's GCS actor-state subscription)."""
        if channel == "cluster_view":
            self.cluster_view.adopt(msg)
            self.cluster_epoch = msg.get("epoch", self.cluster_epoch)
            self.object_dir.apply(msg.get("objects"))
        if channel == "actor_state" and msg.get("state") in ("RESTARTING",
                                                             "DEAD"):
            aid = ActorID(msg["actor_id"])
            addr = self._actor_addr_cache.pop(aid, None)
            if addr is not None:
                conn = self._direct.pop(addr, None)
                if conn is not None and not conn.closed:
                    asyncio.ensure_future(conn.close())
        # snapshot: subscribers add/remove from other threads (the train
        # controller's death watch); mutating the live list mid-iteration
        # would skip a neighbor's callback for this event
        for cb in list(self._pubsub_callbacks.get(channel, ())):
            try:
                cb(msg)
            except Exception:
                pass   # a user callback must never break the loop
        return True

    def subscribe_channel(self, channel: str, callback) -> None:
        """Public pubsub: `callback(msg_dict)` for every event the head
        publishes on `channel` (node_state / actor_state / object_state;
        reference `src/ray/pubsub/` channels). Callbacks run on the
        client's loop thread — hand off, don't block."""
        # empty list counts as first too: unsubscribe_channel leaves the
        # key behind, and a restarted head has no subscriber table — a
        # re-arm after disarm must re-issue the subscribe RPC (it is
        # idempotent head-side)
        first = not self._pubsub_callbacks.get(channel)
        self._pubsub_callbacks.setdefault(channel, []).append(callback)
        if first and channel != "actor_state":   # actor_state: always subbed
            self._wait_connected()
            self._call(self.conn.request("subscribe", channel=channel))

    def unsubscribe_channel(self, channel: str, callback) -> None:
        """Drop a `subscribe_channel` callback. The head-side channel
        subscription stays (it is per-connection and cheap); only the
        local fan-out entry is removed — callers that re-arm per worker
        group (the train controller's death watch) don't accumulate
        dead callbacks across restarts."""
        cbs = self._pubsub_callbacks.get(channel)
        if cbs and callback in cbs:
            cbs.remove(callback)

    async def _on_dump_stacks(self):
        """Formatted stacks of every thread in this process (reference:
        dashboard reporter's py-spy dump, done cooperatively)."""
        import traceback

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        out = []
        for ident, frame in frames.items():
            out.append(f"--- thread {names.get(ident, '?')} ({ident})")
            out.extend(l.rstrip() for l in traceback.format_stack(frame))
        return "\n".join(out)

    async def _on_log_lines(self, entries):
        """Head-streamed worker log lines: print at this driver."""
        from ray_tpu_torch.core import worker_logs

        worker_logs.print_driver_entries(entries)
        return True

    def _note_complete(self, oid: ObjectID) -> None:
        """A task's result meta was observed: its spec no longer needs
        head-restart replay."""
        if self._inflight_specs:
            with self._inflight_lock:
                self._inflight_specs.pop(oid, None)

    async def _on_evicted_object(self, meta):
        """Head evicted an object we own: drop our mapping, accounting and
        caches (auto-eviction must clean the producer like manual free())."""
        oid = meta.object_id
        self._note_complete(oid)
        self.local_metas.pop(oid, None)
        self._registered.discard(oid)
        pulled = self._drop_pulled(oid)
        for m in (pulled, meta):
            if m is None:
                continue
            try:
                self.store.free(m)
            except Exception:
                pass
        return True

    async def _on_fetch_device_object(self, object_id):
        """Another process wants a device object we own: stage a host
        snapshot into node shm (once, in an executor thread: a multi-GB
        device-to-host copy must not stall this loop) and reply with its
        tiny meta. The consumer maps the shm directly (same node) or pulls
        it through the chunked data plane (cross node); the bulk bytes
        never ride this control connection (reference: accelerator tensor
        channel, torch_tensor_accelerator_channel.py)."""
        oid = ObjectID(object_id)
        try:
            value = self.device_store.get(oid)
        except KeyError:
            raise FileNotFoundError(f"device object {oid} not here") from None
        meta = self._device_snapshots.get(oid)
        if meta is None:
            task = self._staging.get(oid)
            if task is None:  # concurrent fetchers share one staging
                task = asyncio.ensure_future(
                    self._stage_device_object(oid, value))
                if not task.done():
                    self._staging[oid] = task
            meta = await asyncio.shield(task)
            if not self.device_store.contains(oid):
                # freed after the staging recorded the snapshot: the free
                # handler released it
                raise FileNotFoundError(f"device object {oid} freed")
        return {"meta": meta}

    async def _stage_device_object(self, oid: ObjectID, value):
        """Stage one snapshot of a device object in an executor thread and
        record it. The record and the end of the staging entry happen in
        one step of this loop, so no fetch sees neither (a fetch between
        the two would stage a second snapshot)."""
        from ray_tpu_torch.core import device_transport

        try:
            meta = await asyncio.get_running_loop().run_in_executor(
                None, device_transport.stage_snapshot, self, oid, value)
            if not self.device_store.contains(oid):
                # freed while we were staging: the free handler saw no
                # snapshot entry, so the snapshot is released here or the
                # shm leaks
                try:
                    self.store.delete_unregistered(meta)
                except Exception as e:
                    print(f"[ray_tpu_torch] freeing orphan snapshot of "
                          f"{oid.hex()[:12]} failed: {e!r}",
                          file=sys.stderr, flush=True)
                raise FileNotFoundError(f"device object {oid} freed")
            self._device_snapshots[oid] = meta
            return meta
        finally:
            self._staging.pop(oid, None)

    @staticmethod
    def _device_groups() -> dict:
        """This process's collective groups that can carry device leaves
        (`DistCollectiveGroup`s: NCCL or gloo), by name. Empty when the
        collective layer was never imported (no group, and no torch)."""
        col = sys.modules.get("ray_tpu_torch.util.collective.collective")
        if col is None:
            return {}
        return {name: g for name, g in list(col._groups.items())
                if getattr(g, "device_plane", False)}

    async def _on_fetch_device_ici(self, object_id, group_name, dst_rank):
        """Gang-member fetch: a peer of one of our collective groups wants
        this device object. Ship the tree's skeleton over this control
        connection and every tensor leaf on the group's device over the
        group itself (NCCL send/recv between cards, gloo on the CPU), never
        through host pickle. None when we are not in that group (the
        consumer falls back to the snapshot route)."""
        oid = ObjectID(object_id)
        try:
            value = self.device_store.get(oid)
        except KeyError:
            raise FileNotFoundError(f"device object {oid} not here") from None
        group = self._device_groups().get(group_name)
        if group is None:
            return None
        import torch
        from torch.utils import _pytree

        from ray_tpu_torch.core import device_transport as dt

        leaves, spec = _pytree.tree_flatten(value)
        descs, skeleton_leaves, dev_leaves = [], [], []
        for leaf in leaves:
            if (isinstance(leaf, torch.Tensor)
                    and leaf.device.type == group.device.type):
                leaf = leaf.detach().contiguous()
                descs.append({"shape": tuple(leaf.shape),
                              "dtype": str(leaf.dtype)[len("torch."):]})
                skeleton_leaves.append(dt.IciLeaf(len(descs) - 1))
                dev_leaves.append(leaf)
            else:
                skeleton_leaves.append(leaf)
        skeleton = _pytree.tree_unflatten(skeleton_leaves, spec)

        def _send_all():
            if _config.get("testing_ici_drop_send"):
                return  # chaos hook: reply sent, transfer never happens
            for leaf in dev_leaves:
                group.send_device(leaf, dst_rank)

        # sends run concurrently with the consumer's recvs (each blocks
        # until both peers join); never on this loop. A failed send leaves
        # the consumer blocked in its recv until its own deadline; the
        # failure must at least be loud on the owner.
        fut = asyncio.get_running_loop().run_in_executor(None, _send_all)

        def _log_failure(f):
            exc = f.exception()
            if exc is not None:
                print(f"[ray_tpu_torch] gang send of {oid.hex()[:12]} to "
                      f"rank {dst_rank} failed: {exc!r}", file=sys.stderr,
                      flush=True)

        fut.add_done_callback(_log_failure)
        return {"skeleton": serialization.dumps(skeleton), "descs": descs}

    def _try_ici_fetch(self, meta: ObjectMeta) -> Optional[Any]:
        """Device-plane get() between gang members: when the owner and we
        are both members of one collective group, leaves ride the group
        (NCCL between cards) instead of a host-staged snapshot. Returns
        None when the route does not apply (the caller falls back to the
        snapshot)."""
        if meta.owner is None:
            return None
        mine = self._device_groups()
        if not mine:
            return None
        from ray_tpu_torch.util.collective.dist_group import lookup_worker

        info = lookup_worker(self, meta.owner.hex())
        if not info or info.get("group") not in mine:
            return None
        group = mine[info["group"]]
        src = info["rank"]
        if src == group.rank:
            return None
        rep = self._call(self._direct_owner_request(
            meta, "fetch_device_ici", object_id=meta.object_id.binary(),
            group_name=info["group"], dst_rank=group.rank))
        if rep is None:
            return None
        import torch
        from torch.utils import _pytree

        from ray_tpu_torch.core import device_transport as dt

        def _recv_all():
            out = [group.recv_device(tuple(d["shape"]),
                                     getattr(torch, d["dtype"]), src)
                   for d in rep["descs"]]
            if group.device.type == "cuda":
                torch.cuda.current_stream(group.device).synchronize()
            return out

        # a recv blocks until the peer sends: a peer that died between its
        # reply and its send would hang this get() forever. Bound it with a
        # DAEMON thread: on timeout the consumer surfaces ObjectLostError
        # while the recv thread stays parked (the group is poisoned, as a
        # dead NCCL communicator would be); daemon, so a parked thread never
        # blocks interpreter exit.
        timeout_s = _config.get("ici_fetch_timeout_s")
        box: dict = {}
        done = threading.Event()

        def _runner():
            try:
                box["v"] = _recv_all()
            except BaseException as e:  # noqa: BLE001 - marshalled to caller
                box["e"] = e
            finally:
                done.set()

        threading.Thread(target=_runner, daemon=True,
                         name="gang-recv").start()
        if not done.wait(timeout_s):
            raise ObjectLostError(
                f"device object {meta.object_id}: gang peer rank {src} "
                f"never sent within {timeout_s}s (owner crashed "
                f"mid-handoff?); group {info['group']!r} may be poisoned")
        if "e" in box:
            raise box["e"]
        received = box["v"]
        skeleton = serialization.loads(bytes(rep["skeleton"]))
        return _pytree.tree_map(
            lambda x: received[x.index] if isinstance(x, dt.IciLeaf) else x,
            skeleton)

    def start(self, direct_handlers: Optional[dict] = None) -> None:
        direct_handlers = dict(direct_handlers or {})
        direct_handlers.setdefault("fetch_device_object",
                                   self._on_fetch_device_object)
        direct_handlers.setdefault("fetch_device_ici",
                                   self._on_fetch_device_ici)
        # compiled-DAG channel plane (process-level, independent of the
        # actor executor — teardown works even while an exec loop runs)
        direct_handlers.setdefault("dag_chan_create", self._on_dag_chan_create)
        direct_handlers.setdefault("dag_chan_read", self._on_dag_chan_read)
        direct_handlers.setdefault("dag_chan_close", self._on_dag_chan_close)
        # tracker active BEFORE the loop can dispatch anything: a task or
        # actor __init__ processed during registration may construct
        # ObjectRefs, and every one of them must be counted (else the head
        # never records this process as a holder and evicts early)
        self.ref_tracker = refcount.RefTracker(self)
        refcount.activate(self.ref_tracker)
        from ray_tpu_torch.core import flight_recorder

        flight_recorder.install("driver" if self.is_driver else "worker")
        self._loop_thread.start()
        fut = asyncio.run_coroutine_threadsafe(
            self._start_async(direct_handlers or {}), self.loop)
        fut.result(timeout=30)
        # refcounting on/off is the HEAD's setting, distributed at
        # registration — per-process env vars can't diverge into a head
        # that evicts objects a non-reporting process still holds
        self.ref_tracker.set_enabled(self.node_info.get("refcount", True))
        self._started.set()

    async def _start_async(self, direct_handlers: dict) -> None:
        self.direct_server = protocol.Server(direct_handlers, name="direct")
        self.direct_port = await self.direct_server.start(
            host=_config.get("bind_host"))
        self.conn = await protocol.connect(self.head_host, self.head_port,
                                           handlers=self._extra_handlers,
                                           name="head")
        self.conn.on_close = lambda c: self._handle_head_loss()
        node_id_hex = os.environ.get("RAY_TPU_NODE_ID")
        self.node_info = await self.conn.request(
            "register_worker", worker_id=self.worker_id.binary(), pid=os.getpid(),
            port=self.direct_port, is_driver=self.is_driver,
            node_id=bytes.fromhex(node_id_hex) if node_id_hex else None,
            log_tag=os.environ.get("RAY_TPU_LOG_TAG"),
            venv_key=os.environ.get("RAY_TPU_VENV_KEY"))
        # actor failover needs to hear about restarts it can't observe via
        # its own sockets (hung-worker reaping) — fire-and-forget so
        # registration latency doesn't grow. cluster_view feeds the local
        # feasible-node cache for two-level lease routing.
        asyncio.ensure_future(self.conn.request("subscribe",
                                                channel="actor_state"))
        asyncio.ensure_future(self.conn.request("subscribe",
                                                channel="cluster_view"))
        self.node_id = NodeID(self.node_info["node_id"])
        self.cluster_epoch = self.node_info.get("epoch", 0)
        self._register_ts = time.monotonic()
        # negotiated flags: the head's values are authoritative for
        # cluster-shared semantics (config.py registry)
        _config.GLOBAL.adopt_head(self.node_info.get("config"))
        if (self.store.isolated and not self.store.namespace
                and not _config.get("store_namespace")):
            # isolation mode: our namespace is our node's — knowable only
            # after registration (no objects have been stored yet)
            self.store = SharedMemoryStore(
                self.session, capacity_bytes=1 << 62,
                namespace=self.node_id.hex()[:8])
        if self.on_registered is not None:
            self.on_registered(self.node_info)
        if self.is_driver:
            # minimal runtime-env: ship the driver's import roots so workers
            # can resolve by-reference pickles of driver-local modules (the
            # reference solves this with runtime_env working_dir packaging)
            import json as _json
            import sys as _sys

            await self.conn.request(
                "kv_put", ns="cluster", key=b"driver_sys_path",
                value=_json.dumps(
                    [p for p in _sys.path if p]).encode(), overwrite=True)

    def _handle_head_loss(self):
        # Reconnect-with-backoff (reference retryable_grpc_client + GCS
        # client reconnect semantics): a restarted head gets this process
        # back — re-register, replay directory entries and ref holds —
        # instead of the whole cluster's clients dying with it.
        if self._closing or self._reconnect_s <= 0:
            if self.on_disconnect:
                self.on_disconnect()
            return
        if not self._connected.is_set():
            return  # a reconnect loop is already running
        self._connected.clear()
        asyncio.ensure_future(self._reconnect_loop())

    async def _reconnect_loop(self) -> None:
        deadline = time.monotonic() + self._reconnect_s
        delay = 0.2
        while not self._closing and time.monotonic() < deadline:
            try:
                conn = await protocol.connect(self.head_host, self.head_port,
                                              handlers=self._extra_handlers,
                                              name="head")
            except OSError:
                await asyncio.sleep(delay)
                delay = min(delay * 1.6, 2.0)
                continue
            node_id_hex = os.environ.get("RAY_TPU_NODE_ID")
            try:
                info = await conn.request(
                    "register_worker", worker_id=self.worker_id.binary(),
                    pid=os.getpid(), port=self.direct_port,
                    is_driver=self.is_driver,
                    node_id=(bytes.fromhex(node_id_hex)
                             if node_id_hex else None),
                    log_tag=os.environ.get("RAY_TPU_LOG_TAG"),
                    venv_key=os.environ.get("RAY_TPU_VENV_KEY"),
                    # a restarted head parks reconnecting workers until
                    # their node daemon's reconciliation handshake claims
                    # or disowns them (double-grant fence)
                    reconnect=True)
            except Exception:
                try:
                    await conn.close()
                except Exception:
                    pass
                await asyncio.sleep(delay)
                continue
            self.conn = conn
            self.node_info = info
            self.node_id = NodeID(info["node_id"])
            self.cluster_epoch = info.get("epoch", self.cluster_epoch)
            self._register_ts = time.monotonic()
            conn.on_close = lambda c: self._handle_head_loss()
            _config.GLOBAL.adopt_head(info.get("config"))
            # the restarted head has no subscriber table: re-subscribe —
            # including every channel live pubsub callbacks still watch
            # (the train controller's death watch rides node_state; losing
            # it across a head restart would silently downgrade death
            # detection to poll timeouts)
            channels = {"actor_state", "cluster_view"}
            channels.update(ch for ch, cbs in self._pubsub_callbacks.items()
                            if cbs)
            for ch in channels:
                asyncio.ensure_future(conn.request("subscribe", channel=ch))
            # enablement is the head's setting; the restarted head may
            # differ and a non-reporting client would see early evictions
            self.ref_tracker.set_enabled(info.get("refcount", True))
            # the restarted head lost our directory entries and holds:
            # replay every meta we registered, then re-announce live refs
            for oid in list(self._registered):
                meta = self.local_metas.get(oid)
                if meta is not None:
                    try:
                        conn.push("put_meta", meta=meta)
                    except Exception:
                        pass
            self.ref_tracker.resync()
            # function/class defs exported after the head's last snapshot
            # died with it; replayed tasks reference them by hash
            self.fn_manager.resync()
            self.last_reconnect_ts = time.monotonic()
            if self.is_driver:
                import json as _json
                import sys as _sys

                try:
                    await conn.request(
                        "kv_put", ns="cluster", key=b"driver_sys_path",
                        value=_json.dumps(
                            [p for p in _sys.path if p]).encode(),
                        overwrite=True)
                except Exception:
                    pass
            # leased workers likely died with the head; mark dead so the
            # next submit fails over through the (new) head
            with self._lease_lock:
                for lease in self._leases.values():
                    lease.dead = True
            # client-side task re-queue: the restarted head has no task
            # queue, and a push can die in the old socket's buffer — so
            # every submission not yet observed complete is replayed
            # (at-least-once for retryable tasks, like lease failover;
            # max_retries=0 tasks surface an error instead of re-running)
            with self._inflight_lock:
                pending = list(self._inflight_specs.items())
            for rid0, spec in pending:
                if rid0 in self.local_metas:
                    with self._inflight_lock:
                        self._inflight_specs.pop(rid0, None)
                    continue
                if spec.get("options", {}).get("max_retries", 3):
                    sp = dict(spec)
                    sp["failover"] = True  # skip the dup holder add
                    try:
                        conn.push("submit_task", spec=sp)
                    except Exception:
                        pass
                else:
                    err = WorkerCrashedError(
                        "head restarted while a max_retries=0 task was in "
                        "flight; it may or may not have run")
                    try:
                        self.store_result(rid0, err, register=True,
                                          is_error=True)
                    except Exception:
                        pass
                    with self._inflight_lock:
                        self._inflight_specs.pop(rid0, None)
            self._connected.set()
            for cb in list(self._reconnect_callbacks):
                try:
                    cb()
                except Exception:
                    pass
            return
        self._connected.set()  # unblock waiters into their errors
        if self.on_disconnect:
            self.on_disconnect()

    def add_reconnect_callback(self, cb) -> None:
        """Run `cb()` after every successful head reconnect (loop
        thread; must not block). Used by publishers whose head-side
        state is rebuilt from client truth — the prefix store re-pushes
        its pin-table bindings the way pool_reconcile re-reports pools."""
        if cb not in self._reconnect_callbacks:
            self._reconnect_callbacks.append(cb)

    def remove_reconnect_callback(self, cb) -> None:
        if cb in self._reconnect_callbacks:
            self._reconnect_callbacks.remove(cb)

    def head_recovering(self) -> bool:
        """True inside the window where a restarted head may still be
        re-learning state from reconnecting processes — misses (e.g. a
        function def) are plausibly transient and worth a brief poll."""
        if self.last_reconnect_ts and (
                time.monotonic() - self.last_reconnect_ts < 30.0):
            return True
        age = self.node_info.get("head_uptime_s")
        if age is None or not self._register_ts:
            return False
        # a FRESH process (never reconnected) registered to a young head:
        # e.g. a worker spawned right after a restart, whose driver's
        # re-exports may still be in flight
        return age + (time.monotonic() - self._register_ts) < 60.0

    def _wait_connected(self) -> None:
        """Block a sync API call while a reconnect is in progress (bounded
        by the reconnect window) so callers see a brief stall, not an
        immediate ConnectionLost, across a head restart."""
        if not self._connected.is_set():
            self._connected.wait(timeout=self._reconnect_s + 5)

    def shutdown(self) -> None:
        # final metrics flush BEFORE the connection closes: a short-lived
        # worker/driver otherwise silently loses its last
        # <metrics_push_interval_s of counter increments
        try:
            from ray_tpu_torch.util import metrics as _m

            _m.flush(wait=True)
        except Exception:
            pass
        self._closing = True
        refcount.activate(None)

        async def _close():
            if self.conn:
                await self.conn.close()
            for c in self._direct.values():
                await c.close()
            for c in self._data_conns.values():
                await c.close()
            for c in self._sched_conns.values():
                await c.close()
            if self.direct_server:
                await self.direct_server.stop()

        try:
            asyncio.run_coroutine_threadsafe(_close(), self.loop).result(timeout=5)
        except Exception:
            pass
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._loop_thread.join(timeout=5)

    # ---------------------------------------------------------------- sync
    def _call(self, coro, timeout=None):
        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout=timeout)

    def _loop_call_soon(self, fn, *args) -> None:
        """Thread-safe loop handoff with coalesced wakeups: enqueued
        callables run on the loop in enqueue order; only the first one
        after an idle period pays the self-pipe wakeup."""
        with self._loop_calls_lock:
            self._loop_calls.append((fn, args))
            if self._loop_calls_scheduled:
                return
            self._loop_calls_scheduled = True
        try:
            self.loop.call_soon_threadsafe(self._drain_loop_calls)
        except RuntimeError:
            # loop stopped/closed mid-shutdown: reset the flag so later
            # callers raise here too instead of parking behind a drain
            # that will never run (head_request would block forever)
            with self._loop_calls_lock:
                self._loop_calls_scheduled = False
            raise

    def _drain_loop_calls(self) -> None:
        while True:
            with self._loop_calls_lock:
                if not self._loop_calls:
                    self._loop_calls_scheduled = False
                    return
                batch = list(self._loop_calls)
                self._loop_calls.clear()
            for fn, args in batch:
                try:
                    fn(*args)
                except Exception as e:
                    print(f"[ray_tpu_torch] loop call {fn} failed: {e!r}",
                          file=sys.stderr, flush=True)

    def head_request(self, method: str, **kwargs) -> Any:
        """Blocking head RPC without per-call coroutine/Task overhead:
        the request is written by a plain loop callback and the reply
        future chains straight into a concurrent future (the same trick
        as _fast_actor_send — Task creation was a measurable slice of
        every control-plane round trip).

        Rides a head restart: a ConnectionLost inside the reconnect
        window retries on the re-established connection instead of
        surfacing into callers (a worker fetching a function blob
        mid-outage would otherwise poison its task's result with an
        infrastructure error the retry machinery never sees).

        A request that carries its own `timeout` gets its answer within
        that time and 5 s more, or raises TimeoutError: a paused head
        (SIGSTOP keeps its socket open) must not hold the caller past
        the timeout it asked for."""
        deadline = time.monotonic() + max(self._reconnect_s, 0.0) + 5.0
        within = kwargs.get("timeout")
        while True:
            self._wait_connected()
            cfut: _cf.Future = _cf.Future()
            conn = self.conn  # bind now: a reconnect must not swap mid-flight

            def _send(conn=conn, cfut=cfut):
                try:
                    fut = conn.request_future(method, **kwargs)
                except Exception as e:
                    if not cfut.cancelled():
                        cfut.set_exception(e)
                    return

                def _done(f):
                    if cfut.cancelled():
                        return
                    if f.cancelled():
                        cfut.cancel()
                    elif f.exception() is not None:
                        cfut.set_exception(f.exception())
                    else:
                        cfut.set_result(f.result())

                fut.add_done_callback(_done)

            self._loop_call_soon(_send)
            try:
                return cfut.result(
                    timeout=None if within is None else within + 5.0)
            except _cf.TimeoutError:
                cfut.cancel()  # a late answer is dropped
                raise
            except protocol.ConnectionLost:
                if (self._closing or self._reconnect_s <= 0
                        or time.monotonic() >= deadline
                        # a ConnectionLost while the conn is still open is
                        # synthetic (chaos injection): surface it — only a
                        # genuinely dead head rides the reconnect
                        or not conn.closed):
                    raise
                time.sleep(0.1)  # _handle_head_loss swaps self.conn

    def direct_request(self, addr, method: str, **kwargs) -> Any:
        """Synchronous RPC to another process's direct server (connection
        cached/shared with the actor-call path)."""
        self._wait_connected()

        async def go():
            addr_t = (addr[0], int(addr[1]))
            conn = self._direct.get(addr_t)
            if conn is None or conn.closed:
                conn = await protocol.connect(*addr_t,
                                              name=f"direct-{addr_t[1]}")
                self._direct[addr_t] = conn
            return await conn.request(method, **kwargs)

        return self._call(go())

    # ------------------------------------------------------------- objects
    def put(self, value: Any, owner: Optional[str] = None) -> ObjectRef:
        oid = ObjectID.generate()
        ser = serialization.serialize(value)
        meta = self.store.put_serialized(oid, ser)
        meta.node_id = self.node_id
        meta.owner = self.worker_id
        meta.contained = [o.binary() for o in ser.contained] or None
        self.local_metas[oid] = meta
        self._register_meta(meta)
        return ObjectRef(oid)

    def put_device(self, value: Any) -> ObjectRef:
        """Store a device-resident value (a CUDA tensor, or a tree holding
        them) in THIS process's device store; only the meta travels.
        Same-process get() returns the living object zero-copy;
        cross-process get() fetches a snapshot from us (reference RDT
        GPUObjectStore design)."""
        from ray_tpu_torch.core import device_store as ds

        oid = ObjectID.generate()
        size = self.device_store.put(oid, value)
        meta = ObjectMeta(oid, size, "device")
        meta.node_id = self.node_id
        meta.owner = self.worker_id
        meta.inline = None
        # whether the top level is a tensor ("torch"; the JAX package
        # writes "jax" for a jax.Array)
        meta.segment = "torch" if ds.is_device_value(value) else None
        self.local_metas[oid] = meta
        self._register_meta(meta)
        return ObjectRef(oid)

    def store_device_result(self, oid: ObjectID, value: Any) -> ObjectMeta:
        """Actor-method result kept on device (tensor_transport option).

        Registered with the head (unlike plain actor replies): the head's
        refcount-driven free is what releases the value from our device
        store; without it, every device result would pin device memory for
        the actor's lifetime."""
        from ray_tpu_torch.core import device_store as ds

        size = self.device_store.put(oid, value)
        meta = ObjectMeta(oid, size, "device")
        meta.node_id = self.node_id
        meta.owner = self.worker_id
        meta.segment = "torch" if ds.is_device_value(value) else None
        self.local_metas[oid] = meta
        # non-blocking registration: this runs on the loop for async actor
        # methods, where a blocking request would deadlock; the consumer
        # gets the meta from the reply, the head entry only drives lifetime
        self._registered.add(oid)
        self.head_push("put_meta", meta=meta)
        return meta

    def _get_device_value(self, meta: ObjectMeta) -> Any:
        """Resolve a kind=='device' meta: the living value when we own it;
        between gang members, leaves ride the group; otherwise a
        shm-snapshot read (zero-copy map same-node, chunked pull
        cross-node)."""
        oid = meta.object_id
        if self.device_store.contains(oid):
            return self.device_store.get(oid)
        ici = self._try_ici_fetch(meta)
        if ici is not None:
            return ici
        from ray_tpu_torch.core import device_transport

        snap = self._call(self._fetch_device_async(meta))["meta"]
        try:
            return device_transport.load_snapshot(self.read_serialized(snap))
        finally:
            self.store.release(snap)   # every leaf was copied out

    async def _direct_owner_request(self, meta: ObjectMeta, method: str,
                                    **kwargs):
        """RPC straight to the owning process's direct server."""
        addr = await self.conn.request("worker_address",
                                       worker_id=meta.owner.binary())
        if addr is None:
            raise ObjectLostError(
                f"device object {meta.object_id} lost: owner process gone")
        conn = await self._owner_conn(tuple(addr))
        return await conn.request(method, **kwargs)

    async def _owner_conn(self, key: Tuple[str, int]):
        """One connection per owner address, however many callers ask at
        once: the first opens it, the others await the same opening."""
        conn = self._data_conns.get(key)
        if conn is not None and not conn.closed:
            return conn
        task = self._conn_opening.get(key)
        if task is None:
            async def _open():
                try:
                    c = await protocol.connect(key[0], key[1],
                                               name=f"dev-{key[1]}")
                    self._data_conns[key] = c
                    return c
                finally:
                    self._conn_opening.pop(key, None)

            task = asyncio.ensure_future(_open())
            if not task.done():
                self._conn_opening[key] = task
        return await asyncio.shield(task)

    async def _fetch_device_async(self, meta: ObjectMeta):
        """Ask the owner to stage its snapshot; returns {"meta": snapshot
        meta}; the bytes travel separately over the data plane."""
        return await self._direct_owner_request(
            meta, "fetch_device_object", object_id=meta.object_id.binary())

    def put_serialized(self, ser: SerializedObject, error: bool = False,
                       register: bool = True) -> ObjectMeta:
        oid = ObjectID.generate()
        meta = self.store.put_serialized(oid, ser)
        meta.error = error
        meta.node_id = self.node_id
        meta.owner = self.worker_id
        meta.contained = [o.binary() for o in ser.contained] or None
        self.local_metas[oid] = meta
        if register:
            self._register_meta(meta)
        return meta

    def store_result(self, oid: ObjectID, value: Any, register: bool,
                     is_error: bool = False,
                     via_head: bool = False) -> ObjectMeta:
        """`via_head=True` promises the meta reaches the head on another
        channel (e.g. generator_yield seals it) — skip the extra push."""
        ser = serialization.serialize(value)
        meta = self.store.put_serialized(oid, ser)
        meta.error = is_error
        # node-stamped so a cross-node consumer of an UNregistered meta
        # (direct actor reply) can still find our node's data server
        meta.node_id = self.node_id
        meta.owner = self.worker_id
        meta.contained = [o.binary() for o in ser.contained] or None
        self.local_metas[oid] = meta
        if register:
            self._register_meta(meta)
        elif not via_head and (meta.contained or meta.kind != "inline"):
            # Two cases where a direct-reply result MUST still reach the
            # head. Embedded refs: the containment pin is what keeps the
            # inner objects alive once the producer drops its own refs.
            # Non-inline payloads: the bytes live in node storage (shm
            # arena / spill), and only a head directory entry lets the
            # consumer's eventual ref-drop free them — unregistered, the
            # dec writes a tombstone and the arena bytes leak forever.
            # Non-blocking push — this path runs on the loop for async
            # actor methods.
            self._registered.add(oid)
            self.head_push("put_meta", meta=meta)
        return meta

    def head_push(self, method: str, **kwargs) -> None:
        """Fire-and-forget message to the head, thread-safe. FIFO with
        every other message this client sends (incl. submit pushes), so
        registration-before-submit ordering is preserved without paying a
        blocking round trip."""
        self._loop_call_soon(
            functools.partial(self.conn.push, method, **kwargs))

    def _register_meta(self, meta: ObjectMeta) -> None:
        if meta.object_id in self._registered:
            return
        self._registered.add(meta.object_id)
        # push, not request: consumers that race ahead block in the head's
        # get_meta until this lands (same-connection FIFO per process)
        self.head_push("put_meta", meta=meta)

    def ensure_registered(self, ref: ObjectRef) -> None:
        if ref.id not in self.local_metas:
            # passing an in-flight actor-call result onward: join it first so
            # the head learns the object before anyone depends on it
            self._resolve_pending_call(ref.id)
        meta = self.local_metas.get(ref.id)
        if meta is not None and ref.id not in self._registered:
            self._registered.add(ref.id)
            # hold=True: the head counts this process as a holder at once.
            # Its own batched inc may still be in flight, and the consumer
            # we hand the ref to may inc and dec it first: the head would
            # then see no holder left and evict an object this process
            # still holds (the JAX package's client has that race). A
            # request, not a push: it rides a head restart
            self.head_request("put_meta", meta=meta, hold=True)

    def adopt_meta(self, meta: ObjectMeta) -> ObjectRef:
        """Record a meta received from a direct actor reply."""
        self.local_metas[meta.object_id] = meta
        return ObjectRef(meta.object_id)

    def read_serialized(self, meta: ObjectMeta) -> SerializedObject:
        """Serialized bytes of `meta`, pulling from the owner node when the
        object isn't local (sync; called from user threads)."""
        try:
            return self.store.get_serialized(meta)
        except FileNotFoundError:
            pass
        # retry: a resolved cached copy can be evicted by a concurrent
        # pull's cache trim between resolve and read — re-resolve re-pulls
        for attempt in range(3):
            local = self._call(self._resolve_readable(meta))
            try:
                return self.store.get_serialized(local)
            except FileNotFoundError:
                self._drop_pulled(meta.object_id)
        raise ObjectLostError(f"object {meta.object_id} vanished during read")

    async def read_serialized_async(self, meta: ObjectMeta) -> SerializedObject:
        """Event-loop-safe variant (sync one would deadlock on the loop)."""
        try:
            return self.store.get_serialized(meta)
        except FileNotFoundError:
            pass
        for attempt in range(3):
            local = await self._resolve_readable(meta)
            try:
                return self.store.get_serialized(local)
            except FileNotFoundError:
                self._drop_pulled(meta.object_id)
        raise ObjectLostError(f"object {meta.object_id} vanished during read")

    def _drop_pulled(self, oid: ObjectID):
        """Forget a pulled copy; returns its meta (caller frees storage).
        Node-pulled pointers are dropped too so a retry re-resolves
        through the node pull manager (which re-pulls if it evicted)."""
        self._daemon_pulled.pop(oid, None)
        with self._pulled_lock:
            stale = self._pulled.pop(oid, None)
            if stale is not None:
                self._pulled_bytes -= stale.size
        return stale

    async def _resolve_readable(self, meta: ObjectMeta) -> ObjectMeta:
        """Produce a locally-readable meta for an object we can't read:
        stale meta (spilled/moved) or an object living on another node.
        Runs on the loop; concurrent requests for one object share a pull."""
        oid = meta.object_id
        task = self._pull_tasks.get(oid)
        if task is None:
            task = asyncio.ensure_future(self._locate_or_pull(meta))
            self._pull_tasks[oid] = task
            task.add_done_callback(
                lambda t, o=oid: self._pull_tasks.pop(o, None))
        return await asyncio.shield(task)

    def _probe_readable(self, meta: ObjectMeta) -> bool:
        try:
            view, rel = self.store.get_raw(meta, 0, 0)
            view.release()
            if rel is not None:
                rel()
            return True
        except (FileNotFoundError, OSError):
            return False

    def _dep_metas(self, deps: list) -> list:
        """Metas of a task's non-inline deps that this process already
        holds (e.g. results of lease tasks it submitted) — shipped with
        the spec so the executing worker skips the per-dep get_meta."""
        from ray_tpu_torch.core.object_directory import PULLABLE_KINDS

        out = []
        for dep in deps:
            m = self.local_metas.get(ObjectID(dep))
            if m is not None and m.kind in PULLABLE_KINDS and not m.error:
                out.append(m)
        return out

    def lease_data_addr(self, fn_key: bytes, options: dict):
        """Data-server address of the node the current lease for this
        task shape lives on, or None — the push-side prefetch target for
        a pipeline stage's pending inputs. Resolved entirely from cache:
        the lease's granting-daemon sched address matched against the
        gossiped view entries."""
        shape = self._lease_shape(fn_key, options)
        with self._lease_lock:
            lease = self._leases.get(shape)
            via = None if lease is None or lease.dead else lease.via
        if via is None:
            return None
        via = tuple(via)
        for e in self.cluster_view.entries.values():
            sched = e.get("sched_addr")
            if sched is not None and tuple(sched) == via:
                addr = e.get("data_addr")
                return tuple(addr) if addr else None
        return None

    def prefetch_object(self, ref, addr) -> bool:
        """Fire-and-forget: ask the data server at `addr` (the node a
        consuming task will run on) to pull `ref`'s object into its node
        store ahead of dispatch, so the task's dependency fetch finds the
        bytes already local. The node PullManager's in-flight dedup
        merges this with the real fetch if they race. Best-effort by
        design — a lost prefetch only costs the overlap."""
        meta = self.local_metas.get(ref.id) if hasattr(ref, "id") else ref
        from ray_tpu_torch.core.object_directory import PULLABLE_KINDS

        if (meta is None or meta.kind not in PULLABLE_KINDS or meta.error
                or addr is None):
            return False
        if meta.node_id is not None and self.cluster_view.data_addr_of(
                meta.node_id.hex()) == tuple(addr):
            return False  # already home: nothing to stage

        async def _go():
            key = tuple(addr)
            try:
                conn = self._data_conns.get(key)
                if conn is None or conn.closed:
                    conn = await protocol.connect(key[0], key[1],
                                                  name=f"data-{key[1]}")
                    self._data_conns[key] = conn
                await asyncio.wait_for(
                    conn.request("pull_object", meta=meta, sources=None),
                    timeout=120 + meta.size / (4 << 20))
            except Exception:
                pass  # prefetch is advisory; the dispatch-time pull wins

        try:
            asyncio.run_coroutine_threadsafe(_go(), self.loop)
        except Exception:
            return False
        return True

    def _sources_from_view(self, meta: ObjectMeta) -> list:
        """Candidate data-server addresses resolved ENTIRELY from cache:
        the gossiped object directory's locations (primary first, then
        advertised replicas) mapped through the cluster view's data_addr
        entries — the warm path that keeps remote get() head-RPC-free."""
        from ray_tpu_torch.core.object_directory import resolve_addrs

        return resolve_addrs(self.object_dir, meta,
                             self.cluster_view.data_addr_of, self.head_host)

    async def _pull_via_node(self, meta: ObjectMeta,
                             sources: list) -> Optional[ObjectMeta]:
        """Ask the LOCAL node's pull manager (daemon, or the head's for
        head-node workers) to fetch the object into the node store: two
        workers on one node pulling the same remote object then cost one
        network crossing, not two. Returns None when no local manager is
        configured or the node-level pull failed (caller falls back to a
        direct pull)."""
        if self._node_data_addr is None \
                or not _config.get("node_pull_manager"):
            return None
        key = self._node_data_addr
        conn = self._data_conns.get(key)
        try:
            if conn is None or conn.closed:
                conn = await protocol.connect(key[0], key[1],
                                              name=f"data-{key[1]}")
                self._data_conns[key] = conn
            # size-aware bound: a multi-GB pull must not be abandoned at a
            # fixed wall time (the daemon would keep pulling while we
            # redundantly re-pull direct); assume a conservative 4 MiB/s
            # floor on top of a fixed grace. The trace carrier rides the
            # RPC so the daemon's pull span parents to the consuming
            # task's context.
            trace = _tracing.inject_context()
            with _tracing.start_span(
                    "object_pull",
                    attributes={"ray_tpu.op": "object_pull",
                                "object_id": meta.object_id.hex()[:16],
                                "size": meta.size, "via": "node"}):
                local = await asyncio.wait_for(
                    conn.request("pull_object", meta=meta, sources=sources,
                                 **({"trace": trace} if trace else {})),
                    timeout=120 + meta.size / (4 << 20))
        except (protocol.RpcError, OSError, asyncio.TimeoutError):
            return None
        if local is None or not self._probe_readable(local):
            return None
        self._daemon_pulled[local.object_id] = local
        while len(self._daemon_pulled) > 4096:  # metas only; node owns data
            self._daemon_pulled.popitem(last=False)
        return local

    async def _pull_from_cache(self, oid: ObjectID) -> Optional[ObjectMeta]:
        """One warm resolution attempt entirely from cache: gossiped
        directory meta + cluster-view addresses (node pull manager first,
        then direct pulls with replica failover). None when the cache
        cannot resolve the object — never a head RPC."""
        node_local = self._daemon_pulled.get(oid)
        if node_local is not None and self._probe_readable(node_local):
            return node_local
        fresh = self.object_dir.lookup_meta(oid)
        if fresh is None:
            return None
        self.local_metas[oid] = fresh
        if self._probe_readable(fresh):
            return fresh
        sources = self._sources_from_view(fresh)
        if sources or fresh.node_id is not None:
            local = await self._pull_via_node(fresh, sources)
            if local is not None:
                return local
        for addr in sources:
            try:
                return await self._pull_from(addr, fresh)
            except (protocol.RpcError, OSError, FileNotFoundError):
                continue
        return None

    async def _locate_or_pull(self, meta: ObjectMeta) -> ObjectMeta:
        oid = meta.object_id
        with self._pulled_lock:
            cached = self._pulled.get(oid)
            if cached is not None:
                self._pulled.move_to_end(oid)
        if cached is not None:
            return cached
        node_local = self._daemon_pulled.get(oid)
        if node_local is not None:
            if self._probe_readable(node_local):
                return node_local
            self._daemon_pulled.pop(oid, None)
        # warm path: fresh meta + serving nodes from the cached gossiped
        # directory, data addresses from the cached cluster view — no
        # head round trips at all
        fresh = self.object_dir.lookup_meta(oid)
        if fresh is not None:
            meta = fresh
            self.local_metas[oid] = fresh
            if self._probe_readable(fresh):
                return fresh  # e.g. retargeted spill file we can read
        sources = self._sources_from_view(meta)
        if sources or meta.node_id is not None:
            local = await self._pull_via_node(meta, sources)
            if local is not None:
                return local
        for addr in sources:  # direct pull with replica failover
            try:
                return await self._pull_from(addr, meta)
            except (protocol.RpcError, OSError, FileNotFoundError):
                continue  # node lost / object moved: next source or head
        if (not sources and meta.node_id is not None
                and meta.kind in ("shm", "arena", "spilled")
                and not self._head_suspect()):
            # meta names its node but the cached view doesn't know that
            # node's data server yet (cold driver): one head lookup
            try:
                addr = await asyncio.wait_for(
                    self.conn.request("node_data_addr",
                                      node_id=meta.node_id.binary()),
                    timeout=10.0)
            except (protocol.RpcError, OSError, asyncio.TimeoutError):
                addr = None
            if addr is not None:
                try:
                    return await self._pull_from(tuple(addr), meta)
                except (protocol.RpcError, OSError, FileNotFoundError):
                    pass
        # cold miss / all cached routes failed: the head directory is the
        # fallback — refreshed meta + every advertised source. The head
        # may be unreachable (outage) or unresponsive (paused), and this
        # shared pull task can be JOINED by get()s issued after the
        # gossiped directory learned the object — so between bounded head
        # attempts, re-consult the cached directory and serve from it the
        # moment it resolves: a cold miss must never block a now-warm hit
        # behind a head retry loop.
        # the deadline budgets FAILED attempts against a trusted head; a
        # suspect head (paused/reconnecting) pushes it out instead — a
        # transient control-plane outage must stall this get(), like the
        # unbounded request it replaces, not surface a spurious
        # ObjectLostError for an object that is merely unresolvable from
        # cache. A hard cap (reconnect window + slack) still bounds the
        # truly-dead-head case.
        deadline = time.monotonic() + 30.0
        hard_deadline = time.monotonic() + max(
            float(_config.get("reconnect_timeout_s")), 0.0) + 60.0
        last_exc: Optional[BaseException] = None
        while True:
            local = await self._pull_from_cache(oid)
            if local is not None:
                return local
            rep = None
            if not self._head_suspect():
                try:
                    # client-side bound outlasts the server-side get_meta
                    # wait, so it only fires against a head that stopped
                    # answering entirely (paused/hung)
                    rep = await asyncio.wait_for(
                        self.conn.request("locate_object",
                                          object_id=oid.binary(),
                                          timeout=30),
                        timeout=40.0)
                    break
                except (protocol.RpcError, OSError,
                        asyncio.TimeoutError) as e:
                    last_exc = e
            else:
                deadline = max(deadline, time.monotonic() + 10.0)
            if time.monotonic() >= min(deadline, hard_deadline):
                raise ObjectLostError(
                    f"object {oid} unresolvable: head unreachable and the "
                    f"cached directory has no serving copy "
                    f"({last_exc!r})") from last_exc
            await asyncio.sleep(0.2)
        if rep is None:
            raise ObjectLostError(f"object {oid} is gone")
        fresh = rep["meta"]
        self.local_metas[oid] = fresh
        if self._probe_readable(fresh):
            return fresh
        head_sources = [tuple(s) for s in (rep.get("sources")
                        or ([rep["data_addr"]] if rep.get("data_addr")
                            else []))]
        last_exc = None
        for addr in head_sources:
            try:
                return await self._pull_from(addr, fresh)
            except (protocol.RpcError, OSError, FileNotFoundError) as e:
                last_exc = e
        if last_exc is not None:
            raise ObjectLostError(
                f"object {oid} unreachable on {head_sources}: "
                f"{last_exc!r}") from last_exc
        raise ObjectLostError(f"object {oid} has no reachable location")

    async def _pull_from(self, addr, meta: ObjectMeta) -> ObjectMeta:
        host, port = addr
        if host is None:
            host = self.head_host  # head-node objects: reuse our head route
        key = (host, port)
        conn = self._data_conns.get(key)
        if conn is None or conn.closed:
            conn = await protocol.connect(host, port, name=f"data-{port}")
            self._data_conns[key] = conn
        if self._pull_sem is None:
            self._pull_sem = asyncio.Semaphore(int(os.environ.get(
                "RAY_TPU_MAX_CONCURRENT_PULLS", "4")))
        role = "driver" if self.is_driver else "worker"
        t0 = time.perf_counter()
        with _tracing.start_span(
                "object_pull",
                attributes={"ray_tpu.op": "object_pull",
                            "object_id": meta.object_id.hex()[:16],
                            "size": meta.size, "via": "direct"}):
            async with self._pull_sem:  # pull admission control
                local = await object_transfer.pull_object(
                    conn, meta, self.store, role=role)
        m = object_transfer._get_metrics()
        m["bytes"].inc(local.size, tags={"role": role})
        m["pulls"].inc(tags={"role": role})
        m["seconds"].observe(time.perf_counter() - t0, tags={"role": role})
        self._note_pulled(local)
        return local

    def _note_pulled(self, local: ObjectMeta) -> None:
        """LRU cache of pulled copies, bounded by RAY_TPU_PULL_CACHE_BYTES —
        evicted copies are unlinked (they are ours, unlike canonical
        objects, which only their owner node frees)."""
        evicted = []
        with self._pulled_lock:
            old = self._pulled.pop(local.object_id, None)
            if old is not None:
                self._pulled_bytes -= old.size
            self._pulled[local.object_id] = local
            self._pulled_bytes += local.size
            while (self._pulled_bytes > self._pull_cache_cap
                   and len(self._pulled) > 1):
                _, evict = self._pulled.popitem(last=False)
                self._pulled_bytes -= evict.size
                evicted.append(evict)
        for evict in evicted:
            try:
                self.store.free(evict)
            except Exception:
                pass

    def _read_value(self, meta: ObjectMeta) -> Any:
        if meta.kind == "device":
            return self._get_device_value(meta)
        return serialization.deserialize(self.read_serialized(meta))

    async def _read_value_async(self, meta: ObjectMeta) -> Any:
        if meta.kind == "device":
            oid = meta.object_id
            if self.device_store.contains(oid):
                return self.device_store.get(oid)
            from ray_tpu_torch.core import device_transport

            snap = (await self._fetch_device_async(meta))["meta"]
            try:
                return device_transport.load_snapshot(
                    await self.read_serialized_async(snap))
            finally:
                self.store.release(snap)   # every leaf was copied out
        return serialization.deserialize(
            await self.read_serialized_async(meta))

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        out = []
        self._set_blocked(True)
        try:
            for ref in refs:
                meta = self.local_metas.get(ref.id)
                if meta is None:
                    remaining = None if deadline is None else max(0.0, deadline - time.monotonic())
                    if self._resolve_pending_call(ref.id, timeout=remaining):
                        meta = self.local_metas[ref.id]
                    else:
                        # gossiped directory first: a sealed remote object
                        # we never held a meta for resolves from cache —
                        # the head only sees genuinely cold misses
                        meta = self.object_dir.lookup_meta(ref.id)
                        if meta is None:
                            try:
                                meta = self.head_request(
                                    "get_meta", object_id=ref.id.binary(),
                                    timeout=remaining)
                            except _cf.TimeoutError:
                                meta = None  # the head did not answer
                    if meta is None:
                        raise GetTimeoutError(f"get timed out on {ref}")
                    self.local_metas[ref.id] = meta
                self._note_complete(ref.id)
                value = self._read_value(meta)
                if meta.error or isinstance(value, RayTpuError):
                    raise value
                out.append(value)
            return out
        finally:
            self._set_blocked(False)

    async def get_async(self, refs: Sequence[ObjectRef]) -> Any:
        out = []
        for ref in refs:
            meta = self.local_metas.get(ref.id)
            if meta is None:
                with self._pending_lock:
                    cfut = self._pending_calls.get(ref.id)
                if cfut is not None:
                    meta = (await asyncio.wrap_future(cfut))["meta"]
                    with self._pending_lock:
                        self._pending_calls.pop(ref.id, None)
                if cfut is None or meta is None:
                    # no pending call, or a lease failover resubmitted the
                    # task through the head: cached gossiped directory
                    # first, head get_meta as the cold-miss fallback
                    meta = self.object_dir.lookup_meta(ref.id)
                    if meta is None:
                        meta = await self.conn.request(
                            "get_meta", object_id=ref.id.binary(),
                            timeout=None)
                self.local_metas[ref.id] = meta
            self._note_complete(ref.id)
            value = await self._read_value_async(meta)
            if meta.error or isinstance(value, RayTpuError):
                raise value
            out.append(value)
        return out[0] if len(out) == 1 else out

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        num_returns = min(num_returns, len(refs))
        deadline = None if timeout is None else time.monotonic() + timeout
        ready_set: set = set()

        def check_local(r: ObjectRef) -> bool:
            if r.id in self.local_metas:
                return True
            with self._pending_lock:
                cfut = self._pending_calls.get(r.id)
            if cfut is None or not cfut.done():
                return False
            # a finished-but-failed call counts as ready (get surfaces it);
            # a lease failover (None meta) is NOT ready — the resubmitted
            # task resolves through the head directory instead
            try:
                if cfut.result()["meta"] is None:
                    with self._pending_lock:
                        self._pending_calls.pop(r.id, None)
                    return False
            except BaseException:
                pass
            return True

        # Event-driven (a loop that polled the head every 50 ms whenever
        # actor calls were in flight was too slow): BOTH readiness
        # sources — in-flight actor-call futures and a head-side
        # wait_objects — wake one shared event. The head request runs in
        # bounded chunks so an abandoned server-side wait never lingers
        # unboundedly after we return.
        wake = threading.Event()
        hooked: set = set()
        head_errors = 0  # consecutive wait_objects failures

        def _hook(f):
            if id(f) not in hooked:
                hooked.add(id(f))
                f.add_done_callback(lambda _f: wake.set())

        while True:
            ready_set.update(r for r in refs if check_local(r))
            if len(ready_set) >= num_returns:
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            wake.clear()
            head_refs = []
            for r in refs:
                if r in ready_set:
                    continue
                with self._pending_lock:
                    cfut = self._pending_calls.get(r.id)
                if cfut is not None and not cfut.done():
                    _hook(cfut)
                else:
                    head_refs.append(r)
            if head_refs:
                step = 2.0 if remaining is None else min(2.0, remaining)
                hfut = asyncio.run_coroutine_threadsafe(
                    self.conn.request(
                        "wait_objects",
                        object_ids=[r.id.binary() for r in head_refs],
                        num_returns=num_returns - len(ready_set),
                        timeout=step), self.loop)
                hfut.add_done_callback(lambda _f: wake.set())
                wake.wait(step + 1.0)
                if hfut.done():
                    try:
                        ready_set.update(head_refs[i] for i in hfut.result())
                        head_errors = 0
                    except (protocol.ConnectionLost, protocol.RpcError,
                            OSError):
                        # transient during a head-restart window: stall
                        # until reconnected; persistent failure must
                        # RAISE, not spin at network rate forever
                        self._wait_connected()
                        head_errors += 1
                        if (head_errors >= 3
                                or self.conn is None or self.conn.closed):
                            raise
                    except Exception:
                        head_errors += 1
                        if head_errors >= 3:
                            raise
                else:
                    # an actor call woke us first: stop the head wait (the
                    # late reply lands on a cancelled future, a no-op)
                    hfut.cancel()
            else:
                wake.wait(remaining)
        ready = [r for r in refs if r in ready_set][:num_returns]
        ready_final = set(ready)
        return ready, [r for r in refs if r not in ready_final]

    def _is_pending_call(self, oid: ObjectID) -> bool:
        with self._pending_lock:
            cfut = self._pending_calls.get(oid)
        return cfut is not None and not cfut.done()

    def add_done_callback(self, ref: ObjectRef, cb) -> None:
        """Invoke cb() once the in-flight actor call behind `ref` completes
        (immediately if already resolved). Client-side routing bookkeeping
        (Serve router) relies on this."""
        with self._pending_lock:
            cfut = self._pending_calls.get(ref.id)
        if cfut is None:
            cb()
        else:
            cfut.add_done_callback(lambda f: cb())

    def free(self, refs: Sequence[ObjectRef]) -> None:
        for r in refs:
            with self._pending_lock:
                self._pending_calls.pop(r.id, None)
            meta = self.local_metas.pop(r.id, None)
            self._registered.discard(r.id)
            if meta is not None:
                self.store.release(meta)  # drop our mapping; head unlinks
            pulled = self._drop_pulled(r.id)
            if pulled is not None:
                try:
                    self.store.free(pulled)  # our cached copy: unlink it
                except Exception:
                    pass
        self._call(self.conn.request(
            "free_objects", object_ids=[r.id.binary() for r in refs]))

    def _set_blocked(self, value: bool) -> None:
        if self.is_driver or self.conn is None:
            return
        with self._blocked_lock:
            self._blocked_depth += 1 if value else -1
            depth = self._blocked_depth
        if (value and depth == 1) or (not value and depth == 0):
            # push, not round trip: the head's handler is fire-and-forget
            # (flip the flag, release the CPU, kick the scheduler) and
            # pushes keep same-connection FIFO ordering — waiting for the
            # ack bought nothing but two head round trips on EVERY
            # worker-side blocking get (warm paths must stay head-free)
            try:
                self.head_push("blocked", value=value)
            except Exception:
                pass

    # --------------------------------------------------------------- tasks
    _empty_payload_bytes: Optional[bytes] = None

    def build_args_payload(self, args: tuple, kwargs: dict):
        """Top-level ObjectRef args become deps (resolved at execution, like
        the reference); refs NESTED anywhere in the arguments are collected
        during pickling and pinned as deps too; everything ships
        serialized."""
        if not args and not kwargs:
            # zero-arg calls (the actor-call hot path) serialize to the
            # same constant bytes every time — skip the pickler entirely
            blob = CoreClient._empty_payload_bytes
            if blob is None:
                blob = CoreClient._empty_payload_bytes = \
                    serialization.serialize(((), {})).to_bytes()
            return {"inline": blob}, [], []
        deps = []
        seen = set()
        for a in list(args) + list(kwargs.values()):
            if isinstance(a, ObjectRef):
                self.ensure_registered(a)
                deps.append(a.id.binary())
                seen.add(a.id)
        ser = serialization.serialize((args, kwargs))
        for oid in ser.contained:
            if oid not in seen:
                seen.add(oid)
                self.ensure_registered(ObjectRef(oid))
                deps.append(oid.binary())
        if ser.total_bytes <= ARGS_INLINE_LIMIT:
            return {"inline": ser.to_bytes()}, deps, ser.borrow_tokens
        meta = self.put_serialized(ser)
        return {"meta": meta}, deps, ser.borrow_tokens

    def release_borrows(self, tokens) -> None:
        """Sender-side release of borrow pins for a payload that will
        provably never be deserialized (terminally failed call). Idempotent
        against a racing receiver commit."""
        for oid, token in tokens or []:
            self.ref_tracker.borrow_commit(oid, token)

    # ------------------------------------------------------------- leases
    @staticmethod
    def _sched_tracing() -> bool:
        return _tracing.is_enabled()

    def _sched_event(self, phase: str, *, task_id=None, name=None, mode=None,
                     t0=None, t1=None, **detail) -> None:
        """Record one scheduling-phase event (flight recorder, driver
        side). Only called behind a _sched_tracing() check."""
        self.sched_events.append({
            "phase": phase,
            "task_id": task_id.hex() if hasattr(task_id, "hex") else task_id,
            "name": name, "mode": mode, "t0": t0, "t1": t1, **detail})

    @staticmethod
    def _lease_shape(fn_key: bytes, options: dict) -> tuple:
        res = options.get("resources") or {"CPU": 1}
        sel = options.get("label_selector")
        sel_key = (tuple(sorted(
            (k, tuple(v) if isinstance(v, (list, tuple, set)) else str(v))
            for k, v in sel.items())) if sel else None)
        return (fn_key, tuple(sorted(res.items())), sel_key)

    @staticmethod
    def _lease_eligible(options: dict, num_returns) -> bool:
        """Direct pushes cover the common shapes (label selectors
        included — grants are selector-checked by the granting scheduler);
        anything needing the head's placement machinery (PGs, streaming,
        runtime envs) takes the scheduled path."""
        return (num_returns == 1
                and options.get("num_returns") != "streaming"
                and not options.get("placement_group")
                and not options.get("runtime_env")
                and options.get("scheduling_strategy", "hybrid") == "hybrid")

    def _pick_lease_node(self, options: dict) -> Optional[dict]:
        """Feasible-node selection against the head-pushed cluster view:
        a node-daemon scheduler that can grant without the head."""
        if not _config.get("node_local_sched") or not self.cluster_view.entries:
            return None
        return self.cluster_view.select_node(
            options.get("resources") or {"CPU": 1},
            options.get("label_selector"))

    def _on_sched_conn_close(self, addr: Tuple[str, int]) -> None:
        """The granting daemon's scheduler connection died: every lease it
        granted is void THERE (the daemon reclaims on disconnect), so it
        must die HERE too — otherwise the daemon re-grants the worker to
        another client while we keep pushing to it (double lease)."""
        with self._lease_lock:
            for shape, lease in list(self._leases.items()):
                if lease.via == addr:
                    lease.dead = True
                    del self._leases[shape]

    async def _daemon_lease_grant(self, entry: dict, options: dict,
                                  referred=None) -> Optional[dict]:
        """Ask the chosen node daemon for a lease; None = spill to head
        (infeasible there, stale view, or the daemon is unreachable).
        A reply carrying "peers" is a peer referral — the daemon's pool
        missed but its cached view names peer daemons with warm idle
        workers; the caller completes the grant there. `referred` marks
        a request that IS such a completion (the peer grants warm-pool
        only, never cascading)."""
        addr = tuple(entry["sched_addr"])
        conn = None
        try:
            conn = self._sched_conns.get(addr)
            if conn is None or conn.closed:
                conn = await protocol.connect(addr[0], addr[1],
                                              name=f"sched-{addr[1]}")
                conn.on_close = lambda c, a=addr: self._on_sched_conn_close(a)
                self._sched_conns[addr] = conn
                if conn.closed:  # closed before on_close was attached
                    self._on_sched_conn_close(addr)
                    return None
            rep = await asyncio.wait_for(
                conn.request(
                    "lease_grant",
                    resources=options.get("resources") or {"CPU": 1},
                    label_selector=options.get("label_selector"),
                    venv_key=(options.get("runtime_env") or {}).get("pip_key"),
                    epoch=self.cluster_epoch or None,
                    referred=referred),
                timeout=10.0)
        except asyncio.TimeoutError:
            # the daemon may still complete this grant after we give up —
            # the only way to reconcile without request ids is to close
            # the scheduler session: the daemon returns everything it
            # granted on it, and _on_sched_conn_close voids our side
            if conn is not None:
                self._sched_conns.pop(addr, None)
                asyncio.ensure_future(conn.close())
            return None
        except (protocol.RpcError, OSError):
            return None
        if not rep or rep.get("spill"):
            if rep and rep.get("peers") and not referred:
                return rep  # peer referral: caller follows it
            self.lease_stats["spills"] += 1
            return None
        return rep

    def _head_suspect(self) -> bool:
        """True while the head cannot be counted on to answer: the
        connection is down/re-forming, or a recent head RPC timed out
        with the socket still "open" (a SIGSTOPped head keeps TCP alive
        — liveness is judged by answers, not by the connection)."""
        return (not self._connected.is_set() or self.conn is None
                or self.conn.closed
                or time.monotonic() < self._head_suspect_until)

    def _only_pool_capacity(self, options: dict) -> bool:
        """True when the cached view says this shape can ONLY be served
        by warm daemon pools: no feasible node has ledger-free capacity.
        Pushing such a task onto the head queue would starve it until a
        pool release returns capacity (the pools hold the whole ledger),
        so the local dispatch queue + lease path is strictly better —
        the head could not have parallelized it anyway."""
        if not _config.get("node_local_sched") \
                or not self.cluster_view.entries:
            return False
        from ray_tpu_torch.core.resource_view import fits, matches_labels

        res = options.get("resources") or {"CPU": 1}
        sel = options.get("label_selector")
        saw_pool = False
        for e in self.cluster_view.entries.values():
            if not matches_labels(e.get("labels") or {}, sel):
                continue
            if not fits(e.get("total") or {}, res):
                continue
            if fits(e.get("free") or {}, res):
                return False  # the head can dispatch this somewhere
            if e.get("idle_workers") and e.get("sched_addr"):
                saw_pool = True
        return saw_pool

    def _maybe_acquire_lease(self, shape: tuple, options: dict) -> None:
        """Fire-and-forget lease acquisition — never blocks a submit.

        Warm path: the cached cluster view names a feasible node daemon
        and the grant is node-local (zero head involvement). A daemon
        whose pool misses may answer with a peer REFERRAL — peer daemons
        whose gossiped pools show warm idle workers; the grant completes
        there (mode "peer", epoch-fenced by the peer) with zero head
        RPCs. Spillback to the head's acquire_lease only on label miss,
        infeasibility, or when the mesh has no warm capacity — and not
        at all while the head is suspect (parked cold tasks retry the
        mesh instead)."""
        with self._lease_lock:
            if shape in self._leases or shape in self._lease_acquiring:
                return
            self._lease_acquiring.add(shape)

        async def _acquire():
            traced = self._sched_tracing()
            t0 = time.time() if traced else 0.0
            mode = None
            acquired = False
            try:
                rep, via = None, None
                entry = self._pick_lease_node(options)
                if entry is not None:
                    rep = await self._daemon_lease_grant(entry, options)
                    if rep is not None and rep.get("peers"):
                        # peer referral: the chosen daemon's pool missed,
                        # but its cached view names warm peers — complete
                        # the grant there (one hop, no cascading)
                        referral, rep = rep, None
                        for p in referral["peers"]:
                            prep = await self._daemon_lease_grant(
                                {"sched_addr": p["sched_addr"]}, options,
                                referred=entry["node_id"])
                            if prep is not None and not prep.get("peers"):
                                rep = prep
                                via = tuple(p["sched_addr"])
                                self.lease_stats["daemon_grants"] += 1
                                self.lease_stats["peer_grants"] += 1
                                mode = "peer"
                                break
                    elif rep is not None:
                        via = tuple(entry["sched_addr"])
                        self.lease_stats["daemon_grants"] += 1
                        mode = "local"
                if rep is None:
                    # spillback: a daemon refused (stale view/labels/full)
                    # or no feasible view node existed — the head grants,
                    # unless it is suspect (closed, reconnecting, or
                    # recently unresponsive): then fail the attempt and
                    # let the parked-task retry loop re-try the mesh
                    mode = "spillback" if entry is not None else "head"
                    if not self._head_suspect():
                        try:
                            hfut = self.conn.request_future(
                                "acquire_lease", options=options)
                        except Exception:
                            hfut = None
                        try:
                            if hfut is not None:
                                rep = await asyncio.wait_for(
                                    asyncio.shield(hfut), timeout=15.0)
                        except (protocol.RpcError, OSError):
                            rep = None
                        except asyncio.TimeoutError:
                            # the socket is open but the head is not
                            # answering (paused/hung): reroute cold tasks
                            # through the peer mesh for a while. A LATE
                            # grant is handed straight back (the head
                            # debited a worker for a requester that gave
                            # up — releasing it is the leak fence).
                            rep = None
                            self._head_suspect_until = \
                                time.monotonic() + 10.0

                            def _late(f):
                                if f.cancelled() or f.exception():
                                    return
                                r = f.result()
                                if r:
                                    try:
                                        self.conn.push(
                                            "release_lease",
                                            worker_id=r["worker_id"])
                                    except Exception:
                                        pass

                            hfut.add_done_callback(_late)
                    if rep is not None:
                        self.lease_stats["head_grants"] += 1
                if rep is not None:
                    lease = _Lease(WorkerID(rep["worker_id"]),
                                   tuple(rep["addr"]), via=via)
                    if traced:
                        lease.acquire_mode = mode
                        with _tracing.start_span(
                                "lease_acquire",
                                attributes={"ray_tpu.op": "lease_acquire",
                                            "mode": mode}) as sp:
                            if sp is not None:
                                sp.start_ts = t0
                        self._sched_event(
                            "lease-acquire", mode=mode, t0=t0,
                            t1=time.time(),
                            worker=lease.worker_id.hex()[:12])
                    with self._lease_lock:
                        self._leases[shape] = lease
                    acquired = True
                    self._start_lease_reaper()
                elif traced:
                    self._sched_event("lease-acquire", mode=mode or "none",
                                      t0=t0, t1=time.time(), failed=True)
            finally:
                with self._lease_lock:
                    self._lease_acquiring.discard(shape)
            self._settle_parked(shape, options, acquired)

        asyncio.run_coroutine_threadsafe(_acquire(), self.loop)

    def _park_for_lease(self, shape: tuple, options: dict, spec: dict,
                        return_id: ObjectID):
        """Park a cold-path task in the local per-shape dispatch queue
        while the head is suspect: it dispatches through the daemon/peer
        lease once one lands instead of riding the head queue. Returns
        True (parked), False (queue full — caller falls back to the head
        path), or "retry" (a lease landed concurrently — caller submits
        through it)."""
        cap = int(_config.get("lease_park_max"))
        cfut: _cf.Future = _cf.Future()
        with self._lease_lock:
            lease = self._leases.get(shape)
            if lease is not None and not lease.dead:
                return "retry"
            q = self._lease_parked.setdefault(shape, deque())
            if len(q) >= cap:
                return False
            q.append((spec, cfut))
            self._lease_parked_ts.setdefault(shape, time.monotonic())
        with self._pending_lock:
            self._pending_calls[return_id] = cfut
        pins = [ObjectRef(ObjectID(b)) for b in spec["deps"]]

        def _on_done(f, _pins=pins):
            _pins.clear()
            try:
                meta = f.result()["meta"]
            except BaseException:
                return
            if meta is not None:
                self.local_metas[meta.object_id] = meta

        cfut.add_done_callback(_on_done)
        self._maybe_acquire_lease(shape, options)
        return True

    def _settle_parked(self, shape: tuple, options: dict,
                       acquired: bool) -> None:
        """After a lease acquisition attempt: drain this shape's parked
        tasks through the fresh lease, or — with no lease — re-try the
        mesh shortly while the head stays suspect, falling back to the
        head queue the moment it is trusted again. Runs on the loop."""
        items = []
        lease = None
        with self._lease_lock:
            q = self._lease_parked.get(shape)
            if not q:
                self._lease_parked.pop(shape, None)
                self._lease_parked_ts.pop(shape, None)
                return
            if acquired:
                lease = self._leases.get(shape)
                if lease is not None and not lease.dead:
                    items = list(q)
                    q.clear()
                    self._lease_parked.pop(shape, None)
                    self._lease_parked_ts.pop(shape, None)
                    lease.inflight += len(items)
                    lease.last_used = time.monotonic()
                else:
                    lease = None
        if lease is not None:
            for spec, cfut in items:
                task = asyncio.ensure_future(
                    self._lease_exec_async(lease, spec))
                # STRONG reference until done: asyncio tracks tasks
                # weakly, and a drained exec task whose only ref was this
                # loop variable was observed garbage-collected mid-flight
                # (its coroutine turned up "already awaited")
                self._parked_exec_tasks.add(task)
                task.add_done_callback(self._parked_exec_tasks.discard)

                def _chain(t, _cfut=cfut):
                    if _cfut.cancelled():
                        return
                    if t.cancelled():
                        _cfut.cancel()
                    elif t.exception() is not None:
                        _cfut.set_exception(t.exception())
                    else:
                        _cfut.set_result(t.result())

                task.add_done_callback(_chain)
            return
        parked_age = time.monotonic() - self._lease_parked_ts.get(
            shape, time.monotonic())
        if self._head_suspect() or (self._only_pool_capacity(options)
                                    and parked_age < 2.0):
            # no lease and no usable head queue (unreachable, or the
            # pools hold the whole ledger): keep the tasks parked and
            # re-try the mesh — the daemon pools / referral candidates
            # are re-read from the cached view each attempt, and a pool
            # release flips the view back to head-drainable. Pool-held
            # parking is age-bounded: a shape the pools can't actually
            # serve (wrong size/venv) must reach the HEAD queue, where
            # the pool_trim reclaim loop can free capacity for it —
            # parked tasks are invisible to that loop.
            self.loop.call_later(
                0.5, lambda: self._maybe_acquire_lease(shape, options))
            return
        # head is trusted again: the parked tasks take the classic head
        # path (push + at-least-once inflight tracking); their parked
        # futures resolve to the None-meta marker so get() falls through
        # to the head directory, exactly like a lease failover
        with self._lease_lock:
            q = self._lease_parked.pop(shape, None)
            self._lease_parked_ts.pop(shape, None)
            items = list(q) if q else []
        for spec, cfut in items:
            with self._inflight_lock:
                self._inflight_specs[ObjectID(spec["return_ids"][0])] = spec
                while len(self._inflight_specs) > 4096:
                    self._inflight_specs.popitem(last=False)
            try:
                self.conn.push("submit_task", spec=spec)
            except Exception:
                pass
            if not cfut.done():
                cfut.set_result({"meta": None})

    def _release_lease_now(self, lease: "_Lease") -> None:
        """Hand a lease back to whoever granted it (loop thread only)."""
        try:
            if lease.via is not None:
                conn = self._sched_conns.get(lease.via)
                if conn is not None and not conn.closed:
                    conn.push("lease_return",
                              worker_id=lease.worker_id.binary())
                # sched conn gone: the daemon reclaimed on disconnect
            else:
                self.conn.push("release_lease",
                               worker_id=lease.worker_id.binary())
        except Exception:
            pass

    def _start_lease_reaper(self) -> None:
        if self._lease_reaper_started:
            return
        self._lease_reaper_started = True

        def _reap():
            now = time.monotonic()
            dead = []
            with self._lease_lock:
                for shape, lease in list(self._leases.items()):
                    if (lease.dead or (lease.inflight == 0 and
                                       now - lease.last_used > self._lease_idle_s)):
                        dead.append((shape, lease))
                        del self._leases[shape]
            for shape, lease in dead:
                self._release_lease_now(lease)
            self.loop.call_later(max(self._lease_idle_s / 2, 0.25), _reap)

        self.loop.call_soon_threadsafe(
            lambda: self.loop.call_later(self._lease_idle_s, _reap))

    async def _on_lease_revoke_msg(self, worker_id):
        self._on_lease_revoke(worker_id)
        return True

    def _on_lease_revoke(self, worker_id: bytes) -> None:
        """Head wants the worker back. Stop submitting NOW, but only
        hand it back once in-flight pushes drain — releasing a busy
        worker would let the head queue new tasks behind ours, and if one
        of ours blocks on an object THOSE tasks produce, that's deadlock."""
        wid = WorkerID(worker_id)
        release_now = []
        with self._lease_lock:
            for shape, lease in list(self._leases.items()):
                if lease.worker_id == wid:
                    del self._leases[shape]
                    if lease.inflight == 0:
                        release_now.append(lease)
                    else:
                        lease.dead = True  # drain in _lease_exec_async
                        self._draining.append(lease)
        for lease in release_now:
            self._release_lease_now(lease)

    async def _lease_exec_async(self, lease: "_Lease", spec: dict):
        """Push one task to the leased worker; on a dead worker/lease the
        task is resubmitted through the head (same return ids — the head
        path seals them) and the pending-call resolves to a None meta so
        get() falls through to the head directory."""
        try:
            try:
                conn = self._direct.get(lease.addr)
                if conn is None or conn.closed:
                    conn = await protocol.connect(
                        *lease.addr, name=f"lease-{lease.addr[1]}")
                    self._direct[lease.addr] = conn
            except (ConnectionRefusedError, OSError):
                # connect-phase failure: the task was provably never sent,
                # so resubmitting through the head is safe for ANY retry
                # policy (no duplicate-execution risk)
                lease.dead = True
                spec["failover"] = True  # head skips the dup holder add
                self._track_failover(spec)
                self.conn.push("submit_task", spec=spec)
                return {"meta": None}
            if self._sched_tracing():
                t_dispatch = time.time()
                rep = await conn.request("lease_exec", spec=spec)
                t_reply = time.time()
                prof = rep.get("prof")
                opts = spec.get("options", {})
                tid = spec["task_id"]
                if prof:
                    # all phase timestamps stay in the DRIVER's clock: the
                    # worker reports only its run DURATION, anchored here
                    # to the reply arrival (cross-host wall clocks skew by
                    # NTP offsets, which would render out-of-order phases)
                    run_s = max(prof["end"] - prof["start"], 0.0)
                    t_run = max(t_reply - run_s, t_dispatch)
                    self._sched_event(
                        "dispatch", task_id=tid,
                        name=opts.get("name"), mode="lease",
                        t0=t_dispatch, t1=t_run,
                        worker=lease.worker_id.hex()[:12])
                    self._sched_event(
                        "run", task_id=tid, name=opts.get("name"),
                        mode="lease", t0=t_run, t1=t_reply,
                        worker=lease.worker_id.hex()[:12])
                else:
                    self._sched_event(
                        "dispatch", task_id=tid, name=opts.get("name"),
                        mode="lease", t0=t_dispatch, t1=t_reply,
                        worker=lease.worker_id.hex()[:12])
            else:
                rep = await conn.request("lease_exec", spec=spec)
            if rep.get("retired"):
                lease.dead = True
            return rep
        except (protocol.ConnectionLost, protocol.RpcError, OSError):
            lease.dead = True
            # The request was in flight: the worker may have executed the
            # task and only the reply was lost — resubmitting through the
            # head can run it twice, so the failover is gated on the
            # task's retry policy (reference NormalTaskSubmitter only
            # re-queues retryable tasks on worker death). Non-retryable
            # tasks surface a worker-died error.
            if spec.get("options", {}).get("max_retries", 3):
                spec["failover"] = True  # head skips the duplicate holder add
                self._track_failover(spec)
                self.conn.push("submit_task", spec=spec)
                return {"meta": None}
            rid = ObjectID(spec["return_ids"][0])
            # terminal failure: the head never sees this spec, so the
            # client must drop the borrow pins itself (idempotent vs a
            # racing worker commit)
            self.release_borrows(
                [(ObjectID(b), t) for b, t in spec.get("borrows", [])])
            err = WorkerCrashedError(
                f"leased worker {lease.worker_id.hex()[:12]} died executing "
                f"a task with max_retries=0; the task may or may not have "
                f"run")
            meta = self.store_result(rid, err, register=True, is_error=True)
            return {"meta": meta}
        finally:
            with self._lease_lock:
                # _try_lease_submit increments under this lock from user
                # threads; an unlocked decrement here can lose an update and
                # strand a positive count, leaking the leased worker
                lease.inflight -= 1
                lease.last_used = time.monotonic()
                release = (lease.dead and lease.inflight == 0
                           and lease in self._draining)
                if release:
                    # revoked mid-burst: last in-flight push done
                    self._draining.remove(lease)
            if release:
                self._release_lease_now(lease)

    def _track_failover(self, spec: dict) -> None:
        """Record a lease-failover resubmission for head-restart replay:
        the push may land in a dead head socket's buffer (the worker died
        WITH the head), and lease submits are not otherwise tracked — an
        untracked failover would lose the task forever."""
        with self._inflight_lock:
            self._inflight_specs[ObjectID(spec["return_ids"][0])] = spec
            while len(self._inflight_specs) > 4096:
                self._inflight_specs.popitem(last=False)

    def _try_lease_submit(self, fn_key, payload, deps, tokens, options,
                          task_id, return_id: ObjectID) -> bool:
        shape = self._lease_shape(fn_key, options)
        with self._lease_lock:
            lease = self._leases.get(shape)
            if lease is None or lease.dead:
                lease = None
            else:
                lease.inflight += 1
                lease.last_used = time.monotonic()
        if lease is None:
            self._maybe_acquire_lease(shape, options)
            return False
        spec = {"task_id": task_id, "fn_key": fn_key, "args": payload,
                "deps": deps, "return_ids": [return_id.binary()],
                "borrows": [(o.binary(), t) for o, t in tokens],
                "options": options}
        dep_metas = self._dep_metas(deps)
        if dep_metas:
            # ship the deps' metas with the push: the executing worker
            # resolves each block straight through its node PullManager
            # instead of round-tripping get_meta per dependency — the
            # warm inter-stage handoff of a data pipeline makes zero
            # head RPCs
            spec["dep_metas"] = dep_metas
        if options.get("lineage"):
            # out-of-band lineage registration: lease-path tasks never
            # reach the head's submit_task, so a data-stage task opts its
            # spec into the lineage ledger with one fire-and-forget push
            # (reconstruction re-runs it through the normal queue). The
            # recorded spec drops the borrow tokens (the live dispatch
            # below owns the handoff; a re-run must not re-commit them)
            # and the shipped dep metas (the head re-attaches FRESH ones
            # at reconstruction dispatch — recording these would pin
            # stale locations in the ledger).
            self.head_push(
                "record_lineage",
                spec={k: v for k, v in spec.items()
                      if k != "dep_metas"} | {"borrows": []})
        if self._head_suspect():
            # headless dispatch: the granted worker may never have run
            # this function, and its KV fetch would stall on the dead/
            # paused head — ship the definition with the spec
            blob = self.fn_manager.blob(fn_key)
            if blob is not None:
                spec["fn_blob"] = blob
        # caller-held pins keep deps alive until completion (the head is
        # not involved, so it cannot pin them — same as direct actor
        # calls); deps already includes the big-args payload object
        pins = [ObjectRef(ObjectID(b)) for b in deps]
        cfut = asyncio.run_coroutine_threadsafe(
            self._lease_exec_async(lease, spec), self.loop)
        with self._pending_lock:
            self._pending_calls[return_id] = cfut

        def _on_done(f, _pins=pins):
            _pins.clear()
            try:
                meta = f.result()["meta"]
            except BaseException:
                return
            if meta is not None:
                self.local_metas[meta.object_id] = meta

        cfut.add_done_callback(_on_done)
        return True

    def submit_task(self, fn_key: bytes, args: tuple, kwargs: dict,
                    options: dict, num_returns: int = 1) -> List[ObjectRef]:
        traced = self._sched_tracing()
        t_submit = time.time() if traced else 0.0
        payload, deps, tokens = self.build_args_payload(args, kwargs)
        if "meta" in payload:
            # the args payload object is itself pinned as a dep: the head
            # releases it at task completion, so big-args payloads stop
            # leaking and can't be evicted while the task is queued
            deps = deps + [payload["meta"].object_id.binary()]
        task_id = TaskID.generate()
        return_ids = [ObjectID.generate() for _ in range(num_returns)]
        if self._lease_eligible(options, num_returns):
            if self._try_lease_submit(fn_key, payload, deps, tokens,
                                      options, task_id, return_ids[0]):
                if traced:
                    self._sched_event("submit", task_id=task_id,
                                      name=options.get("name"), mode="lease",
                                      t0=t_submit, t1=time.time())
                return [ObjectRef(return_ids[0])]
            attempts = 0
            while (self._head_suspect()
                   or self._only_pool_capacity(options)) and attempts < 4:
                attempts += 1
                # cold path without a usable head queue: either the head
                # is unreachable (outage/pause), or every feasible node's
                # capacity lives in daemon pools (head-queueing would
                # starve until a pool release). Park the task in the
                # local per-shape dispatch queue; it drains through the
                # daemon/peer-granted lease once the acquisition lands
                spec = {"task_id": task_id, "fn_key": fn_key,
                        "args": payload, "deps": deps,
                        "return_ids": [return_ids[0].binary()],
                        "borrows": [(o.binary(), t) for o, t in tokens],
                        "options": options}
                blob = self.fn_manager.blob(fn_key)
                if blob is not None:
                    # definitions ride parked specs: the worker that
                    # eventually executes must not stall on a head KV
                    # fetch the outage makes impossible
                    spec["fn_blob"] = blob
                parked = self._park_for_lease(
                    self._lease_shape(fn_key, options), options, spec,
                    return_ids[0])
                if parked is True:
                    if traced:
                        self._sched_event(
                            "submit", task_id=task_id,
                            name=options.get("name"), mode="parked",
                            t0=t_submit, t1=time.time())
                    return [ObjectRef(return_ids[0])]
                if parked == "retry":
                    if self._try_lease_submit(fn_key, payload, deps,
                                              tokens, options, task_id,
                                              return_ids[0]):
                        return [ObjectRef(return_ids[0])]
                    continue
                break  # queue full: classic head path below
        spec = {"task_id": task_id, "fn_key": fn_key, "args": payload,
                "deps": deps, "return_ids": [o.binary() for o in return_ids],
                # head releases these if the task dies before any worker
                # deserializes the args (borrow pins must not leak)
                "borrows": [(o.binary(), t) for o, t in tokens],
                "options": options}
        # fire-and-forget: return ids are client-generated, so no reply is
        # needed — a blocking round trip here caps pipelined submission at
        # ~500 tasks/s; a push lets the socket batch thousands/s (head-side
        # submission failures seal error objects on the return ids)
        self._wait_connected()  # ride out a head restart, don't drop tasks
        if self.conn.closed:
            raise protocol.ConnectionLost("head connection closed")
        with self._inflight_lock:
            # retained until the result meta is observed; replayed to a
            # restarted head (which lost its queue AND any push that died
            # in the old socket's buffer)
            self._inflight_specs[return_ids[0]] = spec
            while len(self._inflight_specs) > 4096:
                self._inflight_specs.popitem(last=False)
        # bind the CURRENT conn: a reconnect between here and the loop
        # callback must not push into the dead connection object
        self._loop_call_soon(
            functools.partial(self.conn.push, "submit_task", spec=spec))
        if traced:
            self._sched_event("submit", task_id=task_id,
                              name=options.get("name"), mode="head",
                              t0=t_submit, t1=time.time())
        return [ObjectRef(o) for o in return_ids]

    # -------------------------------------------------------------- actors
    def create_actor(self, cls_key: bytes, args: tuple, kwargs: dict,
                     options: dict, methods: dict) -> ActorID:
        payload, deps, tokens = self.build_args_payload(args, kwargs)
        actor_id = ActorID.generate()
        spec = {"actor_id": actor_id.binary(), "cls_key": cls_key,
                "args": payload, "deps": deps, "options": options,
                "borrows": [(o.binary(), t) for o, t in tokens],
                "methods": methods}
        self._wait_connected()
        reply = self._call(self.conn.request("create_actor", spec=spec))
        return ActorID(reply["actor_id"])

    async def _actor_conn(self, actor_id: ActorID) -> protocol.Connection:
        addr = self._actor_addr_cache.get(actor_id)
        if addr is None:
            reply = await self.conn.request("get_actor_address",
                                            actor_id=actor_id.binary())
            if reply["state"] == "DEAD":
                raise ActorDiedError(reply.get("death_cause") or "actor died")
            addr = tuple(reply["address"])
            self._actor_addr_cache[actor_id] = addr
        conn = self._direct.get(addr)
        if conn is None or conn.closed:
            conn = await protocol.connect(addr[0], addr[1],
                                          name=f"actor-{addr[1]}")
            self._direct[addr] = conn
        return conn

    def _fast_actor_send(self, actor_id: ActorID, method: str, payload,
                         deps, return_id: bytes, group, cfut,
                         trace=None) -> None:
        """Loop-side send without coroutine overhead. Falls back to the
        retrying coroutine path on a cold/poisoned connection, and resends
        through it when a reply is lost to a dropped connection (the same
        at-least-once semantics the coroutine path has always had)."""
        if self._fallbacks_pending.get(actor_id):
            # a fallback send for this actor is still alive (created,
            # queued on, or inside its ordered section): overtaking it
            # would deliver calls out of program order — join the same
            # FIFO instead. The counter (not the lock state) is the
            # guard: a just-created fallback task holds no lock yet.
            self._fallback_actor_send(actor_id, method, payload, deps,
                                      return_id, group, cfut, trace)
            return
        addr = self._actor_addr_cache.get(actor_id)
        conn = self._direct.get(addr) if addr is not None else None
        if conn is None or conn.closed:
            self._fallback_actor_send(actor_id, method, payload, deps,
                                      return_id, group, cfut, trace)
            return
        try:
            kw = {"actor_id": actor_id.binary(), "method": method,
                  "args": payload, "deps": deps, "return_id": return_id,
                  "group": group}
            if trace is not None:
                kw["trace"] = trace
            fut = conn.request_future("actor_call", **kw)
        except Exception:
            self._fallback_actor_send(actor_id, method, payload, deps,
                                      return_id, group, cfut, trace)
            return

        def _done(f):
            exc = f.exception() if not f.cancelled() else None
            if isinstance(exc, (protocol.ConnectionLost,
                                ConnectionRefusedError, OSError)):
                # reply lost mid-flight: re-resolve + resend (actor may
                # have restarted elsewhere)
                self._actor_addr_cache.pop(actor_id, None)
                self._fallback_actor_send(actor_id, method, payload, deps,
                                          return_id, group, cfut, trace)
                return
            if cfut.cancelled():
                return
            if exc is not None:
                cfut.set_exception(exc)
            elif f.cancelled():
                cfut.cancel()
            else:
                cfut.set_result(f.result())

        fut.add_done_callback(_done)

    def _fallback_actor_send(self, actor_id, method, payload, deps,
                             return_id, group, cfut, trace=None) -> None:
        """Cold/failed path: run the full retrying coroutine, chain its
        outcome into the caller's concurrent future. The pending counter
        covers the task's whole lifetime (creation through completion) so
        the fast path can never slip between a fallback's creation and
        its lock acquisition (loop-confined, no lock needed)."""
        self._fallbacks_pending[actor_id] = \
            self._fallbacks_pending.get(actor_id, 0) + 1
        task = asyncio.ensure_future(self._call_actor_async(
            actor_id, method, payload, deps, return_id, group=group,
            trace=trace))

        def _chain(t):
            n = self._fallbacks_pending.get(actor_id, 1) - 1
            if n <= 0:
                self._fallbacks_pending.pop(actor_id, None)
            else:
                self._fallbacks_pending[actor_id] = n
            if cfut.cancelled():
                return
            if t.cancelled():
                cfut.cancel()
            elif t.exception() is not None:
                cfut.set_exception(t.exception())
            else:
                cfut.set_result(t.result())

        task.add_done_callback(_chain)

    async def _call_actor_async(self, actor_id: ActorID, method: str,
                                payload, deps, return_id: bytes,
                                retries: int = 30, group=None, trace=None):
        order_lock = self._actor_order_locks.setdefault(actor_id, asyncio.Lock())
        last_err = None
        for _ in range(retries):
            try:
                # hold the per-actor lock only across connect+send so calls
                # from this process reach the actor in program order while
                # replies stay pipelined (ActorTaskSubmitter seqno semantics,
                # reference task_submission/actor_task_submitter.h:70)
                async with order_lock:
                    conn = await self._actor_conn(actor_id)
                    kw = {"actor_id": actor_id.binary(), "method": method,
                          "args": payload, "deps": deps,
                          "return_id": return_id, "group": group}
                    if trace is not None:
                        kw["trace"] = trace
                    fut = conn.request_future("actor_call", **kw)
                return await fut
            except (protocol.ConnectionLost, ConnectionRefusedError, OSError) as e:
                last_err = e
                self._actor_addr_cache.pop(actor_id, None)
                await asyncio.sleep(0.1)
        raise ActorDiedError(f"actor unreachable: {last_err}")

    def call_actor(self, actor_id: ActorID, method: str, args: tuple,
                   kwargs: dict, group=None) -> ObjectRef:
        """Submit an actor call; returns immediately with the result ref.

        The reply (result meta) resolves in the background; `get`/`wait` on
        the ref join it via `_pending_calls`."""
        payload, deps, tokens = self.build_args_payload(args, kwargs)
        return_id = ObjectID.generate()
        # actor calls bypass the head, so the head can't pin their args:
        # hold ObjectRefs (our own local refcounts) for the deps and the
        # payload object until the reply lands
        pins = [ObjectRef(ObjectID(b)) for b in deps]
        if "meta" in payload:
            pins.append(ObjectRef(payload["meta"].object_id))
        # fast path: one plain loop callback per call. Creating a Task per
        # call (run_coroutine_threadsafe) was the single largest cost of
        # pipelined actor calls (~1/3 of the per-call cost); the
        # coroutine machinery is only needed for connect /
        # retry, which _fast_actor_send falls back to.
        cfut = _cf.Future()
        # W3C context captured on the CALLING thread (the loop callback
        # below runs without this thread's contextvars): the receiving
        # actor opens a child execution span, so serve proxy -> replica ->
        # nested calls stay one trace (None when tracing is off)
        trace = _tracing.inject_context()
        self._loop_call_soon(
            self._fast_actor_send, actor_id, method, payload, deps,
            return_id.binary(), group, cfut, trace)
        with self._pending_lock:
            self._pending_calls[return_id] = cfut

        def _on_done(f, _pins=pins, _tokens=tokens):
            _pins.clear()  # release arg pins NOW — the future object (and
            # this callback's defaults) may outlive the call in
            # _pending_calls, so dropping the binding wouldn't free them
            try:
                meta = f.result()["meta"]
            except BaseException:
                # terminal failure: the payload will never be deserialized
                # anywhere — self-release its borrow pins (idempotent if an
                # earlier retry did deliver it before the actor died)
                self.release_borrows(_tokens)
                return  # surfaced when the ref is consumed
            self.local_metas[meta.object_id] = meta

        cfut.add_done_callback(_on_done)
        return ObjectRef(return_id)

    def _resolve_pending_call(self, oid: ObjectID,
                              timeout: Optional[float] = None) -> bool:
        """Join an in-flight actor call for `oid`. True if it was pending."""
        with self._pending_lock:
            cfut = self._pending_calls.get(oid)
        if cfut is None:
            return False
        try:
            meta = cfut.result(timeout=timeout)["meta"]
            if meta is None:
                # lease failover: the task was resubmitted through the
                # head — resolve via the head directory instead
                return False
            self.local_metas[meta.object_id] = meta
        except TimeoutError:
            raise GetTimeoutError(f"actor call {oid} not finished in time")
        finally:
            if cfut.done():
                with self._pending_lock:
                    self._pending_calls.pop(oid, None)
        return True

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._wait_connected()
        self._call(self.conn.request("kill_actor", actor_id=actor_id.binary(),
                                     no_restart=no_restart))

    # ------------------------------------------------------------------ kv
    # via head_request: KV ops are idempotent and ride a head restart
    # (retry on the re-established connection) — a worker loading a
    # function blob mid-outage must stall briefly, not fail its task
    def kv_put(self, ns: str, key: bytes, value: bytes, overwrite=True) -> bool:
        return self.head_request("kv_put", ns=ns, key=key, value=value,
                                 overwrite=overwrite)

    def kv_get(self, ns: str, key: bytes) -> Optional[bytes]:
        return self.head_request("kv_get", ns=ns, key=key)

    def kv_del(self, ns: str, key: bytes) -> bool:
        return self.head_request("kv_del", ns=ns, key=key)

    def kv_keys(self, ns: str, prefix: bytes) -> list:
        return self.head_request("kv_keys", ns=ns, prefix=prefix)
