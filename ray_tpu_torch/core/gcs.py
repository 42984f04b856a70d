"""Head process: cluster control plane + two-level scheduler + worker pools.

Capability-equivalent of the reference's GCS (`src/ray/gcs/gcs_server/`) plus
the scheduling half of the raylet (`src/ray/raylet/scheduling/
cluster_task_manager.cc:201`): node/actor/object/KV tables, pubsub,
resource-based task scheduling with dependency-aware dispatch, label
selectors, worker lifecycle, actor restarts, placement groups with
PACK/SPREAD/STRICT_* bundle placement across nodes.

Topology: the head owns the tables and the placement decisions; every node
(including the head's own) contributes a worker pool. Remote nodes run a thin
node daemon (`node_main.py`) that only spawns/kills local workers on request —
workers connect straight to the head, and steady-state actor traffic is
direct worker<->worker (reference's core-worker gRPC model, SURVEY §3.3).

Single-machine multi-node: exactly the reference's `cluster_utils.Cluster`
strategy (SURVEY §4.2) — N node daemons as local processes with fake
resource dicts exercise all distributed logic over real sockets.
"""

from __future__ import annotations

import asyncio
import os
import subprocess
import sys
import time
from collections import OrderedDict, deque
from types import SimpleNamespace
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.core import object_directory as objdir
from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, PlacementGroupID, TaskID, WorkerID
from ray_tpu_torch.core.store import ObjectMeta, SharedMemoryStore


# After a head restart, how long a restored detached actor waits for its
# node daemon to report the process that still hosts it (daemons retry the
# head every <= 2 s), and how long a reported actor's resources stay held
# for that process to re-register, before the actor is re-created
# elsewhere. A module constant, not a config flag: the flag table stays
# the JAX package's.
ACTOR_READOPT_GRACE_S = 5.0
ACTOR_HOLD_S = 10.0


class NodeInfo:
    def __init__(self, node_id: NodeID, resources: Dict[str, float],
                 labels: Dict[str, str], conn: Optional[protocol.Connection],
                 max_workers: int, is_head: bool = False):
        self.node_id = node_id
        self.resources = dict(resources)
        self.available = dict(resources)
        self.labels = dict(labels)
        self.conn = conn              # None for the head-local node
        self.max_workers = max_workers
        self.is_head = is_head
        # (host, port) of the node's object data server; host None = "the
        # head's host" (clients substitute their known route to the head)
        self.data_addr = None
        # (host, port) of the node daemon's scheduler server — clients
        # route warm lease requests here directly (two-level scheduling);
        # None for the head's own node and for daemons predating the view
        self.sched_addr = None
        # gossiped node-daemon state (resource_view_delta): the daemon's
        # own version counter, its warm lease-pool idle count, and the
        # pool's per-shape composition (None until the daemon gossips one)
        self.view_version = 0
        self.pool_idle = 0
        self.pool_shapes = None
        # flight recorder: when the last delta arrived (feeds the
        # cluster_view_staleness_s gauge), the daemon's lifetime scheduler
        # counters, and its reported gossip health (view_age_s etc.)
        self.last_delta_ts = time.time()
        self.sched_stats: Dict[str, float] = {}
        self.gossip_health: Dict[str, float] = {}
        # partition tolerance: the daemon's gossiped live-lease count, the
        # highest flight-recorder event seq merged (duplicate deliveries of
        # un-acked batches are dropped below it), and the reconciliation
        # handshake state — False from every (re)registration until the
        # daemon's pool_reconcile report rebuilds this node's carve-outs
        self.pool_leased = 0
        self.fr_last_seq = 0
        self.reconciled = conn is None  # head-local node: nothing to do
        # interest-scoped view plane: None = legacy full-fanout; else
        # {"interest": [shard ids], "sent": {sid: version last pushed},
        #  "digest_ts": monotonic ts of the last digest refresh}
        self.view_sub: Optional[dict] = None
        self.pending_pool: Dict[WorkerID, dict] = {}  # claimed at register
        # actor processes the daemon's reconcile reported that have not
        # re-registered yet: their resources, already debited (the hold)
        self.pending_actors: Dict[WorkerID, SimpleNamespace] = {}
        self.unadopted: Set["WorkerInfo"] = set()     # parked reconnectors
        self.alive = True
        self.idle: List["WorkerInfo"] = []
        self.workers: Set[WorkerID] = set()
        self.starting_workers = 0

    def fits(self, resources: Dict[str, float]) -> bool:
        return all(self.available.get(r, 0) >= amt - 1e-9
                   for r, amt in resources.items())

    def could_ever_fit(self, resources: Dict[str, float]) -> bool:
        return all(self.resources.get(r, 0) >= amt - 1e-9
                   for r, amt in resources.items())

    def matches_labels(self, selector: Optional[Dict[str, str]]) -> bool:
        from ray_tpu_torch.core.resource_view import matches_labels

        return matches_labels(self.labels, selector)

    def utilization(self) -> float:
        fracs = [1 - self.available.get(r, 0) / t
                 for r, t in self.resources.items() if t > 0]
        return max(fracs) if fracs else 0.0


class WorkerInfo:
    def __init__(self, worker_id: WorkerID, conn: protocol.Connection, pid: int,
                 port: int, is_driver: bool, node_id: NodeID):
        self.worker_id = worker_id
        self.conn = conn
        self.pid = pid
        self.port = port  # direct-call server port
        self.is_driver = is_driver
        self.node_id = node_id
        self.running_task: Optional[TaskID] = None
        self.actor_id: Optional[ActorID] = None
        self.blocked = False
        self.acquired: Dict[str, float] = {}
        self.acquired_pg: Optional[PlacementGroupID] = None
        self.acquired_bundle: Optional[int] = None
        self.proc: Optional[subprocess.Popen] = None
        # pip-isolated workers run a venv interpreter; tasks whose
        # runtime_env carries the same pip_key route here exclusively
        self.venv_key: Optional[str] = None
        self.current_record = None
        self.retiring = False  # max_calls reached; exiting after current task
        self.host: Optional[str] = None  # peer host of the registration conn
        # lease protocol: WorkerID of the client this worker is leased to
        # for direct task pushes (None = scheduled by the head)
        self.leased_to: Optional[WorkerID] = None
        # two-level scheduling: True while this worker (and its resource
        # carve-out) belongs to its node daemon's lease pool — the head
        # never dispatches to it until the daemon releases it back.
        # pool_grant_seq keys the carve-out generation: a pool_release
        # must echo it, so duplicate/late releases of an older generation
        # are no-ops (epoch + seq keyed idempotence)
        self.pooled = False
        self.pool_grant_seq: Optional[int] = None
        # the node id the worker's registration named (survives the
        # fallback to head_node when its daemon is mid-reconnect)
        self.declared_node: Optional[NodeID] = None
        self.log_tag: Optional[str] = None  # stem of its log files


class ActorInfo:
    def __init__(self, actor_id: ActorID, spec: dict):
        self.actor_id = actor_id
        self.spec = spec                  # serialized class, args, options
        self.state = "PENDING"            # PENDING/ALIVE/RESTARTING/DEAD
        self.worker: Optional[WorkerInfo] = None
        self.address: Optional[Tuple[str, int]] = None
        self.restarts_left = spec["options"].get("max_restarts", 0)
        self.ready_event = asyncio.Event()
        self.death_cause: Optional[str] = None
        # a detached actor restored from a snapshot is not re-created
        # before this monotonic time: its process may have survived the
        # head, reported by its daemon and re-adopted
        self.readopt_until = 0.0


class TaskRecord:
    def __init__(self, spec: dict, submitter: WorkerInfo):
        self.spec = spec
        self.task_id: TaskID = spec["task_id"]
        self.submitter = submitter
        self.retries_left = spec["options"].get("max_retries", 3)
        self.pending_deps: Set[ObjectID] = set()
        self.cancelled = False
        self.dispatch_ts: Optional[float] = None
        self.pinned: List[ObjectID] = []  # deps pinned while in flight


class TaskQueue:
    """Pending tasks bucketed by scheduling shape (resources + selector +
    PG + strategy). Identical shapes get identical placement verdicts while
    cluster state is unchanged, so the dispatcher stops scanning a bucket at
    its first non-dispatchable record — the reference ClusterTaskManager's
    per-class queueing, without which a deep queue makes every scheduling
    event O(queue) and pipelined submission collapses."""

    def __init__(self):
        self._shapes: "OrderedDict[tuple, deque]" = OrderedDict()
        self._len = 0

    @staticmethod
    def shape_of(rec: "TaskRecord") -> tuple:
        o = rec.spec["options"]
        sel = o.get("label_selector")
        sel_key = (tuple(sorted(
            (k, tuple(v) if isinstance(v, (list, tuple, set)) else str(v))
            for k, v in sel.items())) if sel else None)
        # same normalization as _try_dispatch: an EXPLICIT resources={} is a
        # zero-resource task and must not share a bucket with CPU:1 defaults
        res = o.get("resources", {"CPU": 1})
        return (tuple(sorted(res.items())), sel_key,
                o.get("placement_group"),
                o.get("placement_group_bundle_index"),
                o.get("scheduling_strategy", "hybrid"))

    def append(self, rec: "TaskRecord") -> None:
        key = self.shape_of(rec)
        dq = self._shapes.get(key)
        if dq is None:
            dq = self._shapes[key] = deque()
        dq.append(rec)
        self._len += 1

    def scan(self, dispatch) -> None:
        """One scheduling pass: per bucket, dispatch ready records until the
        first non-dispatchable one (same shape ⇒ same verdict until cluster
        state changes). `dispatch(rec, remaining)` returns None on success,
        else a block reason. Owns all length bookkeeping."""
        for key in list(self._shapes.keys()):
            dq = self._shapes.get(key)
            if dq is None:
                continue
            kept: deque = deque()   # dep-waiting records stepped over
            while dq:
                rec = dq[0]
                if rec.pending_deps:
                    kept.append(dq.popleft())
                    continue
                if dispatch(rec, len(dq)) is None:
                    dq.popleft()
                    self._len -= 1
                else:
                    break
            if kept:
                kept.extend(dq)
                self._shapes[key] = kept
            elif not dq:
                self._shapes.pop(key, None)

    def remove(self, rec: "TaskRecord") -> None:
        key = self.shape_of(rec)
        dq = self._shapes.get(key)
        if dq is None:
            return
        try:
            dq.remove(rec)
            self._len -= 1
        except ValueError:
            pass
        if not dq:
            del self._shapes[key]

    def __iter__(self):
        for dq in list(self._shapes.values()):
            yield from list(dq)

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0


class GeneratorState:
    """Streaming-generator bookkeeping (reference: dynamic return refs +
    `_generator_backpressure_num_objects`, SURVEY §2.12b)."""

    def __init__(self, backpressure: int = 0):
        self.items: List[bytes] = []      # yielded object ids, in order
        self.delivered: Set[int] = set()  # indices handed to the consumer
        self.done = False
        self.released = False             # consumer dropped the generator
        self.backpressure = backpressure
        self.consumed = 0                 # highest index the consumer fetched
        self.consumer_waiters: List[asyncio.Future] = []
        self.producer_waiters: List[asyncio.Future] = []

    def wake(self, waiters: List[asyncio.Future]) -> None:
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)
        waiters.clear()


class BundleState:
    def __init__(self, index: int, resources: Dict[str, float]):
        self.index = index
        self.resources = dict(resources)
        self.node_id: Optional[NodeID] = None
        self.available: Dict[str, float] = {}

    def fits(self, resources: Dict[str, float]) -> bool:
        return all(self.available.get(r, 0) >= amt - 1e-9
                   for r, amt in resources.items())


class PlacementGroupInfo:
    def __init__(self, pg_id: PlacementGroupID, bundles: List[dict], strategy: str,
                 name: str = ""):
        self.pg_id = pg_id
        self.bundles = [BundleState(i, b) for i, b in enumerate(bundles)]
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"
        self.ready_event = asyncio.Event()


class Head:
    def __init__(self, session: str, num_cpus: Optional[float] = None,
                 resources: Optional[dict] = None, num_gpus: Optional[int] = None,
                 object_store_bytes: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 labels: Optional[dict] = None):
        self.session = session
        self.node_id = NodeID.generate()
        from ray_tpu_torch.core.resources import node_labels, node_resources

        head_resources = node_resources(num_cpus, num_gpus, resources)
        head_max = max_workers or max(int(head_resources.get("CPU", 4)) * 2, 8)
        self.head_node = NodeInfo(self.node_id, head_resources,
                                  {**node_labels(), **(labels or {})},
                                  conn=None, max_workers=head_max, is_head=True)
        self.nodes: Dict[NodeID, NodeInfo] = {self.node_id: self.head_node}

        from ray_tpu_torch.core.store import default_store_bytes

        if object_store_bytes is None or object_store_bytes <= 0:
            # reference-parity: 30% of RAM capped by /dev/shm (node.py:1409)
            object_store_bytes = default_store_bytes()
        self.store = SharedMemoryStore(
            session, capacity_bytes=object_store_bytes, create_arena=True,
            namespace=(self.node_id.hex()[:8]
                       if _config.get("store_isolation")
                       and not _config.get("store_namespace")
                       else None))
        self.workers: Dict[WorkerID, WorkerInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}
        self.objects: Dict[ObjectID, ObjectMeta] = {}
        self.object_waiters: Dict[ObjectID, List[asyncio.Future]] = {}
        self.kv: Dict[Tuple[str, bytes], bytes] = {}
        self.pgs: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        self.queue = TaskQueue()
        self.dep_index: Dict[ObjectID, List[TaskRecord]] = {}
        self.generators: Dict[bytes, GeneratorState] = {}
        self.subscribers: Dict[str, List[protocol.Connection]] = {}
        self.port: Optional[int] = None
        self._server: Optional[protocol.Server] = None
        self._shutdown = False
        self.job_counter = 0
        self.start_time = time.time()
        self._spawned: Dict[int, subprocess.Popen] = {}
        # ring buffer of task lifecycle events (reference: task_event_buffer
        # → gcs_task_manager; feeds the state API + `timeline()`)
        from collections import OrderedDict, deque
        self.task_events: deque = deque(maxlen=20000)
        # flight recorder: merged per-node lease-lifecycle/gossip events
        # (piggybacked on resource_view_delta) + the head's own scheduler
        # counters — feeds list_lease_events/list_scheduler_stats and the
        # dashboard's /api/scheduler
        self.lease_events: deque = deque(
            maxlen=_config.get("flight_recorder_head_events"))
        # workload flight recorder: finished spans pushed by every
        # process (metrics_push for workers/drivers, resource_view_delta
        # gossip for daemons) keyed by span id — timeline(format="chrome")
        # merges them into one cross-process trace
        self.trace_spans: "OrderedDict[str, dict]" = OrderedDict()
        # parsed copy of each _metrics KV payload, decoded ONCE at push
        # arrival (the watchdog + /api/workloads + span extraction would
        # otherwise re-json.loads every process's snapshot on the event
        # loop several times per interval); entries die with their KV key
        self._metrics_parsed: Dict[bytes, list] = {}
        self._watchdog_state: dict = {}
        self._anomaly_counter = None
        self.sched_totals = {"head_grants": 0, "pool_acquires": 0,
                             "pool_releases": 0, "stale_epoch_rejects": 0,
                             "reconciles": 0,
                             # lineage recovery: objects re-sealed by
                             # re-running their producing task after every
                             # copy was lost; data_reconstructs counts the
                             # data library's stage/shuffle blocks
                             # (data_blocks_reconstructed_total on /metrics)
                             "reconstructs": 0, "data_reconstructs": 0}
        # epoch fencing: a cluster epoch stamped into cluster_view and
        # every grant/carve-out; daemons and clients tag pool/lease traffic
        # with the epoch they observed, and stale-epoch operations are
        # rejected and routed into reconciliation instead of silently
        # mutating the ledger. Wall-clock seeded so a restart without a
        # snapshot still moves forward; restore bumps past the snapshot's.
        self.cluster_epoch = int(time.time())
        self._pool_seq = 0  # carve-out generation counter (grant_seq)
        # object lineage: return oid -> producing task spec, for
        # reconstruction of lost objects (reference: TaskManager lineage +
        # object_recovery_manager). Bounded FIFO.
        self.lineage: "OrderedDict[ObjectID, dict]" = OrderedDict()
        self.lineage_cap = _config.get("lineage_cap")
        # byte cap mirrors the reference's RAY_max_lineage_bytes: specs keep
        # inline args alive, so count must not be the only bound
        self.lineage_bytes_cap = _config.get("lineage_bytes")
        self.lineage_bytes = 0
        self._reconstructing: Set[ObjectID] = set()
        # ------- distributed object lifetime (reference_count.h parity) ---
        # An object stays alive while ANY of: a process holds a live
        # ObjectRef (obj_holders), an in-flight task/actor-call references
        # it (obj_pins, incl. containment in a live object and queued
        # generator items), or a reconstructable lineage entry needs it as
        # an input (lineage_dep_pins). When all empty, it is evicted after
        # a short grace window that absorbs in-flight handoffs.
        self.refcount_enabled = _config.get("refcount")
        self.obj_holders: Dict[ObjectID, Set[WorkerID]] = {}
        # bounded-wait lease requests served as workers free up; entries
        # are dicts {resources, selector, venv_key, node_id, fut} so a
        # grant can honor the waiter's label selector / venv / node pin
        self._lease_waiters: list = []
        # versioned cluster resource view (ray_syncer role): broadcast
        # debounced to node daemons + subscribed drivers
        self._view_seq = 0
        self._last_view_snap: Optional[dict] = None
        self._view_wake: Optional[asyncio.Event] = None
        # sharded view plane (view_shards > 1): independent per-shard
        # versions bumped whenever any node in the shard changes, and the
        # scoped pubsub subscribers' send state (daemons keep theirs on
        # NodeInfo). Interest-scoped subscribers receive only changed
        # interest shards (as shard snapshots) plus a compact digest —
        # never the full node list.
        self._shard_vs: Dict[int, int] = {}
        self._sub_views: Dict[protocol.Connection, dict] = {}
        # serve-replica live-load rows piggybacked on the cluster_view
        # broadcast (changed-only): routers/handles/autoscalers read the
        # gossiped queue depth / EWMA latency with ZERO head RPCs on the
        # request path (serve/live_signals.py)
        self._last_serve_rows: List[dict] = []
        # gossiped object directory (authoritative copy): seal/spill/free
        # of non-inline objects and daemon replica announcements append
        # delta records that ride the next cluster_view broadcast; daemons
        # and drivers keep cached copies so warm pulls resolve peer-to-peer
        # with zero head RPCs (core/object_directory.py)
        from ray_tpu_torch.core.object_directory import ObjectDirectory
        self.object_dir = ObjectDirectory()
        self._dir_seq = 0
        self._dir_pending: List[dict] = []
        self._dir_full_resync = False  # pending overflow: broadcast full
        self.obj_pins: Dict[ObjectID, int] = {}
        self.worker_holds: Dict[WorkerID, Set[ObjectID]] = {}
        self.lineage_dep_pins: Dict[ObjectID, int] = {}
        # borrower protocol (reference reference_count.h:73): token ->
        # (oid, sender worker); a pin opened when a ref is pickled, closed
        # by the deserializer's commit or the sender's death. Commits that
        # outrace their begin (receiver's flush beat the sender's) park in
        # a bounded seen-set so the late begin is dropped, not leaked.
        self.borrow_pins: Dict[bytes, tuple] = {}
        self.obj_borrows: Dict[ObjectID, Set[bytes]] = {}
        self.worker_borrows: Dict[WorkerID, Set[bytes]] = {}
        self._committed_tokens: "OrderedDict[bytes, None]" = OrderedDict()
        # zero-grace eviction support: an object with NO recorded interest
        # yet (its owner's inc is still in flight) is "newborn" and never
        # evicted — the first interest event arms normal lifetime. Dropped
        # objects leave a bounded tombstone so a late seal (slow retry)
        # frees its orphan copy instead of resurrecting a newborn.
        self.obj_interest_seen: Set[ObjectID] = set()
        self._tombstones: "OrderedDict[ObjectID, None]" = OrderedDict()
        self._evict_due: Dict[ObjectID, float] = {}
        # borrow pins make lifetime explicit, so no grace window is needed
        # to absorb in-flight handoffs (was 2.0 s of correctness-by-timing)
        self.evict_grace_s = _config.get("evict_grace_s")
        self.objects_evicted = 0
        # produced objects lost to node death, awaiting lazy reconstruction;
        # if their lineage entry gets cap-evicted meanwhile, consumers must
        # get ObjectLostError, not an eternal hang
        self._lost_pending: Set[ObjectID] = set()
        # worker log capture (reference log_monitor.py): per-file ring of
        # recent lines — the CLI/dashboard read this, so logs from remote
        # nodes work without a shared filesystem. LRU-bounded by file
        # count: worker churn must not grow head memory forever.
        self.log_ring: "OrderedDict[str, deque]" = OrderedDict()
        self._log_monitor = None

    def _task_event(self, task_id, name: str, state: str, *,
                    worker=None, node_id=None, error: str = None) -> None:
        self.task_events.append({
            "task_id": task_id.hex() if hasattr(task_id, "hex") else str(task_id),
            "name": name, "state": state, "ts": time.time(),
            "worker_id": worker.worker_id.hex() if worker else None,
            "node_id": (node_id.hex() if node_id is not None else
                        (worker.node_id.hex() if worker else None)),
            "error": error,
        })

    # ------------------------------------------------------------------ rpc
    def _handlers(self, conn_state: dict):
        def _peer_host():
            try:
                peer = conn_state["conn"].writer.get_extra_info("peername")
                return peer[0] if peer else None
            except Exception:
                return None

        async def register_worker(worker_id, pid, port, is_driver, node_id=None,
                                  log_tag=None, venv_key=None,
                                  reconnect=False):
            nid = NodeID(node_id) if node_id else self.node_id
            node = self.nodes.get(nid) or self.head_node
            w = WorkerInfo(WorkerID(worker_id), conn_state["conn"], pid, port,
                           is_driver, node.node_id)
            w.host = _peer_host()  # reachable host for direct actor calls
            w.proc = self._spawned.pop(pid, None)
            w.log_tag = log_tag    # maps this worker to its log files
            w.venv_key = venv_key
            # the node the worker CLAIMS to belong to (its spawn-time env),
            # kept even when the lookup fell back to head_node because the
            # daemon has not re-registered yet — pool_reconcile uses it to
            # find fallback-parked workers
            w.declared_node = nid
            self.workers[w.worker_id] = w
            conn_state["worker"] = w
            node.workers.add(w.worker_id)
            if not is_driver:
                node.starting_workers = max(0, node.starting_workers - 1)
                item = (node.pending_pool.pop(w.worker_id, None)
                        if node.conn is not None else None)
                # declared a remote node that has not re-registered yet:
                # its daemon may still pool this worker — treat like an
                # unreconciled node (the fallback to head_node must not
                # bypass the double-grant fence)
                daemon_pending = (node is self.head_node
                                  and nid != self.node_id)
                hold = (node.pending_actors.pop(w.worker_id, None)
                        if reconnect else None)
                if hold is not None:
                    # an actor's process that outlived the head, which its
                    # daemon's reconciliation report named: re-adopt it
                    # onto the resources held for it since that report
                    self._adopt_actor_worker(node, w, hold)
                elif item is not None:
                    # its daemon's reconciliation report already claimed
                    # this worker for a lease pool: restore the carve-out
                    # instead of exposing it to head dispatch
                    self._adopt_pooled(node, w, item)
                elif reconnect and (daemon_pending or (
                        node.conn is not None and not node.reconciled)):
                    # a surviving worker re-registering after a head
                    # restart: its node daemon may still hold it in a
                    # lease pool — park it until pool_reconcile claims or
                    # disowns it (double-grant fence), with a promotion
                    # timeout in case the daemon never reports. 10 s: a
                    # live daemon reconciles within ~1 s of reconnecting
                    # (its backoff caps at 2 s), so the fence comfortably
                    # outlasts reconcile without stranding workers whose
                    # daemon died for good.
                    node.unadopted.add(w)
                    asyncio.get_running_loop().call_later(
                        10.0, self._promote_unadopted, node, w)
                else:
                    node.idle.append(w)
                    self._grant_lease_waiters(node)
                    self._kick()
            # a worker whose daemon has not re-registered yet is homed on
            # the head's node for now, but it runs on its own node: tell it
            # that one (its runtime context reports where it really runs)
            home = (nid if not is_driver and node is self.head_node
                    and nid != self.node_id else node.node_id)
            return {"node_id": home.binary(), "session": self.session,
                    "epoch": self.cluster_epoch,
                    # lets clients recognize the restart-recovery window
                    # (a young head may still be re-learning state from
                    # reconnecting exporters)
                    "head_uptime_s": time.time() - self.start_time,
                    "resources": node.resources, "labels": node.labels,
                    # the head's refcount setting is authoritative; clients
                    # enable/disable their trackers from this reply
                    "refcount": self.refcount_enabled,
                    # full negotiated-config snapshot (ray_config_def.h
                    # style single source of truth; "refcount" above is
                    # the older key, kept for compatibility)
                    "config": _config.GLOBAL.negotiated_snapshot(),
                    "driver_sys_path": self.kv.get(("cluster", b"driver_sys_path"))}

        async def register_node(node_id, resources, labels, max_workers,
                                data_port=None, sched_port=None,
                                interest=None):
            nid = NodeID(node_id)
            existing = self.nodes.get(nid)
            if existing is not None and not existing.is_head:
                # re-registration after a connection flap / healed
                # partition: keep the ledger, workers and pool state —
                # only the transport is new. The reconciliation handshake
                # re-runs (the daemon reports its inventory right after
                # this reply) to settle any drift from the outage.
                old_conn = existing.conn
                node = existing
                node.conn = conn_state["conn"]
                node.alive = True
                node.reconciled = False
                node.view_sub = self._make_view_sub(interest, nid)
                if data_port:
                    node.data_addr = (_peer_host() or "127.0.0.1", data_port)
                if sched_port:
                    node.sched_addr = (_peer_host() or "127.0.0.1",
                                       sched_port)
                conn_state["node"] = node
                if old_conn is not None and not old_conn.closed:
                    asyncio.ensure_future(old_conn.close())
                self.lease_events.append(
                    {"ts": time.time(), "kind": "node_reregister",
                     "node_id": nid.hex()})
                self._kick()
                self._view_changed()
                self._push_full_view(conn_state["conn"],
                                     sub=node.view_sub)
                return {"session": self.session,
                        "head_node_id": self.node_id.binary(),
                        "epoch": self.cluster_epoch}
            node = NodeInfo(nid, resources, labels, conn_state["conn"],
                            max_workers)
            node.view_sub = self._make_view_sub(interest, nid)
            if data_port:
                node.data_addr = (_peer_host() or "127.0.0.1", data_port)
            if sched_port:
                node.sched_addr = (_peer_host() or "127.0.0.1", sched_port)
            self.nodes[nid] = node
            conn_state["node"] = node
            self._publish("node_state", {"node_id": nid.binary(), "state": "ALIVE"})
            self._kick()
            self._view_changed()
            self._push_full_view(conn_state["conn"], sub=node.view_sub)
            return {"session": self.session,
                    "head_node_id": self.node_id.binary(),
                    "epoch": self.cluster_epoch}

        async def resource_view_delta(version, idle_workers, labels=None,
                                      events=None, stats=None, gossip=None,
                                      metrics=None, epoch=None,
                                      leased_workers=None, objects=None,
                                      pool_shapes=None):
            """Node-daemon gossip: its lease-pool state changed. Stale
            versions (a reconnect replaying an old delta) are ignored.
            The reply acks the highest flight-recorder event seq merged —
            the daemon keeps un-acked batches pending and resends them
            (duplicates are dropped here by per-node seq), so a delta
            lost on a dying connection no longer loses its events."""
            node = conn_state.get("node")
            if node is None:
                return False
            if epoch is not None and epoch != self.cluster_epoch:
                # a delta stamped with a dead epoch must not mutate the
                # view or the telemetry merge — route the daemon into the
                # reconciliation handshake instead
                self._stale_epoch("resource_view_delta", node)
                return {"nack": True, "epoch": self.cluster_epoch}
            node.last_delta_ts = time.time()
            if events:
                nid = node.node_id.hex()
                for ev in events:
                    seq = ev.get("seq", 0)
                    if seq and seq <= node.fr_last_seq:
                        continue  # re-delivery of an un-acked batch
                    ev["node_id"] = nid
                    self.lease_events.append(ev)
                    if seq:
                        node.fr_last_seq = seq
            if stats:
                node.sched_stats = stats
            if gossip:
                node.gossip_health = gossip
            if leased_workers is not None:
                node.pool_leased = leased_workers
            if objects:
                # replica announcements from the daemon's pull manager
                # (pull-replica created / cache-evicted): merge into the
                # authoritative directory and rebroadcast so every
                # consumer gains the extra pull source
                nid_hex = node.node_id.hex()
                for rec in objects:
                    if rec.get("op") not in ("replica", "replica_gone") \
                            or rec.get("node") != nid_hex:
                        continue
                    self._dir_announce(rec)
                    if rec["op"] == "replica_gone":
                        # the evicted replica may have been the LAST copy
                        # of an object whose primary already died: run
                        # loss handling (reconstruct / seal lost) now
                        # instead of leaving a dangling meta forever
                        oid = ObjectID(rec["oid"])
                        m = self.objects.get(oid)
                        if (m is not None and m.kind in ("shm", "arena")
                                and m.node_id is not None
                                and not self._node_alive(m.node_id)
                                and not self.object_dir.locations(oid)):
                            self._handle_lost_object(
                                oid, f"last replica evicted on {nid_hex}")
            if metrics is not None:
                # daemons have no CoreClient/pusher: their metrics registry
                # snapshot rides the gossip into the same _metrics KV
                # namespace the scrape endpoint aggregates (expired with
                # the node on disconnect)
                import json as _json

                mkey = f"proc:node-{node.node_id.hex()[:12]}".encode()
                self.kv[("_metrics", mkey)] = _json.dumps(metrics).encode()
                self._metrics_parsed[mkey] = metrics
                for fam in metrics:
                    if fam.get("name") == "__spans__":
                        self._adopt_spans(
                            fam.get("series") or (),
                            proc=f"node-{node.node_id.hex()[:12]}",
                            node=node.node_id.hex()[:12])
            if version > node.view_version:
                node.view_version = version
                node.pool_idle = idle_workers
                if pool_shapes is not None:
                    # per-shape pool composition: broadcast in the view so
                    # peer-spillback referrals name peers actually holding
                    # a matching warm worker (cuts dead-referral hops)
                    node.pool_shapes = pool_shapes
                if labels:
                    node.labels.update(labels)
                self._view_changed()
            return {"acked_seq": node.fr_last_seq,
                    "epoch": self.cluster_epoch}

        async def metrics_push(value):
            """Per-process metrics snapshot (drivers/workers push on a
            cadence — fire-and-forget so telemetry never adds control
            round trips). Keyed by the pushing worker id; expired by
            _on_worker_disconnect so dead processes stop being scraped."""
            w = conn_state.get("worker")
            if w is None:
                return False
            import json as _json

            key = f"proc:{w.worker_id.hex()}".encode()
            self.kv[("_metrics", key)] = value
            try:
                payload = _json.loads(value)
            except Exception:
                # kv now holds the bad bytes: a stale cache entry would
                # serve the PREVIOUS snapshot forever
                self._metrics_parsed.pop(key, None)
                return False
            self._metrics_parsed[key] = payload
            for fam in payload:
                if fam.get("name") == "__spans__":
                    self._adopt_spans(
                        fam.get("series") or (),
                        proc=w.worker_id.hex()[:12],
                        node=w.node_id.hex()[:12] if w.node_id else None)
            return True

        async def pool_acquire(resources, venv_key=None, epoch=None):
            """A node daemon carves a lease worker out of its own node for
            its local pool: the head debits the ledger ONCE here; all
            subsequent grant/return cycles on that worker are daemon-local
            (reference raylet worker-pool ownership). The reply stamps the
            cluster epoch and a carve-out generation (grant_seq) the
            daemon must echo on release."""
            node = conn_state.get("node")
            if node is None or not node.could_ever_fit(resources):
                return None
            if epoch is not None and epoch != self.cluster_epoch:
                self._stale_epoch("pool_acquire", node)
                return None
            lw = None
            if node.fits(resources):
                lw = self._idle_worker_on(node, venv_key)
            if lw is None:
                self._request_worker(node, pip=None, pip_key=venv_key)
                fut = asyncio.get_running_loop().create_future()
                ent = {"resources": resources, "selector": None,
                       "venv_key": venv_key, "node_id": node.node_id,
                       "fut": fut}
                self._lease_waiters.append(ent)
                try:
                    # generous: a cold pool needs a full worker spawn
                    # (python boot + register), seconds on a small host
                    lw = await asyncio.wait_for(fut, timeout=5.0)
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    try:
                        self._lease_waiters.remove(ent)
                    except ValueError:
                        pass
                    return None
                # granted pre-acquired by _grant_lease_waiters
            else:
                self._acquire(lw, resources)
            lw.pooled = True
            self._pool_seq += 1
            lw.pool_grant_seq = self._pool_seq
            self.sched_totals["pool_acquires"] += 1
            self._last_dispatch_ts = time.monotonic()
            self._view_changed()
            return {"worker_id": lw.worker_id.binary(),
                    "addr": (lw.host or "127.0.0.1", lw.port),
                    "epoch": self.cluster_epoch,
                    "grant_seq": lw.pool_grant_seq}

        async def pool_release(worker_id, grant_seq=None, epoch=None):
            """Daemon returns a pooled worker (idle too long, or pool
            teardown): resources flow back to the node ledger and the
            worker rejoins the head's dispatchable idle set. Idempotent —
            keyed by (epoch, worker, grant_seq) so the daemon's
            requeue-with-backoff retries and duplicate deliveries are
            safe: an already-released worker, a mismatched carve-out
            generation, or a stale epoch are all no-ops."""
            if epoch is not None and epoch != self.cluster_epoch:
                # reconciliation already rebuilt (or will rebuild) this
                # ledger from the daemon's inventory; applying a stale
                # release would double-credit the node
                self._stale_epoch("pool_release", conn_state.get("node"))
                return {"stale_epoch": True, "epoch": self.cluster_epoch}
            lw = self.workers.get(WorkerID(worker_id))
            if lw is None or not lw.pooled:
                return True  # already released / died / reconciled away
            if (grant_seq is not None and lw.pool_grant_seq is not None
                    and grant_seq != lw.pool_grant_seq):
                return True  # duplicate from an older carve-out generation
            lw.pooled = False
            lw.pool_grant_seq = None
            lw.leased_to = None
            self.sched_totals["pool_releases"] += 1
            self.notify_task_done(lw)
            self._view_changed()
            return True

        async def pool_reconcile(inventory, epoch=None, objects=None,
                                 actors=None):
            """Reconciliation handshake: on every (re)connect the daemon
            reports its full pool inventory (idle entries + live local
            leases) and its live actor processes. The daemon is the source
            of truth for carved capacity — the head rebuilds its ledger
            from this report rather than from a possibly-stale snapshot:
            unclaimed head-side carve-outs are released (leak fence),
            claimed workers are (re-)pooled and actor processes' resources
            held (double-grant fence), and workers that have not
            re-registered yet are parked in pending_pool / pending_actors
            for adoption at registration."""
            node = conn_state.get("node")
            if node is None:
                return None
            reported: Dict[WorkerID, dict] = {}
            for item in inventory or []:
                reported[WorkerID(item["wid"])] = item
            released = 0
            for w in list(self.workers.values()):
                if (w.node_id == node.node_id and w.pooled
                        and w.worker_id not in reported):
                    # head thinks pooled, daemon disowns it: the carve-out
                    # would leak forever (e.g. a pool_release lost while
                    # the head was unreachable)
                    w.pooled = False
                    w.pool_grant_seq = None
                    released += 1
                    self.sched_totals["pool_releases"] += 1
                    self.notify_task_done(w)
            adopted = 0
            node.pending_pool = {}
            for wid, item in reported.items():
                w = self.workers.get(wid)
                if w is None:
                    node.pending_pool[wid] = item
                    continue
                self._adopt_pooled(node, w, item)
                adopted += 1
            for item in actors or ():
                self._hold_actor_worker(node, item)
            adopted_objects = 0
            stale_objects = []
            if objects:
                # spill-restore: the daemon re-advertises its node's
                # surviving object inventory (shm/arena/spilled primaries
                # from its cached directory + pulled replicas), and the
                # head rebuilds the object directory from daemon truth —
                # the ledger pattern applied to data. _seal is idempotent
                # (first seal wins) so a live head's entries are untouched.
                for meta in objects.get("metas") or ():
                    if (meta.kind not in objdir.PULLABLE_KINDS
                            or meta.node_id != node.node_id):
                        continue
                    if meta.object_id in self._tombstones:
                        # freed while the daemon's free push was lost in a
                        # connection flap: tell it to reclaim the storage
                        # instead of resurrecting the object
                        stale_objects.append(meta)
                        continue
                    if meta.object_id not in self.objects:
                        self._seal(meta)
                        adopted_objects += 1
                nid_hex = node.node_id.hex()
                for oid_b in objects.get("replicas") or ():
                    oid = ObjectID(oid_b)
                    if oid in self.objects:
                        self._dir_announce(
                            objdir.replica_record(oid, nid_hex))
            node.reconciled = True
            self.sched_totals["reconciles"] += 1
            for w in list(node.unadopted):
                self._promote_unadopted(node, w)
            # fallback-parked workers (re-registered before this daemon
            # did, so they landed on head_node): claimed ones were
            # re-homed by _adopt_pooled above; disowned ones go to work
            for w in list(self.head_node.unadopted):
                if getattr(w, "declared_node", None) == node.node_id:
                    self._promote_unadopted(self.head_node, w)
            self.lease_events.append(
                {"ts": time.time(), "kind": "pool_reconcile",
                 "node_id": node.node_id.hex(), "adopted": adopted,
                 "released": released, "pending": len(node.pending_pool),
                 "objects_readvertised": adopted_objects})
            self._view_changed()
            self._kick()
            for meta in stale_objects:
                try:
                    node.conn.push("free_object", meta=meta)
                except Exception:
                    pass
            return {"epoch": self.cluster_epoch, "adopted": adopted,
                    "released": released}

        async def set_node_chaos(node_id, spec):
            """Chaos control plane: apply a fault plan inside a node
            daemon (tests sever the daemon<->head edge at a controlled
            moment without SIGSTOP-freezing the whole process)."""
            n = self.nodes.get(NodeID(node_id))
            if n is None or n.conn is None or n.conn.closed:
                return False
            n.conn.push("chaos", spec=spec)
            return True

        async def submit_task(spec):
            w = conn_state["worker"]
            rec = TaskRecord(spec, w)
            for rid in spec["return_ids"]:
                # the submitter constructs ObjectRefs for every return
                # id; record it as holder NOW so a fast task's sealed
                # result can't be evicted before the submitter's inc
                # flush lands. A lease-failover resubmission only skips
                # this when the head has provably seen AND released the
                # submitter's ref (inc + dec both landed) — re-adding
                # then would leak the sealed result forever. A
                # connect-phase failover fires milliseconds after the
                # original submit, when the inc can still be inside the
                # refcount flush window, so "failover" alone is not
                # evidence the holder exists.
                oid = ObjectID(rid)
                if (spec.get("failover")
                        and (oid in self.obj_interest_seen
                             or oid in self._tombstones)
                        and oid not in self.worker_holds.get(w.worker_id, ())):
                    # inc + dec both landed (live interest released, or the
                    # dropped ref was already tombstoned): re-adding the
                    # holder would never be released → sealed-result leak
                    continue
                self._add_holder(oid, w.worker_id)
            if spec["options"].get("num_returns") != "streaming":
                self._lineage_record_spec(spec)
            self._enqueue(rec)
            return True

        async def record_lineage(spec):
            """Out-of-band lineage registration for tasks dispatched
            WITHOUT the head (the lease/peer warm path): the client ships
            the full spec so a result lost to node death can re-run
            through the normal queue. Opt-in per task via
            options['lineage'] — set by the data library's stage tasks —
            so the default warm path stays zero-head-message."""
            if spec["options"].get("num_returns") == "streaming":
                return False
            self._lineage_record_spec(spec)
            return True

        async def release_lineage(return_ids):
            """Eager lineage retirement for consumed intermediates (the
            streaming data executor's per-partition chain release): pop
            the entries so their input dep pins release and the blocks
            follow normal refcount eviction — a long pipeline's store
            footprint stays bounded by the in-flight window, not the
            lineage cap."""
            for rid in return_ids:
                oid = ObjectID(rid)
                self._lineage_pop(oid)
                self._maybe_evict(oid)
            return True

        async def create_actor(spec):
            actor_id = ActorID(spec["actor_id"])
            name = spec["options"].get("name")
            key = None
            if name:
                key = (spec["options"].get("namespace", "default"), name)
                if key in self.named_actors:
                    existing = self.actors[self.named_actors[key]]
                    if existing.state != "DEAD":
                        if spec["options"].get("get_if_exists"):
                            return {"actor_id": self.named_actors[key].binary()}
                        raise ValueError(f"actor name {name!r} already taken")
            info = ActorInfo(actor_id, spec)
            self.actors[actor_id] = info
            if key is not None:
                self.named_actors[key] = actor_id
            self._schedule_actor(info)
            self._spawn_for_demand()
            return {"actor_id": actor_id.binary()}

        async def wait_actor(actor_id):
            info = self.actors[ActorID(actor_id)]
            await info.ready_event.wait()
            if info.state == "DEAD":
                return {"state": "DEAD", "death_cause": info.death_cause}
            return {"state": info.state, "address": info.address}

        async def get_actor_address(actor_id):
            info = self.actors.get(ActorID(actor_id))
            if info is None:
                return {"state": "DEAD", "death_cause": "actor not found"}
            if info.state in ("PENDING", "RESTARTING"):
                await info.ready_event.wait()
            if info.state == "DEAD":
                return {"state": "DEAD", "death_cause": info.death_cause}
            return {"state": info.state, "address": info.address,
                    # placement: compiled-DAG channel planning needs to
                    # know which node each endpoint lives on
                    "node_id": (info.worker.node_id.binary()
                                if info.worker is not None else None)}

        async def get_named_actor(name, namespace):
            key = (namespace, name)
            actor_id = self.named_actors.get(key)
            if actor_id is None or self.actors[actor_id].state == "DEAD":
                return None
            info = self.actors[actor_id]
            return {"actor_id": actor_id.binary(),
                    "methods": info.spec.get("methods", {})}

        async def kill_actor(actor_id, no_restart=True):
            info = self.actors.get(ActorID(actor_id))
            if info is None:
                return False
            if no_restart:
                info.restarts_left = 0
            if info.worker is not None:
                self._terminate_worker(info.worker)
            else:
                self._mark_actor_dead(info, "killed")
            return True

        async def put_meta(meta, hold=False):
            w = conn_state.get("worker")
            if meta.node_id is None and w is not None:
                meta.node_id = w.node_id  # locate for node-loss recovery
            self._seal(meta)
            if hold and w is not None:
                # the registering process holds a ref it is about to hand
                # on (client.ensure_registered): count it before its own
                # batched inc lands, which a consumer's inc/dec can outrun
                self._add_holder(meta.object_id, w.worker_id)
            return True

        async def get_meta(object_id, timeout=None):
            oid = ObjectID(object_id)
            meta = self.objects.get(oid)
            if meta is not None:
                return meta
            self._maybe_reconstruct(oid)
            fut = asyncio.get_running_loop().create_future()
            self.object_waiters.setdefault(oid, []).append(fut)
            if timeout is None:
                return await fut
            try:
                return await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                return None

        async def ref_update(ops):
            """Batched, ORDERED ObjectRef count transitions and borrow
            events from one process (reference ReferenceCounter ownership
            updates + borrower registration)."""
            w = conn_state.get("worker")
            if w is None:
                return True
            held = self.worker_holds.setdefault(w.worker_id, set())
            for op in ops:
                kind, b = op[0], op[1]
                oid = ObjectID(b)
                if kind == "i":
                    held.add(oid)
                    self.obj_holders.setdefault(oid, set()).add(w.worker_id)
                    self.obj_interest_seen.add(oid)
                    self._evict_due.pop(oid, None)
                elif kind == "d":
                    held.discard(oid)
                    hs = self.obj_holders.get(oid)
                    if hs is not None:
                        hs.discard(w.worker_id)
                        if not hs:
                            self.obj_holders.pop(oid, None)
                            self._maybe_evict(oid)
                elif kind == "b":
                    self._borrow_begin(oid, op[2], w.worker_id)
                elif kind == "c":
                    self._borrow_commit(oid, op[2])
            return True

        async def object_spilled(meta):
            """A node daemon spilled an object it tracks: retarget the
            canonical directory entry so new readers hit the spill file."""
            canonical = self.objects.get(meta.object_id)
            if canonical is not None and canonical.kind in ("shm", "arena"):
                canonical.kind = meta.kind
                canonical.spill_path = meta.spill_path
                canonical.segment = meta.segment
                self._dir_announce(objdir.spill_record(canonical))
            return True

        async def announce_prefix(model_key, oid, block_size, rows):
            """A serve replica exported a KV prefix blob into the store:
            bind its content hashes — one row per covered block boundary,
            `rows=[(hash, n_tokens), ...]`, all naming the same blob — and
            ride them out on the next cluster_view broadcast, so any
            decode replica can warm-start from the blob at ANY shared
            depth with zero head RPCs. Pushed fire-and-forget on the
            replica's existing head connection (FIFO after the blob's
            put_meta, so consumers never see a binding before its blob's
            location)."""
            o = ObjectID(oid)
            for phash, n_tokens in rows:
                self._dir_announce(objdir.prefix_record(
                    model_key, phash, o, n_tokens, block_size))
            return True

        async def withdraw_prefix(model_key, phashes, oid=None):
            """Publisher-side eviction (its pin LRU rotated a blob out):
            retire its bindings promptly instead of waiting for the
            refcount plane to free the object. `oid` scopes the retire to
            the publisher's OWN blob: two replicas racing to publish the
            same prefix rebind last-write-wins, and the loser's later
            eviction must not delete the winner's live binding."""
            rows = self.object_dir.prefixes.get(model_key) or {}
            for phash in phashes:
                ent = rows.get(phash)
                if ent is None or (oid is not None and ent["oid"] != oid):
                    continue          # rebound to another blob: keep it
                self._dir_announce(
                    objdir.prefix_gone_record(model_key, phash))
            return True

        async def announce_weights(weights_id, oid):
            """A serve replica published a weight manifest (plus its chunk
            objects) into the store: bind `weights_id -> manifest oid` and
            ride it out on the next cluster_view broadcast, so any cold
            replica resolves the manifest from its cached directory with
            zero head RPCs (serve/weight_store.py). Pushed fire-and-forget
            FIFO after the blobs' put_meta, so consumers never see the
            binding before the manifest's location."""
            self._dir_announce(objdir.weights_record(weights_id,
                                                     ObjectID(oid)))
            return True

        async def withdraw_weights(weights_id, oid=None):
            """Publisher-side eviction (its published-model LRU rotated a
            manifest out): retire the binding promptly. `oid` scopes the
            retire to the publisher's OWN manifest — two replicas racing
            to publish the same weights rebind last-write-wins, and the
            loser's later eviction must not delete the winner's live
            binding."""
            ent = self.object_dir.weights.get(weights_id)
            if ent is None or (oid is not None and ent["oid"] != oid):
                return True           # rebound to another blob: keep it
            self._dir_announce(objdir.weights_gone_record(weights_id))
            return True

        async def worker_address(worker_id):
            """Direct-server address of a live worker (device-object
            fetches go straight to the owning process)."""
            w = self.workers.get(WorkerID(worker_id))
            if w is None:
                return None
            return (w.host or "127.0.0.1", w.port)

        async def node_data_addr(node_id):
            """Data-server address of a node (for pulls of unregistered
            direct actor-reply objects, which carry only a node_id)."""
            n = self.nodes.get(NodeID(node_id))
            if n is None or not n.alive:
                return None
            return n.data_addr

        async def locate_object(object_id, timeout=None):
            """Object directory lookup — now the COLD-MISS fallback behind
            the gossiped directory (reference ownership_object_directory
            semantics). Returns the fresh meta, the primary's data-server
            address, and every advertised replica address so the puller
            can fail over without another round trip."""
            meta = await get_meta(object_id, timeout=timeout)
            if meta is None:
                return None
            addr = None
            sources = []
            serving = []
            if meta.kind in objdir.PULLABLE_KINDS:
                for node_hex in (self.object_dir.locations(meta.object_id)
                                 or ([meta.node_id.hex()]
                                     if meta.node_id is not None else [])):
                    try:
                        n = self.nodes.get(NodeID.from_hex(node_hex))
                    except Exception:
                        n = None
                    if n is not None and n.alive and n.data_addr:
                        sources.append(n.data_addr)
                        # serving-node hexes ride the reply so a scoped
                        # subscriber can widen its shard interest to the
                        # nodes it actually pulls from (interest-on-demand)
                        serving.append(node_hex)
                addr = sources[0] if sources else None
            return {"meta": meta, "data_addr": addr, "sources": sources,
                    "nodes": serving}

        async def widen_interest(shards):
            """Interest-on-demand (scoped daemon push): the subscriber
            cold-missed a data-plane pull into the locate_object fallback;
            widening its shard subscription to the serving node's shard
            makes subsequent pulls from that neighborhood resolve from
            the gossiped directory instead. Replies with a fresh scoped
            view so the newly-covered shards' entries and directory rows
            arrive immediately."""
            node = conn_state.get("node")
            nshards = int(_config.get("view_shards"))
            if node is None or node.view_sub is None or nshards <= 1:
                return False
            cur = set(node.view_sub["interest"])
            new = {int(s) % nshards for s in shards} - cur
            if not new:
                return True
            node.view_sub["interest"] = sorted(cur | new)
            self.lease_events.append(
                {"ts": time.time(), "kind": "interest_widen",
                 "node_id": node.node_id.hex(), "shards": sorted(new)})
            self._push_full_view(node.conn, sub=node.view_sub)
            return True

        async def wait_objects(object_ids, num_returns, timeout):
            object_ids = [ObjectID(b) if not isinstance(b, ObjectID) else b
                          for b in object_ids]
            for oid in object_ids:
                if oid not in self.objects:
                    self._maybe_reconstruct(oid)
            ids = list(object_ids)
            num_returns = min(num_returns, len(ids))
            deadline = None if timeout is None else time.monotonic() + timeout

            def ready():
                return [i for i, oid in enumerate(ids) if oid in self.objects]

            while len(ready()) < num_returns:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                futs = []
                for oid in ids:
                    if oid not in self.objects:
                        fut = asyncio.get_running_loop().create_future()
                        self.object_waiters.setdefault(oid, []).append(fut)
                        futs.append(fut)
                if not futs:
                    break
                try:
                    await asyncio.wait(futs, timeout=remaining,
                                       return_when=asyncio.FIRST_COMPLETED)
                finally:
                    for fut in futs:
                        fut.cancel()
            return ready()

        async def free_objects(object_ids):
            for oid in [ObjectID(b) for b in object_ids]:
                self._drop_object(oid)
            return True

        async def kv_put(ns, key, value, overwrite=True):
            if ns == "_runtime_env":
                self._bound_runtime_env_cache(len(value))
            k = (ns, key)
            if not overwrite and k in self.kv:
                return False
            self.kv[k] = value
            return True

        async def kv_get(ns, key):
            return self.kv.get((ns, key))

        async def kv_del(ns, key):
            if ns == "_runtime_env":
                self._drop_runtime_env_blob_file(key)
            return self.kv.pop((ns, key), None) is not None

        async def kv_keys(ns, prefix):
            return [k for (n, k) in self.kv if n == ns and k.startswith(prefix)]

        async def create_pg(pg_id, bundles, strategy, name):
            pgid = PlacementGroupID(pg_id)
            pg = PlacementGroupInfo(pgid, bundles, strategy, name)
            self.pgs[pgid] = pg
            self._try_reserve_pg(pg)
            # reservation is attempted synchronously: when it committed,
            # the reply says so and the client's ready() needs no second
            # round trip (the PG-cycle hot path is 1 RPC, not 3)
            return {"state": pg.state,
                    "bundle_nodes": [b.node_id.binary() if b.node_id else None
                                     for b in pg.bundles]}

        async def wait_pg(pg_id, timeout=None):
            pg = self.pgs.get(PlacementGroupID(pg_id))
            if pg is None:
                return {"state": "REMOVED"}
            if timeout is not None:
                try:
                    await asyncio.wait_for(pg.ready_event.wait(), timeout)
                except asyncio.TimeoutError:
                    pass
            else:
                await pg.ready_event.wait()
            return {"state": pg.state,
                    "bundle_nodes": [b.node_id.binary() if b.node_id else None
                                     for b in pg.bundles]}

        async def remove_pg(pg_id):
            pg = self.pgs.pop(PlacementGroupID(pg_id), None)
            if pg is not None and pg.state == "CREATED":
                # return only the unclaimed portion; in-use resources flow back
                # to the node ledger when their tasks release (pg is gone then)
                for b in pg.bundles:
                    node = self.nodes.get(b.node_id)
                    if node is not None:
                        for res, amt in b.available.items():
                            node.available[res] = node.available.get(res, 0) + amt
                self._kick()
            return True

        async def blocked(value):
            w = conn_state.get("worker")
            if w is not None and w.blocked != value:
                w.blocked = value
                if value:
                    self._release(w, cpu_only=True)
                self._kick()
            return True

        async def subscribe(channel, interest=None):
            conn = conn_state["conn"]
            self.subscribers.setdefault(channel, []).append(conn)
            if channel == "cluster_view":
                sub = self._make_view_sub(
                    interest, conn_state["worker"].node_id
                    if conn_state.get("worker") else None)
                if sub is not None:
                    # interest-scoped pubsub subscriber: tracked alongside
                    # the daemons' send state; pruned with the connection
                    self._sub_views[conn] = sub
                # late subscribers must not wait for the next view CHANGE
                # to learn the current one (object-directory payload
                # included wholesale — deltas only carry recent history)
                self._push_full_view(conn, pubsub=True, sub=sub)
            return True

        async def cluster_info():
            total: Dict[str, float] = {}
            avail: Dict[str, float] = {}
            for node in self.nodes.values():
                if not node.alive:
                    continue
                for r, v in node.resources.items():
                    total[r] = total.get(r, 0) + v
                for r, v in node.available.items():
                    avail[r] = avail.get(r, 0) + v
            return {
                "node_id": self.node_id.binary(),
                "session": self.session,
                "total_resources": total,
                "available_resources": avail,
                "labels": self.head_node.labels,
                "num_workers": len(self.workers),
                "num_nodes": len([n for n in self.nodes.values() if n.alive]),
                "actors": {a.hex(): info.state for a, info in self.actors.items()},
                "uptime": time.time() - self.start_time,
                "dashboard_port": getattr(self, "dashboard_port", None),
                "client_proxy_port": getattr(self, "client_proxy_port", None),
            }

        async def submit_job(entrypoint, metadata=None, env=None,
                             working_dir=None, job_id=None):
            return await self.job_manager.submit(
                entrypoint, metadata=metadata, env=env,
                working_dir=working_dir, job_id=job_id)

        async def get_job(job_id):
            return self.job_manager.get(job_id)

        async def list_jobs():
            return self.job_manager.list()

        async def stop_job(job_id):
            return self.job_manager.stop(job_id)

        async def job_logs(job_id):
            return self.job_manager.logs(job_id)

        async def cluster_demand():
            """Unmet resource demand: queued, dep-ready tasks whose asks
            don't fit any alive node's *available* resources right now
            (feeds the autoscaler, reference load_metrics semantics)."""
            demand = []
            for rec in self.queue:
                if rec.pending_deps:
                    continue
                if rec.spec["options"].get("placement_group"):
                    continue  # counted via its PG's unplaced bundles below
                res = rec.spec["options"].get("resources", {"CPU": 1})
                sel = rec.spec["options"].get("label_selector")
                if not any(n.matches_labels(sel) and n.fits(res)
                           for n in self._alive_nodes()):
                    demand.append(res)
            # pending placement groups count too
            for pg in self.pgs.values():
                if pg.state == "PENDING":
                    demand.extend(b.resources for b in pg.bundles
                                  if b.node_id is None)
            return demand

        async def job_counter_next():
            self.job_counter += 1
            return self.job_counter

        async def list_state(kind):
            return self._list_state(kind)

        async def train_event(run, phase, t0=None, t1=None, detail=None):
            """A train controller's lifecycle phase (group_start /
            death_detected / restore / resize / finished), appended to
            the merged flight-recorder stream so `ray_tpu.timeline()` (JAX package)
            renders train restarts alongside the epoch-fence/reconcile
            windows they ride."""
            self.lease_events.append({
                "ts": time.time(), "kind": f"train_{phase}", "run": run,
                "t0": t0, "t1": t1, **(detail or {})})
            return True

        async def chain_event(chain, kind, detail=None):
            """A compiled serve chain's failure-plane event (chain_fence /
            chain_failover), mirrored from the chain's private event log
            into the flight-recorder stream: `state.list_lease_events()`
            and the timeline reconcile row show replica-death windows on
            the compiled plane next to the scheduler's view. Never on
            the warm path — fences already pay control-plane RPCs."""
            if kind not in ("chain_fence", "chain_failover"):
                return False
            self.lease_events.append({
                "ts": time.time(), "kind": kind, "chain": chain,
                **(detail or {})})
            return True

        async def get_config():
            """The head's full flag table (ray-tpu config CLI, dashboard)."""
            return _config.GLOBAL.dump()

        async def reporter_stats():
            """Per-process stats for every registered worker (reference
            dashboard reporter module): RSS/CPU/threads from /proc."""
            page = os.sysconf("SC_PAGE_SIZE")
            tick = os.sysconf("SC_CLK_TCK")
            rows = []
            for w in self.workers.values():
                row = {"worker_id": w.worker_id.hex(), "pid": w.pid,
                       "is_driver": w.is_driver,
                       "node_id": w.node_id.hex(),
                       "actor": w.actor_id.hex() if w.actor_id else None,
                       "log_tag": getattr(w, "log_tag", None)}
                if w.node_id != self.node_id:
                    # remote pid: /proc here would be a STRANGER's process
                    row["alive"] = w.conn is not None and not w.conn.closed
                    row["remote"] = True
                    rows.append(row)
                    continue
                try:
                    with open(f"/proc/{w.pid}/stat") as f:
                        parts = f.read().rsplit(") ", 1)[1].split()
                    # fields after comm: state utime=11 stime=12 (0-based
                    # within this tail), num_threads=17, rss=21
                    row["cpu_seconds"] = round(
                        (int(parts[11]) + int(parts[12])) / tick, 2)
                    row["num_threads"] = int(parts[17])
                    row["rss_bytes"] = int(parts[21]) * page
                    row["alive"] = True
                except (OSError, IndexError, ValueError):
                    row["alive"] = False  # remote node or exited
                rows.append(row)
            return rows

        async def worker_stacks(worker_id):
            """Live thread stacks of one worker (cooperative py-spy)."""
            w = self.workers.get(WorkerID(worker_id))
            if w is None or w.conn is None or w.conn.closed:
                return None
            try:
                # bounded: a GIL-wedged worker (the exact case being
                # debugged) can't run its handler — report unreachable
                # instead of hanging the CLI/dashboard
                return await asyncio.wait_for(
                    w.conn.request("dump_stacks"), timeout=10.0)
            except asyncio.TimeoutError:
                return ("<worker did not respond within 10s — event loop "
                        "wedged (GIL-holding C call?); use kernel-level "
                        "tools for a non-cooperative dump>")

        async def log_batch(entries):
            """Tailed lines pushed by a node daemon's LogMonitor."""
            self._on_log_batch(entries)
            return True

        async def list_logs():
            """Log files known to the head: this machine's session log
            tree plus everything the ring has seen from remote nodes."""
            from ray_tpu_torch.core import worker_logs

            out = worker_logs.list_log_files(self.session)
            for name in self.log_ring:
                out.setdefault(name, None)  # remote: size unknown
            return [{"file": n, "size": s}
                    for n, s in sorted(out.items())]

        async def get_log(filename, tail=None):
            """Lines of one log file: full file when it lives on this
            machine, ring contents otherwise (remote nodes, no shared FS).
            File IO runs in an executor — a multi-GB log must not stall
            the head's event loop."""
            from ray_tpu_torch.core import worker_logs

            if os.sep in filename or filename.startswith("."):
                raise ValueError(f"bad log filename {filename!r}")
            lines = None
            path = worker_logs.find_log_file(self.session, filename)
            if path is not None:
                try:
                    lines = await asyncio.get_running_loop().run_in_executor(
                        None, worker_logs.read_log_lines, path,
                        int(tail) if tail else None)
                except OSError:
                    lines = None
            if lines is None:
                ring = self.log_ring.get(filename)
                if ring is None:
                    return None
                lines = list(ring)
                if tail:
                    lines = lines[-int(tail):]
            return lines

        async def acquire_lease(options):
            """Grant an idle worker to the requesting client for DIRECT
            task pushes — the reference's lease protocol
            (`normal_task_submitter.cc:328` RequestWorkerLease + `:515`
            PushNormalTask): once granted, same-shape submissions bypass
            this head entirely until the lease is released/revoked.

            With no idle worker, the request WAITS (bounded) for the next
            one instead of failing: under multi-client load the head-path
            queue would otherwise swallow every freed worker before any
            client could re-ask, starving leases exactly when they matter
            most (a multi-client throughput inversion)."""
            w = conn_state.get("worker")
            if w is None:
                return None
            resources = options.get("resources", {"CPU": 1})
            node = self._select_node(resources, options.get("label_selector"),
                                     options.get("scheduling_strategy",
                                                 "hybrid"))
            fits_now = node is not None
            if node is None:
                # no node has the resources FREE right now — but a node
                # whose total capacity covers the ask will free up; wait
                # there instead of failing (under full load availability
                # is zero by definition, yet that's exactly when a lease
                # pays the most)
                sel = options.get("label_selector")
                feasible = [n for n in self._alive_nodes()
                            if n.matches_labels(sel)
                            and all(n.resources.get(r, 0) >= v
                                    for r, v in resources.items())]
                if not feasible:
                    return None
                node = min(feasible, key=lambda n: n.utilization())
            venv_key = (options.get("runtime_env") or {}).get("pip_key")
            # an idle worker on a node whose ledger cannot cover the ask
            # is no grant: taking it would debit the ledger below zero (a
            # second num_gpus=1 lease on a node whose GPU an actor holds).
            # Such a request waits; _grant_lease_waiters checks the ledger
            lw = self._idle_worker_on(node, venv_key) if fits_now else None
            if lw is None:
                if fits_now:
                    self._request_worker(node, pip_key=venv_key)  # warm the pool
                fut = asyncio.get_running_loop().create_future()
                ent = {"resources": resources,
                       "selector": options.get("label_selector"),
                       "venv_key": venv_key, "node_id": None, "fut": fut}
                self._lease_waiters.append(ent)
                try:
                    lw = await asyncio.wait_for(fut, timeout=1.0)
                except (asyncio.TimeoutError, asyncio.CancelledError):
                    try:
                        self._lease_waiters.remove(ent)
                    except ValueError:
                        pass
                    return None
                # granted pre-acquired by _grant_lease_waiters
            else:
                self._acquire(lw, resources)
            lw.leased_to = w.worker_id
            self._last_dispatch_ts = time.monotonic()
            # head-granted lease = the client either had no feasible view
            # node or a daemon refused (spillback): record it in the merged
            # flight-recorder stream alongside daemon-local grants
            self.sched_totals["head_grants"] += 1
            self.lease_events.append(
                {"ts": time.time(), "kind": "head_grant",
                 "node_id": lw.node_id.hex(),
                 "worker": lw.worker_id.hex()[:12],
                 "client": w.worker_id.hex()[:12]})
            return {"worker_id": lw.worker_id.binary(),
                    "addr": (lw.host or "127.0.0.1", lw.port)}

        async def release_lease(worker_id):
            lw = self.workers.get(WorkerID(worker_id))
            if lw is not None and getattr(lw, "leased_to", None) is not None:
                lw.leased_to = None
                self.notify_task_done(lw)  # resources back + idle + kick
            return True

        async def task_done(task_id):
            w = conn_state.get("worker")
            if w is not None:
                self._task_event(TaskID(task_id), "", "FINISHED", worker=w)
                self.notify_task_done(w)
            return True

        async def worker_retiring():
            # max_calls reached: stop dispatching to this worker; it exits
            # right after its final task_done (reference max_calls semantics)
            w = conn_state.get("worker")
            if w is not None:
                w.retiring = True
                node = self.nodes.get(w.node_id)
                if node is not None and w in node.idle:
                    node.idle.remove(w)
            return True

        def _gen(gen_id: bytes, backpressure: int = 0) -> GeneratorState:
            gs = self.generators.get(gen_id)
            if gs is None:
                gs = self.generators[gen_id] = GeneratorState(backpressure)
            if backpressure:
                gs.backpressure = backpressure
            return gs

        async def generator_yield(gen_id, meta, backpressure=0):
            gs = _gen(gen_id, backpressure)
            self._seal(meta)
            if gs.released:
                # consumer is gone: nothing will ever fetch this item —
                # don't pin or queue it (it evicts once unreferenced)
                return True
            # queued items are pinned until the consumer takes delivery
            # (nobody holds a ref to them yet)
            self._pin(meta.object_id)
            gs.items.append(meta.object_id.binary())
            gs.wake(gs.consumer_waiters)
            # backpressure: hold the producer's reply until consumed catches up
            while (gs.backpressure and not gs.done
                   and len(gs.items) - gs.consumed > gs.backpressure):
                fut = asyncio.get_running_loop().create_future()
                gs.producer_waiters.append(fut)
                await fut
            return True

        async def generator_done(gen_id):
            gs = _gen(gen_id)
            gs.done = True
            gs.wake(gs.consumer_waiters)
            gs.wake(gs.producer_waiters)
            if gs.released:
                self.generators.pop(gen_id, None)
            return True

        async def generator_next(gen_id, index):
            gs = _gen(gen_id)
            gs.consumed = max(gs.consumed, index)
            gs.wake(gs.producer_waiters)
            while True:
                if index < len(gs.items):
                    item = gs.items[index]
                    if index not in gs.delivered:
                        gs.delivered.add(index)
                        # interest transfers to the consumer atomically with
                        # delivery: holder first, then the yield-pin drops —
                        # race-free at zero eviction grace
                        wc = conn_state.get("worker")
                        if wc is not None:
                            self._add_holder(ObjectID(item), wc.worker_id)
                        self._unpin(ObjectID(item))
                    return {"ref": item}
                # a failed generator task seals gen_id itself with the error;
                # the consumer receives it once, after draining real items
                err_meta = self.objects.get(ObjectID(gen_id))
                if err_meta is not None and err_meta.error:
                    return {"ref": gen_id, "error": True}
                if gs.done:
                    return {"done": True}
                fut = asyncio.get_running_loop().create_future()
                gs.consumer_waiters.append(fut)
                await fut

        async def generator_release(gen_id):
            """Consumer dropped its ObjectRefGenerator: unpin undelivered
            items and mark the stream released — NOT popped, or a still-
            producing task's later yields would recreate a fresh state
            whose pins nothing ever drops."""
            gs = self.generators.get(gen_id)
            if gs is None:
                return True
            for idx, item in enumerate(gs.items):
                if idx not in gs.delivered:
                    self._unpin(ObjectID(item))
            gs.released = True
            gs.wake(gs.consumer_waiters)
            gs.wake(gs.producer_waiters)
            if gs.done:
                self.generators.pop(gen_id, None)
            return True

        async def cancel_task(return_id, force=False):
            """ray.cancel: drop a queued task, or interrupt/kill a running
            one (reference CancelTask; force kills the worker)."""
            for rec in list(self.queue):
                if return_id in rec.spec["return_ids"]:
                    self.queue.remove(rec)  # shape-bucket removal
                    rec.cancelled = True
                    self._fail_task(rec, "task was cancelled", cancelled=True)
                    return "cancelled_queued"
            for w in self.workers.values():
                rec = w.current_record
                if rec is not None and return_id in rec.spec["return_ids"]:
                    rec.cancelled = True
                    rec.retries_left = 0
                    if force:
                        self._terminate_worker(w)
                        return "killed"
                    w.conn.push("cancel_task",
                                task_id=rec.spec["task_id"].binary())
                    return "interrupt_sent"
            return "not_found"

        async def actor_ready(actor_id, address):
            info = self.actors.get(ActorID(actor_id))
            if info is not None:
                # workers self-report loopback; substitute the host we see
                # them on so cross-node callers can reach the actor
                w = conn_state.get("worker")
                if w is not None and w.host:
                    address = (w.host, address[1])
                self.notify_actor_ready(info, address)
            return True

        async def actor_creation_failed(actor_id, cause):
            info = self.actors.get(ActorID(actor_id))
            if info is not None:
                w = info.worker
                info.restarts_left = 0  # constructor errors are not retried
                self._mark_actor_dead(info, f"creation failed: {cause}")
                if w is not None:
                    info.worker = None
                    w.actor_id = None
                    self._release(w)
                    self._tell_daemon_actor(w)
                    node = self.nodes.get(w.node_id)
                    if node is not None and w not in node.idle:
                        node.idle.append(w)
                    self._kick()
            return True

        import inspect

        return {k: v for k, v in locals().items() if inspect.iscoroutinefunction(v)}

    # ---------------------------------------------------------------- sched
    def _enqueue(self, rec: TaskRecord) -> None:
        self._unpin_task(rec)  # no-op for fresh records; retries re-pin
        rec.pinned = [ObjectID(dep) for dep in rec.spec.get("deps", [])]
        for oid in rec.pinned:
            self._pin(oid)  # inputs stay alive until the task finishes
        for dep in rec.spec.get("deps", []):
            oid = ObjectID(dep)
            if oid not in self.objects:
                self._maybe_reconstruct(oid)
                rec.pending_deps.add(oid)
                self.dep_index.setdefault(oid, []).append(rec)
        self.queue.append(rec)
        self._task_event(rec.task_id, rec.spec["options"].get("name", "task"),
                         "PENDING_ARGS_AVAIL" if rec.pending_deps
                         else "PENDING_NODE_ASSIGNMENT")
        self._kick()

    # ------------------------------------------------- object lifetime
    def _pin(self, oid: ObjectID) -> None:
        self.obj_pins[oid] = self.obj_pins.get(oid, 0) + 1
        self.obj_interest_seen.add(oid)
        self._evict_due.pop(oid, None)

    def _add_holder(self, oid: ObjectID, worker_id: WorkerID) -> None:
        """Head-side interest transfer: record `worker_id` as a holder
        ahead of its own (in-flight) ref_update inc, so handing it an
        object over a head-mediated reply is race-free at zero grace."""
        self.obj_holders.setdefault(oid, set()).add(worker_id)
        self.worker_holds.setdefault(worker_id, set()).add(oid)
        self.obj_interest_seen.add(oid)
        self._evict_due.pop(oid, None)

    def _unpin(self, oid: ObjectID) -> None:
        c = self.obj_pins.get(oid, 0) - 1
        if c <= 0:
            self.obj_pins.pop(oid, None)
            self._maybe_evict(oid)
        else:
            self.obj_pins[oid] = c

    def _unpin_task(self, rec: "TaskRecord") -> None:
        for oid in getattr(rec, "pinned", None) or []:
            self._unpin(oid)
        rec.pinned = []

    def _borrow_begin(self, oid: ObjectID, token: bytes,
                      sender: WorkerID) -> None:
        if token in self._committed_tokens:
            # the receiver's commit outraced this begin (distinct head
            # connections): the handoff already completed, drop both sides
            self._committed_tokens.pop(token, None)
            return
        self.borrow_pins[token] = (oid, sender)
        self.obj_borrows.setdefault(oid, set()).add(token)
        self.worker_borrows.setdefault(sender, set()).add(token)
        self.obj_interest_seen.add(oid)
        self._evict_due.pop(oid, None)

    def _borrow_commit(self, oid: ObjectID, token: bytes) -> None:
        ent = self.borrow_pins.pop(token, None)
        if ent is None:
            # begin not seen yet — remember so the late begin is a no-op.
            # Bounded: an overflowed token leaks one pin until its sender
            # dies, it never frees a live object.
            self._committed_tokens[token] = None
            while len(self._committed_tokens) > 200_000:
                self._committed_tokens.popitem(last=False)
            return
        self._drop_borrow(token, ent)

    def _drop_borrow(self, token: bytes, ent: tuple) -> None:
        oid, sender = ent
        toks = self.obj_borrows.get(oid)
        if toks is not None:
            toks.discard(token)
            if not toks:
                self.obj_borrows.pop(oid, None)
                self._maybe_evict(oid)
        sent = self.worker_borrows.get(sender)
        if sent is not None:
            sent.discard(token)
            if not sent:
                self.worker_borrows.pop(sender, None)

    def _maybe_evict(self, oid: ObjectID) -> None:
        if not self.refcount_enabled:
            return
        if (self.obj_holders.get(oid) or self.obj_pins.get(oid)
                or self.obj_borrows.get(oid)
                or self.lineage_dep_pins.get(oid)):
            return
        if oid not in self.obj_interest_seen:
            return  # newborn: its holder's first inc is still in flight
        if oid in self.objects or oid in self.lineage:
            self._evict_due[oid] = time.monotonic() + self.evict_grace_s
        else:
            # nothing registered and no interest left (e.g. a direct
            # actor-call result ref that was dropped): forget the id —
            # interest_seen must not grow by one entry per actor call.
            # The tombstone makes a late-arriving seal free itself.
            self.obj_interest_seen.discard(oid)
            self._tombstones[oid] = None
            while len(self._tombstones) > 100_000:
                self._tombstones.popitem(last=False)

    async def _evict_loop(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(min(max(self.evict_grace_s / 2, 0.05), 1.0))
            if not self._evict_due:
                continue
            now = time.monotonic()
            due = [oid for oid, t in self._evict_due.items() if t <= now]
            for oid in due:
                self._evict_due.pop(oid, None)
                if (self.obj_holders.get(oid) or self.obj_pins.get(oid)
                        or self.obj_borrows.get(oid)
                        or self.lineage_dep_pins.get(oid)):
                    continue
                try:
                    self._drop_object(oid)
                    self.objects_evicted += 1
                    self._publish("object_state",
                                  {"object_id": oid.binary(),
                                   "state": "EVICTED"})
                except Exception as e:
                    # one failing free (e.g. BufferError on an exported shm
                    # mapping) must not kill the eviction loop for the
                    # session — that silently reverts refcounting to a leak
                    print(f"[ray_tpu_torch] evict {oid.hex()} failed: {e!r}",
                          file=sys.stderr, flush=True)

    def _drop_object(self, oid: ObjectID) -> None:
        """Remove an object entirely: storage, directory entry, lineage,
        and the pins it held on nested refs."""
        meta = self.objects.pop(oid, None)
        if meta is not None and meta.kind in objdir.PULLABLE_KINDS:
            # the head's own pull-manager replica dies with the object too
            # (it is never directory-announced, so no push reaches it; a
            # cached copy surviving here could be served stale)
            pm = getattr(self, "pull_manager", None)
            if pm is not None:
                pm.drop(oid)
            # replicas on other nodes die with the canonical object: tell
            # their daemons to unlink before the location knowledge goes
            for node_hex in self.object_dir.locations(oid):
                if meta.node_id is not None \
                        and node_hex == meta.node_id.hex():
                    continue  # the primary; _free_meta reaches it below
                try:
                    n = self.nodes.get(NodeID.from_hex(node_hex))
                except Exception:
                    n = None
                if n is not None and n.conn is not None and n.alive:
                    try:
                        n.conn.push("drop_replica", object_id=oid.binary())
                    except Exception:
                        pass
            self._dir_announce(objdir.free_record(oid))
        self.obj_holders.pop(oid, None)
        for token in self.obj_borrows.pop(oid, set()):
            ent = self.borrow_pins.pop(token, None)
            if ent is not None:
                sent = self.worker_borrows.get(ent[1])
                if sent is not None:
                    sent.discard(token)
        self.obj_interest_seen.discard(oid)
        self._tombstones[oid] = None
        while len(self._tombstones) > 100_000:
            self._tombstones.popitem(last=False)
        self._evict_due.pop(oid, None)
        self._lineage_pop(oid)
        if meta is not None:
            self._free_meta(meta)
            for b in (meta.contained or []):
                self._unpin(ObjectID(b))

    def _lineage_record_spec(self, spec: dict) -> None:
        """Register a task spec as the producer of its return ids (shared
        by head-path submits and out-of-band `record_lineage` pushes)."""
        entry = {"spec": spec, "produced": set(),
                 "recon_left": spec["options"].get("max_retries", 3),
                 "bytes": self._spec_bytes(spec)}
        self._lineage_add_entry(entry)
        for rid in spec["return_ids"]:
            oid = ObjectID(rid)
            self._lineage_pop(oid)
            self.lineage[oid] = entry
            self.lineage_bytes += entry["bytes"]
            if oid in self.objects:
                # the result's seal outraced this record (lease results
                # ride the worker's connection, the record the driver's):
                # mark produced NOW or loss handling would treat the
                # object as still in flight and never reconstruct it
                entry["produced"].add(oid)
        while (len(self.lineage) > self.lineage_cap
               or self.lineage_bytes > self.lineage_bytes_cap):
            oldest = next(iter(self.lineage))
            self._lineage_pop(oldest)

    def _lineage_add_entry(self, entry: dict) -> None:
        """Pin a reconstructable task's inputs: reconstruction needs them
        (reference: lineage pinning in ReferenceCounter)."""
        entry["live_rids"] = len(entry["spec"]["return_ids"])
        for dep in entry["spec"].get("deps", []):
            oid = ObjectID(dep)
            self.lineage_dep_pins[oid] = self.lineage_dep_pins.get(oid, 0) + 1
            self._evict_due.pop(oid, None)

    def _lineage_pop(self, oid: ObjectID):
        old = self.lineage.pop(oid, None)
        if old is None:
            return None
        self.lineage_bytes -= old["bytes"]
        old["live_rids"] = old.get("live_rids", 1) - 1
        if old["live_rids"] <= 0:
            for dep in old["spec"].get("deps", []):
                doid = ObjectID(dep)
                c = self.lineage_dep_pins.get(doid, 0) - 1
                if c <= 0:
                    self.lineage_dep_pins.pop(doid, None)
                    self._maybe_evict(doid)
                else:
                    self.lineage_dep_pins[doid] = c
        return old

    def _free_meta(self, meta: ObjectMeta) -> None:
        """Free an object's storage wherever it lives: locally when this
        process can reach it, and via the owning node's daemon otherwise
        (real multi-host, or namespace isolation)."""
        if meta.kind == "device":
            w = self.workers.get(meta.owner) if meta.owner is not None else None
            if w is not None and w.conn is not None and not w.conn.closed:
                try:
                    w.conn.push("free_device_object",
                                object_id=meta.object_id.binary())
                except Exception:
                    pass
            return
        node = self.nodes.get(meta.node_id) if meta.node_id is not None else None
        if (node is not None and node.conn is not None and node.alive
                and meta.kind in ("shm", "arena", "spilled")):
            try:
                node.conn.push("free_object", meta=meta)
            except Exception:
                pass
        # the owning process must also drop its mapping/accounting — a
        # producer that never sees the eviction keeps the (unlinked) pages
        # mapped and its store's `used` counter inflated forever
        w = self.workers.get(meta.owner) if meta.owner is not None else None
        if w is not None and w.conn is not None and not w.conn.closed:
            try:
                w.conn.push("evicted_object", meta=meta)
            except Exception:
                pass
        if self.store.readable(meta):
            self.store.free(meta)

    def _seal(self, meta: ObjectMeta) -> None:
        if meta.kind in ("shm", "arena") and meta.node_id is not None:
            n = self.nodes.get(meta.node_id)
            if n is None or not n.alive:
                # a stale meta re-registered by a caching client (e.g. the
                # driver passing a ref onward): its data died with the
                # node — sealing it would resurrect a dangling pointer and
                # mask reconstruction
                return
        was_reconstructing = meta.object_id in self._reconstructing
        self._reconstructing.discard(meta.object_id)
        lin = self.lineage.get(meta.object_id)
        if lin is not None:
            # per RETURN id: a sealed sibling must not mark this one
            # reconstructable while its own seal is still in flight
            lin["produced"].add(meta.object_id)
        existing = self.objects.get(meta.object_id)
        if existing is not None:
            # objects are immutable: first seal wins (a racing retry must not
            # replace a good value, especially not with its own error).
            # Only free the loser's storage when it is DISTINCT from the
            # winner's — a re-registration of the same meta (a client
            # passing an adopted actor-reply ref onward) or an arena/device
            # entry keyed by object id refers to the winner's own storage,
            # and freeing it would destroy the live object.
            same_storage = (
                meta.kind == "inline"
                or (meta.kind == "arena" and existing.kind == "arena")
                or (meta.kind == "device" and existing.kind == "device")
                or (meta.kind == "shm" and existing.kind == "shm"
                    and meta.segment == existing.segment)
                or (meta.kind == "spilled" and existing.kind == "spilled"
                    and meta.spill_path == existing.spill_path)
                # re-registration of a stale pre-spill meta: the canonical
                # entry moved to disk but the segment name is its old home —
                # only when the segments actually match; a retried task's
                # duplicate copy has a fresh segment and must be freed
                or (existing.kind == "spilled" and meta.kind == "shm"
                    and meta.segment == existing.segment))
            if not same_storage:
                self._free_meta(meta)  # a genuinely distinct duplicate copy
            return
        self.objects[meta.object_id] = meta
        if was_reconstructing and lin is not None and not meta.error:
            # a genuinely NEW seal of a lost return id (a surviving
            # sibling's duplicate re-seal returns above, so this counts
            # exactly the lost partitions that were rebuilt)
            self.sched_totals["reconstructs"] += 1
            if lin["spec"]["options"].get("data_stage"):
                self.sched_totals["data_reconstructs"] += 1
        if meta.kind in objdir.PULLABLE_KINDS:
            self._dir_announce(objdir.seal_record(meta))
        self._publish("object_state", {"object_id": meta.object_id.binary(),
                                       "state": "SEALED",
                                       "size": meta.size,
                                       "node_id": (meta.node_id.binary()
                                                   if meta.node_id else None)})
        for b in (meta.contained or []):
            self._pin(ObjectID(b))  # nested refs live while container does
        if meta.object_id in self._tombstones:
            # every interest already came and went (ref dropped before the
            # producer finished, or a slow retry's duplicate): free now —
            # the newborn deferral must not resurrect it as a leak
            self.obj_interest_seen.add(meta.object_id)
            self._evict_due[meta.object_id] = time.monotonic()
        self._maybe_evict(meta.object_id)  # fire-and-forget results: nobody
        # may hold a ref by the time the result arrives
        if meta.kind in ("shm", "arena"):
            # accounting + LRU/spill tracking; when the head can't see the
            # object (isolation / real multi-host) the owning node daemon
            # tracks it instead, so capacity enforcement still happens
            if not self.store.adopt(meta):
                n = self.nodes.get(meta.node_id) if meta.node_id else None
                if n is not None and n.conn is not None and n.alive:
                    n.conn.push("adopt_object", meta=meta)
        if meta.error and meta.object_id.binary() in self.generators:
            # a failed generator task: consumers drain produced items, then
            # receive the error ref (generator_next checks this meta)
            gs = self.generators[meta.object_id.binary()]
            gs.done = True
            gs.wake(gs.consumer_waiters)
            gs.wake(gs.producer_waiters)
        for fut in self.object_waiters.pop(meta.object_id, []):
            if not fut.done():
                fut.set_result(meta)
        for rec in self.dep_index.pop(meta.object_id, []):
            rec.pending_deps.discard(meta.object_id)
        self._kick()

    def _alive_nodes(self) -> List[NodeInfo]:
        return [n for n in self.nodes.values() if n.alive]

    def _select_node(self, resources: Dict[str, float],
                     label_selector: Optional[dict] = None,
                     strategy: str = "hybrid") -> Optional[NodeInfo]:
        """Hybrid policy (reference scheduling_policy.h:35-57): prefer the
        head/local node until utilization crosses a threshold, then pack the
        lowest-utilization feasible node; SPREAD picks least-utilized."""
        candidates = [n for n in self._alive_nodes()
                      if n.matches_labels(label_selector) and n.fits(resources)]
        if not candidates:
            return None
        if strategy == "spread":
            return min(candidates, key=lambda n: n.utilization())
        head_first = [n for n in candidates if n.is_head]
        if head_first and head_first[0].utilization() < 0.8:
            return head_first[0]
        return min(candidates, key=lambda n: n.utilization())

    def _pg_for(self, options: dict) -> Optional[PlacementGroupInfo]:
        pgb = options.get("placement_group")
        return self.pgs.get(PlacementGroupID(pgb)) if pgb else None

    def _find_pg_slot(self, pg: PlacementGroupInfo, resources: Dict[str, float],
                      bundle_index: Optional[int]) -> Optional[BundleState]:
        if pg.state != "CREATED":
            return None
        if bundle_index is not None and bundle_index >= 0:
            b = pg.bundles[bundle_index]
            return b if b.fits(resources) else None
        for b in pg.bundles:
            if b.fits(resources):
                return b
        return None

    def _idle_worker_on(self, node: NodeInfo,
                        venv_key: Optional[str] = None
                        ) -> Optional[WorkerInfo]:
        # exact venv match both ways: plain tasks never land on a
        # pip-isolated worker, pip tasks only on THEIR venv's workers
        # (reference per-runtime-env worker pools, worker_pool.h:274)
        for i in range(len(node.idle) - 1, -1, -1):
            w = node.idle[i]
            if w.conn.closed:
                del node.idle[i]
                continue
            if w.venv_key == venv_key:
                del node.idle[i]
                return w
        return None

    def _acquire(self, w: WorkerInfo, resources: Dict[str, float],
                 pg: Optional[PlacementGroupInfo] = None,
                 bundle: Optional[BundleState] = None) -> None:
        if bundle is not None:
            ledger = bundle.available
            w.acquired_pg = pg.pg_id
            w.acquired_bundle = bundle.index
        else:
            ledger = self.nodes[w.node_id].available
            w.acquired_pg = None
            w.acquired_bundle = None
        for r, amt in resources.items():
            ledger[r] = ledger.get(r, 0) - amt
        w.acquired = dict(resources)

    def _release(self, w: WorkerInfo, cpu_only: bool = False) -> None:
        ledger = None
        if w.acquired_pg is not None:
            pg = self.pgs.get(w.acquired_pg)
            if pg is not None and w.acquired_bundle is not None:
                ledger = pg.bundles[w.acquired_bundle].available
        if ledger is None:
            # pg removed while the work ran (or non-pg): back to the node
            node = self.nodes.get(w.node_id)
            ledger = node.available if node is not None else {}
        for r, amt in list(w.acquired.items()):
            if cpu_only and r != "CPU":
                continue
            ledger[r] = ledger.get(r, 0) + amt
            del w.acquired[r]
        if not w.acquired:
            w.acquired_pg = None
            w.acquired_bundle = None

    def _try_dispatch(self, rec: TaskRecord,
                      want_workers: int = 1) -> Optional[str]:
        """Try to place+dispatch one task. Returns None on success, else a
        reason to stay queued ('resources' | 'worker') — or fails the task."""
        options = rec.spec["options"]
        resources = options.get("resources", {"CPU": 1})
        renv = options.get("runtime_env") or {}
        venv_key, pip = renv.get("pip_key"), renv.get("pip")
        if options.get("placement_group"):
            pg = self._pg_for(options)
            if pg is None:
                self._fail_task(rec, "placement group was removed")
                return None
            bundle = self._find_pg_slot(pg, resources,
                                        options.get("placement_group_bundle_index"))
            if bundle is None:
                return "resources"
            node = self.nodes.get(bundle.node_id)
            if node is None or not node.alive:
                return "resources"
            w = self._idle_worker_on(node, venv_key)
            if w is None:
                for _ in range(max(1, want_workers)):
                    self._request_worker(node, pip, venv_key)
                return "worker"
            self._acquire(w, resources, pg, bundle)
        else:
            node = self._select_node(resources, options.get("label_selector"),
                                     options.get("scheduling_strategy", "hybrid"))
            if node is None:
                return "resources"
            w = self._idle_worker_on(node, venv_key)
            if w is None:
                for _ in range(max(1, want_workers)):
                    self._request_worker(node, pip, venv_key)
                return "worker"
            self._acquire(w, resources)
        w.running_task = rec.task_id
        w.current_record = rec
        rec.dispatch_ts = time.time()
        self._last_dispatch_ts = time.monotonic()
        self._task_event(rec.task_id, rec.spec["options"].get("name", "task"),
                         "RUNNING", worker=w)
        spec = rec.spec
        if spec["options"].get("data_stage") and spec.get("deps"):
            # ship the deps' metas with the dispatch so the worker's
            # argument resolution pulls straight through its node's
            # PullManager instead of round-tripping get_meta per block
            # (a reconstructed reduce task resolves rebuilt sub-blocks
            # the same way: a stale meta falls back to locate_object)
            dm = [self.objects.get(ObjectID(d)) for d in spec["deps"]]
            dm = [m for m in dm
                  if m is not None and m.kind in objdir.PULLABLE_KINDS]
            if dm:
                spec = dict(spec)
                spec["dep_metas"] = dm
        w.conn.push("exec_task", spec=spec)
        return None

    def _kick(self) -> None:
        """Dispatch as many queued tasks as possible; spawn workers if useful.

        Re-entrancy-safe: dispatch failure paths (_fail_task → _seal) call
        _kick again; a nested call mutating the deques mid-scan would make
        outer frames pop records the nested pass already handled. Nested
        calls just set a flag and the outermost frame loops."""
        if self._shutdown:
            return
        if getattr(self, "_kick_active", False):
            self._kick_again = True
            return
        self._kick_active = True
        try:
            while True:
                self._kick_again = False
                self._retry_pending_pgs()
                self.queue.scan(self._try_dispatch)
                now = time.monotonic()
                for info in self.actors.values():
                    if (info.state in ("PENDING", "RESTARTING")
                            and info.worker is None
                            and info.readopt_until <= now):
                        self._schedule_actor(info)
                if not self._kick_again:
                    break
        finally:
            self._kick_active = False
        self._spawn_for_demand()

    def _schedule_actor(self, info: ActorInfo) -> None:
        options = info.spec["options"]
        resources = options.get("resources", {"CPU": 0})
        renv = options.get("runtime_env") or {}
        venv_key, pip = renv.get("pip_key"), renv.get("pip")
        if options.get("placement_group"):
            pg = self._pg_for(options)
            if pg is None:
                self._mark_actor_dead(info, "placement group was removed")
                return
            bundle = self._find_pg_slot(pg, resources,
                                        options.get("placement_group_bundle_index"))
            if bundle is None:
                return
            node = self.nodes.get(bundle.node_id)
            if node is None or not node.alive:
                return
            w = self._idle_worker_on(node, venv_key)
            if w is None:
                self._request_worker(node, pip, venv_key)
                return
            self._acquire(w, resources, pg, bundle)
        else:
            node = self._select_node(resources, options.get("label_selector"),
                                     options.get("scheduling_strategy", "hybrid"))
            if node is None:
                return
            w = self._idle_worker_on(node, venv_key)
            if w is None:
                self._request_worker(node, pip, venv_key)
                return
            self._acquire(w, resources)
        w.actor_id = info.actor_id
        info.worker = w
        w.conn.push("start_actor", spec=info.spec)
        self._tell_daemon_actor(w)

    # -------------------------------------------------------------- workers
    def _request_worker(self, node: NodeInfo, pip=None,
                        pip_key=None) -> None:
        alive = len(node.workers)
        if alive + node.starting_workers >= node.max_workers:
            return
        node.starting_workers += 1
        if node.conn is None:
            self._spawn_local_worker(pip, pip_key)
        else:
            node.conn.push("spawn_worker", pip=pip, pip_key=pip_key)

    def _spawn_for_demand(self) -> None:
        # each queued-but-dispatchable task/actor has already issued a
        # _request_worker for its chosen node inside _try_dispatch; nothing
        # further to do here beyond a safety valve for empty pools
        if not self.queue:
            return
        # fairness valve: reclaim a leased worker ONLY on a genuine
        # dispatch stall (no task dispatched and no lease granted for a
        # while with work queued). Revoking on every transient queue
        # blip cancels leases the instant they're granted, and the
        # resulting all-head-path traffic inverted multi-client
        # throughput.
        if time.monotonic() - getattr(self, "_last_dispatch_ts", 0.0) < 0.5:
            return
        for lw in self.workers.values():
            if lw.leased_to is not None:
                holder = self.workers.get(lw.leased_to)
                if (holder is not None and holder.conn is not None
                        and not holder.conn.closed):
                    holder.conn.push("lease_revoke",
                                     worker_id=lw.worker_id.binary())
                    self._last_dispatch_ts = time.monotonic()  # one at a time
                    break

    def _spawn_local_worker(self, pip=None, pip_key=None) -> None:
        from ray_tpu_torch.core.resources import strip_device_env

        env = strip_device_env(dict(os.environ))
        env["RAY_TPU_HEAD_PORT"] = str(self.port)
        env["RAY_TPU_SESSION"] = self.session
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        # head-node workers route remote pulls through the head's data
        # server pull manager (same once-per-node contract as daemons)
        env["RAY_TPU_NODE_DATA_PORT"] = str(self.data_port)
        if not pip:
            self._popen_worker(sys.executable, env)
            return
        # venv materialization runs pip (seconds): NEVER on the head's
        # event loop. Build on a thread, hop back to spawn.
        from ray_tpu_torch.core import runtime_env as _renv

        env["RAY_TPU_VENV_KEY"] = pip_key or _renv.pip_env_key(pip)
        loop = asyncio.get_event_loop()

        def _build():
            try:
                python = _renv.materialize_venv(pip, pip_key)
            except Exception as e:
                print(f"[ray_tpu_torch] venv materialization failed: {e!r}",
                      flush=True)
                # release the starting slot so the request can retry
                loop.call_soon_threadsafe(self._venv_spawn_failed)
                return
            loop.call_soon_threadsafe(self._popen_worker, python, env)

        import threading as _threading

        _threading.Thread(target=_build, daemon=True,
                          name="venv-build").start()

    def _venv_spawn_failed(self) -> None:
        self.head_node.starting_workers = max(
            0, self.head_node.starting_workers - 1)
        self._kick()

    def _popen_worker(self, python: str, env: dict) -> None:
        from ray_tpu_torch.core import worker_logs

        # fd-level stdio capture into the session log dir (reference
        # node.py:1426 worker redirection); unbuffered so a task's print()
        # reaches the tailer (and the driver) promptly
        out, err, tag = worker_logs.open_worker_logs(self.session)
        env = dict(env)
        env["RAY_TPU_LOG_TAG"] = tag
        env.setdefault("PYTHONUNBUFFERED", "1")
        with out, err:
            proc = subprocess.Popen(
                [python, "-m", "ray_tpu_torch.core.worker_main"],
                env=env, stdout=out, stderr=err)
        self._spawned[proc.pid] = proc

    def _on_log_batch(self, entries: List[dict]) -> None:
        """Freshly tailed worker-log lines (local monitor thread or a node
        daemon's push): retain in the ring and stream to every connected
        driver, where they print — a remote task's print() is visible at
        the submitting terminal by default (reference log_monitor →
        pubsub → driver print_logs path)."""
        from ray_tpu_torch.core.worker_logs import RING_LINES

        tags = {w.log_tag: w.pid for w in self.workers.values()
                if getattr(w, "log_tag", None)}
        for e in entries:
            stem = e["file"].rsplit(".", 1)[0]
            pid = tags.get(stem[len("worker-"):]) if \
                stem.startswith("worker-") else None
            if pid is not None:
                e["pid"] = pid
            ring = self.log_ring.get(e["file"])
            if ring is None:
                ring = self.log_ring[e["file"]] = deque(maxlen=RING_LINES)
                from ray_tpu_torch.core.worker_logs import MAX_LOG_FILES_RETAINED

                while len(self.log_ring) > MAX_LOG_FILES_RETAINED:
                    self.log_ring.popitem(last=False)
            else:
                self.log_ring.move_to_end(e["file"])
            ring.extend(e["lines"])
        for w in self.workers.values():
            if w.is_driver and w.conn is not None and not w.conn.closed:
                try:
                    w.conn.push("log_lines", entries=entries)
                except Exception:
                    pass

    def _on_worker_disconnect(self, w: WorkerInfo) -> None:
        # a dead process holds nothing: release its ref interest and any
        # borrow pins it opened that were never committed (payloads it
        # serialized but nobody ever deserialized)
        for token in list(self.worker_borrows.pop(w.worker_id, set())):
            ent = self.borrow_pins.pop(token, None)
            if ent is not None:
                self._drop_borrow(token, ent)
        for oid in self.worker_holds.pop(w.worker_id, set()):
            hs = self.obj_holders.get(oid)
            if hs is not None:
                hs.discard(w.worker_id)
                if not hs:
                    self.obj_holders.pop(oid, None)
                    self._maybe_evict(oid)
        # newborn sweep: objects this process owned whose first inc never
        # flushed (it died inside the flush window) would otherwise defer
        # eviction forever — its death IS the interest event
        for oid, meta in list(self.objects.items()):
            if meta.owner == w.worker_id and oid not in self.obj_interest_seen:
                self.obj_interest_seen.add(oid)
                self._maybe_evict(oid)
        # a dead client's leased workers go back to the pool
        for lw in self.workers.values():
            if lw.leased_to == w.worker_id:
                lw.leased_to = None
                self.notify_task_done(lw)
        if w.pooled:
            # tell the owning daemon its pooled worker died so it drops
            # the pool entry (the resource carve-out was released above
            # via _release once the loop below runs)
            node_ = self.nodes.get(w.node_id)
            if node_ is not None and node_.conn is not None \
                    and not node_.conn.closed:
                try:
                    node_.conn.push("pool_worker_died",
                                    worker_id=w.worker_id.binary())
                except Exception:
                    pass
        self.workers.pop(w.worker_id, None)
        # a dead process's metrics snapshot must stop being scraped — the
        # pre-fix behavior left proc:<id> keys in the _metrics namespace
        # forever, so /metrics reported gauges of processes long gone
        mkey = f"proc:{w.worker_id.hex()}".encode()
        self.kv.pop(("_metrics", mkey), None)
        self._metrics_parsed.pop(mkey, None)
        node = self.nodes.get(w.node_id)
        if node is not None:
            node.workers.discard(w.worker_id)
            if w in node.idle:
                node.idle.remove(w)
            node.unadopted.discard(w)
        self._release(w)
        rec = getattr(w, "current_record", None)
        if rec is not None and w.running_task is not None:
            if rec.cancelled:
                self._fail_task(rec, "task was cancelled", cancelled=True)
            elif rec.retries_left > 0:
                rec.retries_left -= 1
                rec.pending_deps = set()
                self._enqueue(rec)
            else:
                self._fail_task(rec, f"worker {w.worker_id} died (pid {w.pid})")
        if w.actor_id is not None:
            info = self.actors.get(w.actor_id)
            if info is not None and info.state != "DEAD":
                info.worker = None
                info.address = None
                if info.restarts_left != 0:
                    if info.restarts_left > 0:
                        info.restarts_left -= 1
                    info.state = "RESTARTING"
                    info.ready_event = asyncio.Event()
                    self._publish("actor_state", {"actor_id": w.actor_id.binary(),
                                                  "state": "RESTARTING"})
                    self._schedule_actor(info)
                else:
                    self._mark_actor_dead(info, f"worker died (pid {w.pid})")
        if w.is_driver:
            pass  # job cleanup: objects are session-scoped
        self._kick()

    def _purge_stale_worker(self, w: WorkerInfo) -> None:
        """A superseded WorkerInfo's connection closed after a
        re-registration replaced it in `self.workers`: drop the stale
        object from idle/parked lists, return its resources, and retry
        its in-flight task — WITHOUT the full disconnect teardown (the
        worker id is alive under a fresh WorkerInfo)."""
        node = self.nodes.get(w.node_id)
        if node is not None:
            if w in node.idle:
                node.idle.remove(w)
            node.unadopted.discard(w)
        self._release(w)
        rec = getattr(w, "current_record", None)
        if rec is not None and w.running_task is not None:
            if rec.cancelled:
                self._fail_task(rec, "task was cancelled", cancelled=True)
            elif rec.retries_left > 0:
                rec.retries_left -= 1
                rec.pending_deps = set()
                self._enqueue(rec)
            else:
                self._fail_task(
                    rec, f"worker {w.worker_id} died (pid {w.pid})")
        self._kick()

    def _maybe_reconstruct(self, oid: ObjectID) -> None:
        """Re-run the producing task of a lost object (lineage
        reconstruction, reference `object_recovery_manager.cc`): first seal
        wins, so racing consumers are safe."""
        if oid in self.objects or oid in self._reconstructing:
            return
        entry = self.lineage.get(oid)
        if entry is None:
            if oid in self._lost_pending:
                # lost with lineage, but the entry was cap-evicted before a
                # consumer asked: fail loudly instead of hanging
                self._lost_pending.discard(oid)
                self._seal_lost(oid, "object lost and its lineage entry was "
                                     "evicted before reconstruction")
            return
        if oid not in entry["produced"]:
            # not produced yet → the original task is still in flight; a
            # spurious resubmission here would race it (duplicate writes)
            return
        self._lost_pending.discard(oid)
        spec = entry["spec"]
        if entry["recon_left"] <= 0:
            # reconstruction budget exhausted (flapping node / poisoned
            # task): fail consumers instead of resubmitting forever
            self._seal_lost(oid, "object lost; reconstruction attempts "
                                 "exhausted")
            return
        entry["recon_left"] -= 1
        for rid in spec["return_ids"]:
            self._reconstructing.add(ObjectID(rid))
        self._task_event(spec["task_id"], spec["options"].get("name", "task"),
                         "PENDING_RECONSTRUCTION")
        self.lease_events.append({
            "ts": time.time(), "kind": "object_reconstruct",
            "object_id": oid.hex()[:16],
            "task": spec["options"].get("name", "task"),
            "data_stage": bool(spec["options"].get("data_stage"))})
        self._enqueue(TaskRecord(spec, None))

    @staticmethod
    def _spec_bytes(spec: dict) -> int:
        args = spec.get("args")
        n = 256
        if isinstance(args, (bytes, bytearray, memoryview)):
            n += len(args)
        elif isinstance(args, (list, tuple)):
            n += sum(len(a) for a in args
                     if isinstance(a, (bytes, bytearray, memoryview)))
        return n

    def _node_alive(self, node_id: NodeID) -> bool:
        n = self.nodes.get(node_id)
        return n is not None and n.alive

    def _handle_lost_object(self, oid: ObjectID, where: str) -> None:
        """Every reachable copy of a produced object is gone: drop the
        meta and either reconstruct from lineage or seal an
        ObjectLostError for parked/future consumers. Shared by direct
        node death and last-replica loss (a replica-backed object whose
        primary died earlier loses its final copy later — eviction of
        the replica, or the replica node dying too)."""
        meta = self.objects.pop(oid, None)
        if meta is None:
            return
        self._evict_due.pop(oid, None)
        for b in (meta.contained or []):
            self._unpin(ObjectID(b))
        try:
            # unlink the dead copy's storage now: the meta is the only
            # handle to the arena entry / shm segment, and nothing can
            # free it once replaced by an error or a rebuilt copy
            self.store.free(meta)
        except Exception:
            pass
        entry = self.lineage.get(oid)
        if entry is None or oid not in entry["produced"]:
            # no lineage (ray.put / evicted entry): cannot rebuild —
            # mark lost now so parked AND future consumers raise
            # ObjectLostError instead of hanging forever
            self._seal_lost(
                oid, f"object {oid.hex()} lost with {where} "
                     f"and has no lineage")
        elif oid in self.object_waiters:
            self._maybe_reconstruct(oid)
        else:
            self._lost_pending.add(oid)

    def _seal_lost(self, oid: ObjectID, cause: str) -> None:
        """Seal an error object so parked and future consumers raise
        ObjectLostError instead of hanging forever."""
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.core.exceptions import ObjectLostError

        err = serialization.serialize(ObjectLostError(cause))
        meta = ObjectMeta(oid, err.frame_bytes, "inline",
                          inline=err.to_bytes(), error=True)
        self._seal(meta)

    def _on_node_disconnect(self, node: NodeInfo) -> None:
        """Node daemon lost: the reference's GcsHealthCheckManager dead-node
        path (node table update + pubsub + per-worker failure handling)."""
        node.alive = False
        self.nodes.pop(node.node_id, None)
        mkey = f"proc:node-{node.node_id.hex()[:12]}".encode()
        self.kv.pop(("_metrics", mkey), None)
        self._metrics_parsed.pop(mkey, None)
        self.lease_events.append({"ts": time.time(), "kind": "node_dead",
                                  "node_id": node.node_id.hex()})
        # its primaries and replicas are unreachable: purge every cached
        # directory's knowledge of them (lost primaries additionally go
        # through _seal_lost/reconstruction below)
        self._dir_announce(objdir.node_dead_record(node.node_id.hex()))
        # objects whose data lived on that node are gone; drop their metas
        # and lazily reconstruct from lineage when next requested (waiters
        # already parked get kicked now)
        lost = [oid for oid, m in self.objects.items()
                if m.node_id == node.node_id
                and m.kind in ("shm", "arena", "device")]
        dead_hex = node.node_id.hex()
        for oid in lost:
            meta = self.objects[oid]
            if meta.kind in ("shm", "arena") and any(
                    h != dead_hex
                    for h in self.object_dir.locations(oid)):
                # a pulled replica on a surviving node still serves the
                # bytes (the node_dead announcement above kept the entry
                # for exactly this case): no loss, no reconstruction
                continue
            self._handle_lost_object(oid, f"node {dead_hex}")
        # objects whose PRIMARY died earlier and that this node carried
        # the LAST replica of just lost their final copy too
        for oid in [o for o, m in self.objects.items()
                    if m.kind in ("shm", "arena")
                    and m.node_id is not None
                    and m.node_id != node.node_id
                    and not self._node_alive(m.node_id)
                    and not self.object_dir.locations(o)]:
            self._handle_lost_object(oid, f"last replica on {dead_hex}")
        self._publish("node_state", {"node_id": node.node_id.binary(),
                                     "state": "DEAD"})
        # PG bundles on that node lose their reservation; re-reserve
        for pg in self.pgs.values():
            if any(b.node_id == node.node_id for b in pg.bundles):
                pg.state = "PENDING"
                pg.ready_event = asyncio.Event()
                for b in pg.bundles:
                    surviving = self.nodes.get(b.node_id)
                    if surviving is not None and b.node_id != node.node_id:
                        for r, amt in b.available.items():
                            surviving.available[r] = surviving.available.get(r, 0) + amt
                    b.node_id = None
                    b.available = {}
                self._try_reserve_pg(pg)
        # workers on the node: their conns will close; handle proactively so
        # retries don't wait on TCP timeouts
        for wid in list(node.workers):
            w = self.workers.get(wid)
            if w is not None and not w.conn.closed:
                asyncio.ensure_future(w.conn.close())
        self._kick()
        self._view_changed()

    def _mark_actor_dead(self, info: ActorInfo, cause: str) -> None:
        info.state = "DEAD"
        info.death_cause = cause
        info.ready_event.set()
        # no further restart will deserialize the creation args: release
        # the borrow pins their pickled refs opened (idempotent)
        self._release_spec_borrows(info.spec)
        self._publish("actor_state", {"actor_id": info.actor_id.binary(),
                                      "state": "DEAD", "cause": cause})

    def _release_spec_borrows(self, spec: dict) -> None:
        for b, token in spec.get("borrows") or []:
            self._borrow_commit(ObjectID(b), token)

    def _terminate_worker(self, w: WorkerInfo) -> None:
        if w.proc is not None:
            try:
                w.proc.kill()
                return
            except ProcessLookupError:
                return
        node = self.nodes.get(w.node_id)
        if node is not None and node.conn is not None and not node.conn.closed:
            node.conn.push("kill_worker", pid=w.pid)
            return
        try:
            os.kill(w.pid, 9)
        except ProcessLookupError:
            pass

    def _fail_task(self, rec: TaskRecord, cause: str,
                   cancelled: bool = False) -> None:
        self._unpin_task(rec)
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.core.exceptions import (TaskCancelledError,
                                             WorkerCrashedError)

        self._task_event(rec.task_id, rec.spec["options"].get("name", "task"),
                         "FAILED", error=cause)

        exc = (TaskCancelledError(cause) if cancelled
               else WorkerCrashedError(cause))
        err = serialization.serialize(exc)
        for rid in rec.spec["return_ids"]:
            meta = self.store.put_serialized(ObjectID(rid), err)
            meta.error = True
            self._seal(meta)
        self._release_spec_borrows(rec.spec)

    # ---------------------------------------------------- resource view
    def _view_changed(self) -> None:
        """Request an immediate (still coalesced) cluster-view broadcast."""
        if self._view_wake is not None:
            self._view_wake.set()

    # ------------------------------------------------- object directory
    def _dir_announce(self, rec: dict) -> None:
        """Apply a directory record locally and queue it for the next
        cluster_view broadcast. Deliberately does NOT wake the broadcast
        loop: object churn (a put storm) coalesces into one delta list
        per `view_broadcast_s` tick instead of one push per object."""
        if not _config.get("object_directory"):
            return
        self.object_dir.apply_record(rec)
        self._dir_seq += 1
        if len(self._dir_pending) >= 8192:
            # overflow: consumers get a wholesale resync instead of a
            # silently truncated delta stream
            self._dir_pending.clear()
            self._dir_full_resync = True
        else:
            self._dir_pending.append(rec)

    def _serve_loads_payload(self) -> Optional[list]:
        """Changed-only serve-replica load rows for the cluster_view
        broadcast: [{key, ts, stats}] drawn from the same merged
        `__workloads__` telemetry `list_serve_stats` serves. Returns None
        when nothing changed since the last broadcast (idle serve plane
        costs the broadcast nothing)."""
        rows = [{"key": r.get("key"), "ts": r.get("ts"),
                 "stats": r.get("stats")}
                for r in self._workload_rows()
                if r.get("kind") == "serve_replica"]
        rows.sort(key=lambda r: r.get("key") or "")
        if rows == self._last_serve_rows:
            return None
        self._last_serve_rows = rows
        return rows

    def _dir_payload(self) -> Optional[dict]:
        """Drain pending directory records into one broadcast payload."""
        if self._dir_full_resync:
            self._dir_full_resync = False
            self._dir_pending.clear()
            return self.object_dir.full_payload(self._dir_seq)
        if not self._dir_pending:
            return None
        delta, self._dir_pending = self._dir_pending, []
        return {"v": self._dir_seq, "delta": delta}

    def _build_view_snapshot(self) -> dict:
        from ray_tpu_torch.core import resource_view as rv

        nodes = []
        for n in self.nodes.values():
            if not n.alive:
                continue
            # per-node object-store pressure rides the view entries so
            # data-plane producers (the streaming executor's admission)
            # can shed load with zero extra RPCs; daemons gossip
            # store_used/store_cap in their stats, the head reads its own
            frac = None
            if n.is_head:
                cap = getattr(self.store, "capacity", 0)
                if cap:
                    frac = self.store.used / cap
            else:
                st = n.sched_stats or {}
                cap = st.get("store_cap") or 0
                if cap:
                    frac = st.get("store_used", 0) / cap
            nodes.append(rv.make_entry(
                n.node_id.hex(), version=n.view_version, free=n.available,
                total=n.resources, labels=n.labels,
                idle_workers=n.pool_idle, sched_addr=n.sched_addr,
                data_addr=n.data_addr, is_head=n.is_head,
                store_frac=round(frac, 4) if frac is not None else None,
                pool_shapes=n.pool_shapes))
        return {"version": self._view_seq, "nodes": nodes,
                "epoch": self.cluster_epoch}

    async def _resolve_pull_sources(self, meta: ObjectMeta) -> list:
        """Pull-source addresses for the head's own pull manager: the
        authoritative directory's locations, primary first."""
        def addr_of(node_hex: str):
            try:
                n = self.nodes.get(NodeID.from_hex(node_hex))
            except Exception:
                return None
            return n.data_addr if n is not None and n.alive else None

        return objdir.resolve_addrs(self.object_dir, meta, addr_of,
                                    "127.0.0.1",
                                    exclude=self.node_id.hex())

    # ------------------------------------------- sharded view plane
    def _make_view_sub(self, interest, nid) -> Optional[dict]:
        """Resolve a subscriber's declared interest into scoped-send
        state. None (legacy full-fanout) when sharding is off or the
        subscriber declared none; "auto" scopes a node to its own shard
        — the shard carrying its entry and its neighborhood."""
        nshards = int(_config.get("view_shards"))
        if interest is None or nshards <= 1:
            return None
        from ray_tpu_torch.core.resource_view import shard_of

        if interest == "auto":
            if nid is None:
                return None
            scope = [shard_of(nid.hex(), nshards)]
        else:
            scope = sorted({int(s) % nshards for s in interest})
        return {"interest": scope, "sent": {}, "digest_ts": 0.0}

    def _note_shard_changes(self, prev: Optional[dict], cur: dict,
                            nshards: int) -> None:
        """Bump the version of every shard whose node set changed between
        two view snapshots — the delta-compaction cursor scoped
        subscribers are diffed against."""
        from ray_tpu_torch.core.resource_view import shard_of

        prev_by = {e["node_id"]: e for e in (prev or {}).get("nodes", ())}
        cur_by = {e["node_id"]: e for e in cur["nodes"]}
        dirty = set()
        for h, e in cur_by.items():
            if prev_by.get(h) != e:
                dirty.add(shard_of(h, nshards))
        for h in prev_by:
            if h not in cur_by:
                dirty.add(shard_of(h, nshards))
        for sid in dirty:
            self._shard_vs[sid] = self._shard_vs.get(sid, 0) + 1

    def _build_view_digest(self, snap: dict, nshards: int) -> dict:
        """Compact cluster-wide summary shipped with every scoped
        payload: the spillback-candidate rows (top warm pools, what a
        daemon needs to pick a peer outside its interest shards) and the
        total node count — O(digest_k), independent of cluster size."""
        k = max(int(_config.get("view_digest_k")), 1)
        cands = [e for e in snap["nodes"] if e.get("sched_addr")]
        cands.sort(key=lambda e: e.get("idle_workers", 0), reverse=True)
        return {"nshards": nshards, "total_nodes": len(snap["nodes"]),
                "candidates": [
                    {"node_id": e["node_id"],
                     "sched_addr": tuple(e["sched_addr"]),
                     "idle_workers": e.get("idle_workers", 0),
                     "labels": e.get("labels") or {},
                     "pool_shapes": e.get("pool_shapes")}
                    for e in cands[:k]]}

    def _dir_record_scope(self, rec: dict, nshards: int):
        """Shard set a directory record is relevant to, or None for
        global records (frees/node-death are small removal facts every
        consumer needs; a record for a node outside a subscriber's
        interest is skipped — that subscriber cold-misses into the
        locate_object fallback, which is the documented semantics)."""
        from ray_tpu_torch.core.resource_view import shard_of

        op = rec.get("op")
        if op in ("seal", "spill"):
            nid = rec["meta"].node_id
            return {shard_of(nid.hex(), nshards)} if nid is not None \
                else None
        if op in ("replica", "replica_gone"):
            sids = {shard_of(rec["node"], nshards)}
            ent = self.object_dir.entries.get(ObjectID(rec["oid"]))
            if ent is not None and ent.meta.node_id is not None:
                sids.add(shard_of(ent.meta.node_id.hex(), nshards))
            return sids
        return None  # free / node_dead: global

    def _scope_dir_payload(self, payload: Optional[dict], interest,
                           nshards: int,
                           scopes: Optional[list] = None) -> Optional[dict]:
        """Filter one directory broadcast payload to a subscriber's
        interest shards. `scopes` carries the per-record scope sets
        precomputed once per tick for delta payloads."""
        if payload is None or interest is None:
            return payload
        want = set(interest)
        if payload.get("full") is not None:
            from ray_tpu_torch.core.resource_view import shard_of

            kept = []
            for ent in payload["full"]:
                nid = ent["meta"].node_id
                sids = set()
                if nid is not None:
                    sids.add(shard_of(nid.hex(), nshards))
                sids.update(shard_of(h, nshards)
                            for h in ent.get("replicas") or ())
                if not sids or sids & want:
                    kept.append(ent)
            # prefix bindings are global facts (any decode node may need
            # any prefix) — they ride every scoped resync uncut
            return {"v": payload["v"], "full": kept,
                    "prefixes": payload.get("prefixes") or []}
        delta = payload.get("delta") or ()
        if scopes is None:
            scopes = [self._dir_record_scope(r, nshards) for r in delta]
        kept = [r for r, sids in zip(delta, scopes)
                if sids is None or sids & want]
        if not kept:
            return None
        return {"v": payload["v"], "delta": kept}

    def _scoped_view_payload(self, sub: dict, snap: dict, nshards: int,
                             digest: dict, shard_entries: dict,
                             dir_payload, dir_scopes, serve_payload,
                             now: float, refresh_s: float) -> Optional[dict]:
        """Build one scoped subscriber's payload for this tick: only its
        interest shards whose version moved past what it was last sent
        (each as a wholesale shard snapshot — replace semantics need no
        tombstones), its scoped slice of the directory delta, and the
        digest. None when it owes nothing this tick (digest refreshes
        ride a slower cadence than the broadcast loop)."""
        shards = []
        for sid in sub["interest"]:
            v = self._shard_vs.get(sid, 0)
            if v > sub["sent"].get(sid, -1):
                shards.append({"sid": sid, "v": v,
                               "nodes": shard_entries.get(sid, [])})
        objects = self._scope_dir_payload(dir_payload, sub["interest"],
                                          nshards, scopes=dir_scopes)
        if (not shards and objects is None and serve_payload is None
                and now - sub["digest_ts"] < refresh_s):
            return None
        for b in shards:
            sub["sent"][b["sid"]] = b["v"]
        sub["digest_ts"] = now
        payload = {"version": snap["version"], "epoch": self.cluster_epoch,
                   "nshards": nshards, "shards": shards, "digest": digest}
        if objects is not None:
            payload["objects"] = objects
        if serve_payload is not None:
            payload["workloads"] = serve_payload
        return payload

    def _push_full_view(self, conn, pubsub: bool = False,
                        sub: Optional[dict] = None) -> None:
        """Push the current view with a WHOLESALE object-directory payload
        to one connection (a late subscriber or a (re)registered daemon):
        delta broadcasts only carry changes since the last tick, and a
        joiner that missed history must not cold-miss on every object.
        Daemons take the raw `cluster_view` push; drivers/workers get the
        pubsub-wrapped flavor their subscription expects. A scoped
        subscriber (`sub`) gets ALL its interest shards as snapshots at
        their current versions plus the digest — never the full list."""
        snap = dict(self._last_view_snap or self._build_view_snapshot())
        snap.setdefault("version", self._view_seq)
        dir_on = _config.get("object_directory")
        if sub is not None:
            from ray_tpu_torch.core.resource_view import shard_of

            nshards = int(_config.get("view_shards"))
            shard_entries: Dict[int, list] = {}
            for e in snap["nodes"]:
                shard_entries.setdefault(
                    shard_of(e["node_id"], nshards), []).append(e)
            # reset the send cursor so _scoped_view_payload emits EVERY
            # interest shard as a fresh snapshot (one format owner for
            # registration-time and broadcast-tick scoped payloads)
            sub["sent"] = {}
            sub["digest_ts"] = 0.0
            snap = self._scoped_view_payload(
                sub, snap, nshards,
                self._build_view_digest(snap, nshards), shard_entries,
                (self.object_dir.full_payload(self._dir_seq)
                 if dir_on else None), None,
                self._last_serve_rows or None, time.monotonic(),
                refresh_s=0.0)
        else:
            if dir_on:
                snap["objects"] = self.object_dir.full_payload(self._dir_seq)
            if self._last_serve_rows:
                # late joiners get the current serve-load rows immediately
                # instead of waiting for the next row change
                snap["workloads"] = self._last_serve_rows
        try:
            if pubsub:
                conn.push("pubsub", channel="cluster_view", msg=snap)
            else:
                conn.push("cluster_view", snap=snap)
        except Exception:
            pass

    async def _view_broadcast_loop(self) -> None:
        """Debounced push of the compacted cluster view to every node
        daemon and every subscribed driver (the head half of the
        ray_syncer role). Broadcasts only when the view actually changed;
        `_view_changed` wakes it early (node join/death, gossip delta).

        With `view_shards` > 1 the fan-out is interest-scoped: scoped
        subscribers receive only their changed interest shards (as shard
        snapshots versioned per shard) plus the compact digest, so a
        single node's pool churn costs O(shard size × interested
        subscribers), not O(nodes × subscribers) — the full-fanout
        broadcast that capped the gossip smoke at ~200 virtual nodes."""
        interval = _config.get("view_broadcast_s")
        if interval <= 0:
            return
        self._view_wake = asyncio.Event()
        while not self._shutdown:
            try:
                await asyncio.wait_for(self._view_wake.wait(), interval)
            except asyncio.TimeoutError:
                pass
            self._view_wake.clear()
            nshards = int(_config.get("view_shards"))
            sharding = nshards > 1
            snap = self._build_view_snapshot()
            nodes_changed = (self._last_view_snap is None
                             or snap["nodes"] != self._last_view_snap["nodes"])
            dir_payload = self._dir_payload()
            serve_payload = self._serve_loads_payload()
            refresh_s = float(_config.get("view_digest_refresh_s"))
            now_m = time.monotonic()
            digest_due = sharding and (
                any((now_m - n.view_sub["digest_ts"]) >= refresh_s
                    for n in self.nodes.values()
                    if n.view_sub is not None and n.alive)
                or any((now_m - s["digest_ts"]) >= refresh_s
                       for s in self._sub_views.values()))
            if (not nodes_changed and dir_payload is None
                    and serve_payload is None and not digest_due):
                continue
            if nodes_changed:
                self._view_seq += 1
                snap["version"] = self._view_seq
                if sharding:
                    self._note_shard_changes(self._last_view_snap, snap,
                                             nshards)
                self._last_view_snap = snap
            else:
                # object-directory-only tick: reuse the current view body
                # (version unchanged — consumers' version bookkeeping is
                # for the NODE entries; directory ordering rides dir v)
                snap = dict(self._last_view_snap)
            full_snap = snap
            if dir_payload is not None:
                full_snap = dict(full_snap)
                full_snap["objects"] = dir_payload
            if serve_payload is not None:
                full_snap = dict(full_snap)
                full_snap["workloads"] = serve_payload
            digest = shard_entries = dir_scopes = None
            if sharding:
                from ray_tpu_torch.core.resource_view import shard_of

                digest = self._build_view_digest(snap, nshards)
                shard_entries = {}
                for e in snap["nodes"]:
                    shard_entries.setdefault(
                        shard_of(e["node_id"], nshards), []).append(e)
                if dir_payload is not None and dir_payload.get("delta"):
                    dir_scopes = [self._dir_record_scope(r, nshards)
                                  for r in dir_payload["delta"]]
            now = time.monotonic()
            for node in self.nodes.values():
                if node.conn is None or not node.alive or node.conn.closed:
                    continue
                if sharding and node.view_sub is not None:
                    payload = self._scoped_view_payload(
                        node.view_sub, snap, nshards, digest,
                        shard_entries, dir_payload, dir_scopes,
                        serve_payload, now, refresh_s)
                    if payload is None:
                        continue
                    try:
                        node.conn.push("cluster_view", snap=payload)
                    except Exception:
                        pass
                    continue
                try:
                    node.conn.push("cluster_view", snap=full_snap)
                except Exception:
                    pass
            if sharding and self._sub_views:
                # scoped pubsub subscribers (pruned with their conns)
                for conn in [c for c in self._sub_views if c.closed]:
                    del self._sub_views[conn]
                for conn, sub in self._sub_views.items():
                    payload = self._scoped_view_payload(
                        sub, snap, nshards, digest, shard_entries,
                        dir_payload, dir_scopes, serve_payload, now,
                        refresh_s)
                    if payload is not None:
                        try:
                            conn.push("pubsub", channel="cluster_view",
                                      msg=payload)
                        except Exception:
                            pass
            conns = self.subscribers.get("cluster_view")
            if conns:
                live = [c for c in conns if not c.closed]
                if len(live) != len(conns):
                    self.subscribers["cluster_view"] = live  # prune dead
                scoped = ({id(c) for c in self._sub_views}
                          if sharding else ())
                for conn in live:
                    if id(conn) in scoped:
                        continue  # already served a scoped payload above
                    conn.push("pubsub", channel="cluster_view",
                              msg=full_snap)

    async def _pool_reclaim_loop(self) -> None:
        """Anti-starvation reclaim: daemon pools borrow ledger capacity,
        and nothing used to force it back before pool_idle_s — so a
        head-queued task whose only feasible nodes are fully pooled
        starved for the whole idle window. When dep-free queued tasks
        can't fit anywhere but a feasible node gossips idle POOL
        workers, push a pool_trim: the daemon releases one matching
        worker through the normal ack-tracked path and the queue drains
        within a tick instead of a pool-idle period."""
        while not self._shutdown:
            await asyncio.sleep(1.0)
            if not self.queue or self._shutdown:
                continue
            now = time.monotonic()
            needed = []
            for rec in self.queue:
                if rec.pending_deps:
                    continue
                needed.append(
                    (rec.spec["options"].get("resources") or {"CPU": 1},
                     rec.spec["options"].get("label_selector")))
                if len(needed) >= 8:
                    break
            for res, sel in needed:
                if any(n.alive and n.matches_labels(sel) and n.fits(res)
                       for n in self.nodes.values()):
                    continue  # schedulable: the normal kick will place it
                for node in self.nodes.values():
                    if (node.alive and node.conn is not None
                            and not node.conn.closed
                            and node.pool_idle > 0
                            and node.matches_labels(sel)
                            and node.could_ever_fit(res)
                            and not node.fits(res)
                            and now - getattr(node, "_last_trim_ts", 0.0)
                            > 2.0):
                        node._last_trim_ts = now
                        self.lease_events.append(
                            {"ts": time.time(), "kind": "pool_trim",
                             "node_id": node.node_id.hex()})
                        try:
                            node.conn.push("pool_trim", resources=res)
                        except Exception:
                            pass
                        break

    def _publish(self, channel: str, msg: dict) -> None:
        conns = self.subscribers.get(channel)
        if not conns:
            return
        live = [c for c in conns if not c.closed]
        if len(live) != len(conns):
            self.subscribers[channel] = live   # prune dead subscribers
        for conn in live:
            conn.push("pubsub", channel=channel, msg=msg)

    # ------------------------------------------------------------------ pgs
    def _retry_pending_pgs(self) -> None:
        for pg in self.pgs.values():
            if pg.state == "PENDING":
                self._try_reserve_pg(pg)

    def _try_reserve_pg(self, pg: PlacementGroupInfo) -> None:
        """Strategy-aware bundle placement with all-or-nothing commit
        (semantics of GcsPlacementGroupScheduler's 2-phase protocol collapsed
        into the head's single ledger view)."""
        nodes = self._alive_nodes()
        if not nodes:
            return
        scratch = {n.node_id: dict(n.available) for n in nodes}
        assignment: List[Optional[NodeID]] = []
        strategy = pg.strategy
        if strategy in ("PACK", "STRICT_PACK"):
            # try single-node packing first (required for STRICT_PACK)
            packed = None
            for n in nodes:
                trial = dict(scratch[n.node_id])
                ok = True
                for b in pg.bundles:
                    if all(trial.get(r, 0) >= amt - 1e-9 for r, amt in b.resources.items()):
                        for r, amt in b.resources.items():
                            trial[r] = trial.get(r, 0) - amt
                    else:
                        ok = False
                        break
                if ok:
                    packed = n.node_id
                    break
            if packed is not None:
                assignment = [packed] * len(pg.bundles)
            elif strategy == "STRICT_PACK":
                return  # stays PENDING
            else:  # PACK falls back to best-effort spread
                assignment = self._greedy_assign(pg, nodes, scratch, distinct=False)
        elif strategy == "STRICT_SPREAD":
            assignment = self._greedy_assign(pg, nodes, scratch, distinct=True)
        else:  # SPREAD: best-effort distinct, fall back to reuse
            assignment = (self._greedy_assign(pg, nodes, scratch, distinct=True)
                          or self._greedy_assign(pg, nodes, scratch, distinct=False))
        if not assignment or any(a is None for a in assignment):
            return  # stays PENDING
        # commit
        for b, nid in zip(pg.bundles, assignment):
            node = self.nodes[nid]
            for r, amt in b.resources.items():
                node.available[r] = node.available.get(r, 0) - amt
            b.node_id = nid
            b.available = dict(b.resources)
        pg.state = "CREATED"
        pg.ready_event.set()

    def _greedy_assign(self, pg: PlacementGroupInfo, nodes: List[NodeInfo],
                       scratch: dict, distinct: bool) -> Optional[List[NodeID]]:
        avail = {nid: dict(v) for nid, v in scratch.items()}
        used: Set[NodeID] = set()
        out: List[Optional[NodeID]] = []
        for b in pg.bundles:
            placed = None
            for n in sorted(nodes, key=lambda n: n.utilization()):
                if distinct and n.node_id in used:
                    continue
                a = avail[n.node_id]
                if all(a.get(r, 0) >= amt - 1e-9 for r, amt in b.resources.items()):
                    for r, amt in b.resources.items():
                        a[r] = a.get(r, 0) - amt
                    placed = n.node_id
                    used.add(n.node_id)
                    break
            if placed is None:
                return None
            out.append(placed)
        return out

    # ---------------------------------------------------------------- state
    # ------------------------------------------------------ fault tolerance
    def snapshot_path(self) -> str:
        from ray_tpu_torch.utils.platform import STATE_DIR

        return os.path.join(STATE_DIR, self.session, "head_snapshot.bin")

    def save_snapshot(self) -> None:
        """Persist durable control-plane state (reference: Redis-backed GCS
        tables, `src/ray/gcs/store_client/redis_store_client`): the KV
        (incl. exported function/class defs), detached-actor specs, named
        registrations, PG specs, and terminal job views. Worker/actor
        processes are NOT durable — detached actors are re-created from
        their specs on restore, matching GcsActorManager restart semantics."""
        import pickle

        detached = {a.binary(): i.spec for a, i in self.actors.items()
                    if i.spec["options"].get("lifetime") == "detached"
                    and i.state != "DEAD"}
        jobs = {}
        if getattr(self, "job_manager", None) is not None:
            jobs = {j["job_id"]: j for j in self.job_manager.list()
                    if j["status"] in ("SUCCEEDED", "FAILED", "STOPPED")}
        # _runtime_env blobs (up to GiBs of content-addressed zips) are
        # immutable: persist each once as its own file instead of
        # re-pickling them into every 2 s snapshot cycle.
        self._persist_runtime_env_blobs()
        snap = {
            "session": self.session,
            # identity is durable: metas/labels stamped with the head's
            # node id must stay valid across a restart, or every replayed
            # shm object looks like it came from a dead node
            "node_id": self.node_id.binary(),
            "kv": {k: v for k, v in self.kv.items()
                   if k[0] not in ("_metrics", "_runtime_env")},
            "detached_actors": detached,
            "named_actors": {ns_name: a.binary() for ns_name, a in
                             self.named_actors.items()},
            "pgs": {p.binary(): {"bundles": [b.resources for b in g.bundles],
                                 "strategy": g.strategy, "name": g.name}
                    for p, g in self.pgs.items() if g.state != "REMOVED"},
            "jobs": jobs,
            "job_counter": self.job_counter,
            "epoch": self.cluster_epoch,
            # freed-object tombstones: the reconcile fence that stops a
            # daemon's post-restart inventory re-advertisement from
            # resurrecting an object freed just before the head died
            # (bounded at 100k ids, ~1.6 MB worst case)
            "tombstones": [o.binary() for o in self._tombstones],
        }
        self._write_snapshot(snap)

    def _persist_runtime_env_blobs(self) -> None:
        """Write each content-addressed _runtime_env blob to its own file
        under <state>/<session>/runtime_env/ exactly once (they never
        change), so snapshots stay small and fast."""
        blobs = [(k, v) for k, v in self.kv.items() if k[0] == "_runtime_env"]
        if not blobs:
            return
        # NB: dedicated subdir — STATE_DIR/<session>/runtime_env/ is where
        # workers EXTRACT packages (runtime_env.py _fetch_extract); mixing
        # the head's blob mirror into it would make restore trip over
        # extraction directories.
        d = os.path.join(os.path.dirname(self.snapshot_path()),
                         "runtime_env_blobs")
        os.makedirs(d, exist_ok=True)
        for (_, key), value in blobs:
            if not isinstance(key, bytes):
                continue  # internal producers always use bytes keys; a
                # str key is untrusted client input — never a filename
            path = os.path.join(d, key.hex())
            if os.path.exists(path):
                continue
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(value if isinstance(value, bytes) else bytes(value))
            os.replace(tmp, path)

    def _restore_runtime_env_blobs(self) -> None:
        d = os.path.join(os.path.dirname(self.snapshot_path()),
                         "runtime_env_blobs")
        if not os.path.isdir(d):
            return
        # oldest-first (mtime) so the repopulated KV keeps the
        # insertion-order-is-age property _bound_runtime_env_cache evicts by
        def _mtime(n):
            try:
                return os.path.getmtime(os.path.join(d, n))
            except OSError:
                return 0.0

        for name in sorted(os.listdir(d), key=_mtime):
            path = os.path.join(d, name)
            if name.endswith(".tmp") or not os.path.isfile(path):
                continue
            try:
                # keys in this namespace are always bytes (uri.encode());
                # skip anything that isn't our own hex naming
                key = bytes.fromhex(name)
            except ValueError:
                continue
            if ("_runtime_env", key) in self.kv:
                continue
            with open(path, "rb") as f:
                self.kv[("_runtime_env", key)] = f.read()
        # the cap is normally enforced on kv_put; re-apply after bulk load
        self._bound_runtime_env_cache(0)

    def _write_snapshot(self, snap: dict) -> None:
        import pickle

        path = self.snapshot_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(snap, f)
        os.replace(tmp, path)

    def restore_snapshot(self) -> bool:
        """Reload durable state after a head restart; detached actors are
        re-registered PENDING and reschedule as workers come up."""
        import pickle

        path = self.snapshot_path()
        if not os.path.exists(path):
            return False
        with open(path, "rb") as f:
            snap = pickle.load(f)
        if snap.get("node_id"):
            # adopt the predecessor's node identity (see save_snapshot)
            new_id = NodeID(snap["node_id"])
            if new_id != self.node_id:
                old_id = self.node_id
                self.nodes[new_id] = self.nodes.pop(self.node_id)
                self.node_id = new_id
                self.head_node.node_id = new_id
                if self.store.namespace == old_id.hex()[:8]:
                    # isolation mode derived the store namespace from the
                    # pre-adoption id: rebuild under the adopted id or no
                    # client (they resolve by the ADOPTED id) can map our
                    # arena — and replayed metas couldn't be opened here
                    cap = self.store.capacity
                    # keep spill files: surviving daemons/processes may
                    # still re-advertise objects spilled under them
                    self.store.shutdown(sweep_spill=False)
                    self.store = SharedMemoryStore(
                        self.session, capacity_bytes=cap, create_arena=True,
                        namespace=new_id.hex()[:8])
        # epoch fencing across the restart: strictly above the snapshot's
        # epoch even if the wall clock went backwards, so every pre-restart
        # grant/carve-out tag is verifiably stale
        self.cluster_epoch = max(self.cluster_epoch,
                                 int(snap.get("epoch", 0)) + 1)
        for oid_b in snap.get("tombstones") or ():
            # restore the freed-object fence so daemon inventory
            # re-advertisement can't resurrect a pre-restart free
            self._tombstones[ObjectID(oid_b)] = None
        self.kv.update(snap["kv"])
        # metrics snapshots are per-process and every pre-restart process's
        # connection died with the old head: restoring them would scrape
        # ghosts (the exact leak the disconnect expiry fixes); live
        # processes re-push within one metrics interval of reconnecting
        for k in [k for k in self.kv if k[0] == "_metrics"]:
            del self.kv[k]
        self._metrics_parsed.clear()
        self._restore_runtime_env_blobs()
        self.job_counter = snap.get("job_counter", 0)
        # PGs first: restored actors may be bound to a PG bundle — without
        # the PG entry, _schedule_actor would mark them DEAD on arrival
        for pg_b, view in snap.get("pgs", {}).items():
            pgid = PlacementGroupID(pg_b)
            if pgid not in self.pgs:
                pg = PlacementGroupInfo(pgid, view["bundles"],
                                        view["strategy"],
                                        view.get("name", ""))
                self.pgs[pgid] = pg
                self._try_reserve_pg(pg)
        grace = ACTOR_READOPT_GRACE_S
        for aid_b, spec in snap["detached_actors"].items():
            aid = ActorID(aid_b)
            info = ActorInfo(aid, spec)
            # not re-created at once: the daemons report the old head's
            # actor processes within a few seconds and they are re-adopted
            # (keeping their state, their card and the ledger exact); only
            # an actor no daemon reports is re-created after `grace`
            info.readopt_until = time.monotonic() + grace
            self.actors[aid] = info
        if snap["detached_actors"]:
            asyncio.get_running_loop().call_later(grace + 0.05, self._kick)
        for ns_name, aid_b in snap["named_actors"].items():
            aid = ActorID(aid_b)
            if aid in self.actors:
                self.named_actors[tuple(ns_name)] = aid
        if getattr(self, "job_manager", None) is not None:
            from ray_tpu_torch.core.job_manager import JobInfo

            for jid, view in snap["jobs"].items():
                info = JobInfo(jid, view["entrypoint"], view["metadata"])
                info.status = view["status"]
                info.message = view["message"]
                info.start_time = view["start_time"]
                info.end_time = view["end_time"]
                info.log_path = view["log_path"]
                self.job_manager.jobs[jid] = info
        self._spawn_for_demand()
        return True

    async def _snapshot_loop(self, interval_s: float = 2.0) -> None:
        failures = 0
        while not self._shutdown:
            await asyncio.sleep(interval_s)
            try:
                # state collection is quick and runs on the loop; the
                # multi-MB pickle+write runs in a thread so head RPCs
                # (submits, heartbeats) never stall behind disk IO
                await asyncio.to_thread(self.save_snapshot)
                failures = 0
            except Exception as e:
                failures += 1
                if failures in (1, 10) or failures % 100 == 0:
                    # silent persistence failure = fault tolerance silently
                    # off; log with backoff instead of spamming
                    print(f"[ray_tpu_torch] head snapshot failed x{failures}: "
                          f"{e!r}", file=sys.stderr, flush=True)

    def _bound_runtime_env_cache(self, incoming: int) -> None:
        """Evict oldest runtime_env packages beyond the byte cap (no URI
        refcounting — workers keep extracted copies, so only a cold worker
        after eviction would refetch-and-fail, matching a bounded cache)."""
        cap = _config.get("runtime_env_cache_bytes")
        entries = [(k, v) for k, v in self.kv.items()
                   if k[0] == "_runtime_env"]
        total = sum(len(v) for _, v in entries) + incoming
        for k, v in entries:  # dict order = insertion order = oldest first
            if total <= cap:
                break
            del self.kv[k]
            self._drop_runtime_env_blob_file(k[1])
            total -= len(v)

    def _drop_runtime_env_blob_file(self, key) -> None:
        """Keep the on-disk blob mirror in lockstep with KV eviction —
        otherwise restore resurrects evicted packages and disk grows
        unboundedly across the session."""
        if not isinstance(key, bytes):
            return  # hex() naming only ever mirrors bytes keys; a str key
            # must not become a path component (traversal risk)
        path = os.path.join(os.path.dirname(self.snapshot_path()),
                            "runtime_env_blobs", key.hex())
        try:
            os.unlink(path)
        except OSError:
            pass

    def _list_state(self, kind: str):
        if kind == "actors":
            return [{"actor_id": a.hex(), "state": i.state,
                     "name": i.spec["options"].get("name"),
                     "node_id": (i.worker.node_id.hex() if i.worker else None),
                     "restarts_left": i.restarts_left}
                    for a, i in self.actors.items()]
        if kind == "workers":
            return [{"worker_id": w.hex(), "pid": i.pid, "is_driver": i.is_driver,
                     "node_id": i.node_id.hex(),
                     "log_tag": getattr(i, "log_tag", None),
                     "actor": i.actor_id.hex() if i.actor_id else None,
                     "task": i.running_task.hex() if i.running_task else None}
                    for w, i in self.workers.items()]
        if kind == "objects":
            return [{"object_id": o.hex(), "size": m.size, "kind": m.kind}
                    for o, m in self.objects.items()]
        if kind == "tasks":
            return [{"task_id": r.task_id.hex(),
                     "name": r.spec["options"].get("name"),
                     "pending_deps": len(r.pending_deps)} for r in self.queue]
        if kind == "task_events":
            return list(self.task_events)
        if kind == "lease_events":
            return list(self.lease_events)
        if kind == "scheduler_stats":
            return self._scheduler_stats()
        if kind == "trace_spans":
            return list(self.trace_spans.values())
        if kind == "workload_stats":
            return self._workload_rows()
        if kind == "serve_stats":
            return [r for r in self._workload_rows()
                    if str(r.get("kind", "")).startswith("serve")]
        if kind == "nodes":
            return [{"node_id": n.node_id.hex(), "resources": n.resources,
                     "available": n.available, "labels": n.labels,
                     "is_head": n.is_head, "alive": n.alive}
                    for n in self.nodes.values()]
        if kind == "placement_groups":
            return [{"pg_id": p.hex(), "state": g.state, "strategy": g.strategy,
                     "bundles": [{"resources": b.resources,
                                  "node_id": b.node_id.hex() if b.node_id else None}
                                 for b in g.bundles]}
                    for p, g in self.pgs.items()]
        raise ValueError(f"unknown state kind {kind}")

    def _scheduler_stats(self) -> List[dict]:
        """Per-node two-level-scheduler telemetry rows (flight recorder):
        the head's view-sync bookkeeping + each daemon's gossiped lifetime
        counters and gossip health, plus one row for the head itself."""
        now = time.time()
        rows = []
        for n in self.nodes.values():
            if n.is_head:
                continue
            rows.append({
                "node_id": n.node_id.hex(), "alive": n.alive,
                "is_head": False, "idle_workers": n.pool_idle,
                "leased_workers": n.pool_leased,
                # head-side carve-out view vs the daemon's gossiped pool:
                # after reconciliation these must agree (no double-grant,
                # no leaked carve-out)
                "pooled_workers": sum(
                    1 for w in self.workers.values()
                    if w.node_id == n.node_id and w.pooled),
                "reconciled": n.reconciled,
                "pending_pool": len(n.pending_pool),
                "view_version": n.view_version,
                "staleness_s": round(now - n.last_delta_ts, 3),
                "gossip": dict(n.gossip_health),
                "local_grants": 0, "spillbacks": 0,  # until first delta
                **{k: v for k, v in n.sched_stats.items()},
            })
        rows.append({
            "node_id": self.node_id.hex(), "alive": True, "is_head": True,
            "view_version": self._view_seq,
            "epoch": self.cluster_epoch,
            "staleness_s": 0.0, "gossip": {},
            "lease_events_buffered": len(self.lease_events),
            **{k: v for k, v in self.sched_totals.items()},
        })
        return rows

    # ------------------------------------------- workload flight recorder
    def _adopt_spans(self, spans, proc: str, node: Optional[str]) -> None:
        cap = max(int(_config.get("tracing_head_spans")), 2)
        for s in spans:
            sid = s.get("span_id")
            if not sid:
                continue
            self.trace_spans[sid] = {**s, "proc": proc,
                                     "node": node or proc}
        while len(self.trace_spans) > cap:
            self.trace_spans.popitem(last=False)

    def _parsed_snapshots(self):
        """(key, parsed payload) for every live _metrics KV entry, via
        the decode-once cache (cold entries — e.g. restored from disk —
        are parsed and cached on first read)."""
        import json as _json

        for (ns, key), value in list(self.kv.items()):
            if ns != "_metrics":
                continue
            payload = self._metrics_parsed.get(key)
            if payload is None:
                try:
                    payload = _json.loads(value)
                except Exception:
                    continue
                self._metrics_parsed[key] = payload
            yield key, payload

    def _workload_rows(self) -> List[dict]:
        """Live-load telemetry merged from every process's pushed/gossiped
        `__workloads__` family (serve replicas, proxies, train workers)."""
        rows: List[dict] = []
        for key, payload in self._parsed_snapshots():
            for fam in payload:
                if fam.get("name") != "__workloads__":
                    continue
                for row in fam.get("series") or ():
                    rows.append({**row, "proc": key.decode()})
        return rows

    def _metric_families(self) -> Dict[str, list]:
        """{metric_name: [(proc, series_dict), ...]} across every pushed
        snapshot plus the head's own registry — the watchdog's histogram
        source."""
        from ray_tpu_torch.util import metrics as _metrics

        fams: Dict[str, list] = {}
        snapshots = [("head", _metrics.snapshot_all())]
        snapshots.extend((key.decode(), payload)
                         for key, payload in self._parsed_snapshots())
        for proc, payload in snapshots:
            for fam in payload:
                name = fam.get("name", "")
                if name.startswith("__"):
                    continue
                for s in fam.get("series") or ():
                    fams.setdefault(name, []).append((proc, s))
        return fams

    async def _workload_watchdog_loop(self) -> None:
        """Flag slow pulls / train-step stragglers / p99-over-SLO routes /
        sustained admission-control shedding / hot-path drift (compiled
        ring stall ratios, chain p99, fused-step phase stragglers) from
        the merged telemetry — flight-recorder events plus
        `workload_anomalies_total{kind}` (see core/workload_watchdog)."""
        from ray_tpu_torch.core import workload_watchdog

        interval = float(_config.get("workload_watchdog_interval_s"))
        if interval <= 0:
            return
        while not self._shutdown:
            await asyncio.sleep(interval)
            try:
                anomalies, self._watchdog_state = workload_watchdog.scan(
                    self._workload_rows(), self._metric_families(),
                    time.time(),
                    slow_pull_s=float(_config.get("workload_slow_pull_s")),
                    straggler_factor=float(
                        _config.get("workload_straggler_factor")),
                    p99_slo_s=float(_config.get("serve_p99_slo_s")),
                    hotpath_drift=float(
                        _config.get("workload_hotpath_drift")),
                    state=self._watchdog_state)
            except Exception:
                continue
            for a in anomalies:
                self.lease_events.append(
                    {"ts": time.time(), "kind": "workload_anomaly", **a})
                self._count_anomaly(a.get("anomaly", "?"))

    def _count_anomaly(self, kind: str) -> None:
        try:
            if self._anomaly_counter is None:
                from ray_tpu_torch.util import metrics as _metrics

                self._anomaly_counter = _metrics.Counter(
                    "workload_anomalies_total",
                    "Workload anomalies flagged by the head watchdog "
                    "(slow_pull | train_straggler | slo_route | "
                    "serve_shedding | hotpath_regression)",
                    tag_keys=("kind",))
            self._anomaly_counter.inc(tags={"kind": kind})
        except Exception:
            pass

    # --------------------------------------------------------------- server
    async def start(self, port: int = 0) -> int:
        def on_connect(conn: protocol.Connection):
            conn_state = {"conn": conn}
            conn.handlers.update(self._handlers(conn_state))
            orig_close = conn.on_close

            def on_close(c):
                if orig_close:
                    orig_close(c)
                w = conn_state.get("worker")
                if w is not None:
                    if self.workers.get(w.worker_id) is w:
                        self._on_worker_disconnect(w)
                    else:
                        # superseded by a re-registration: don't tear the
                        # live registration down, but the stale object
                        # must leave the scheduling structures and its
                        # in-flight task must retry
                        self._purge_stale_worker(w)
                node = conn_state.get("node")
                # a stale transport closing after a re-registration
                # swapped in a fresh one must not tear the node down
                if node is not None and node.conn is conn_state["conn"]:
                    self._on_node_disconnect(node)

            conn.on_close = on_close

        # handlers installed per-connection (they close over conn_state)
        from ray_tpu_torch.core import flight_recorder

        flight_recorder.install("head")
        bind = _config.get("bind_host")
        self._server = protocol.Server({}, on_connect=on_connect, name="head")
        self.port = await self._server.start(host=bind, port=port)
        # head-node object data server (worker nodes run theirs in the node
        # daemon): serves chunked reads of this node's store for cross-node
        # pulls (reference object_manager over gRPC)
        from ray_tpu_torch.core import object_transfer

        # head-node pull manager: local workers route remote pulls through
        # it (`pull_object` RPC) so an object crosses the network once per
        # node — the daemon-side manager's twin for the head's own node
        self.pull_manager = object_transfer.PullManager(
            lambda: self.store, role="head",
            resolve=self._resolve_pull_sources)
        self._data_server = protocol.Server(
            object_transfer.make_data_handlers(lambda: self.store,
                                               lambda: self.pull_manager),
            name="head-data")
        self.data_port = await self._data_server.start(host=bind)
        self.head_node.data_addr = (None, self.data_port)
        asyncio.ensure_future(self._evict_loop())
        asyncio.ensure_future(self._health_loop())
        asyncio.ensure_future(self._view_broadcast_loop())
        asyncio.ensure_future(self._workload_watchdog_loop())
        asyncio.ensure_future(self._pool_reclaim_loop())
        from ray_tpu_torch.core.job_manager import JobManager

        self.job_manager = JobManager(self.session, self.port)
        # tail this node's worker log files; batches land on the loop via
        # _on_log_batch (ring + fan-out to drivers)
        from ray_tpu_torch.core import worker_logs

        loop = asyncio.get_running_loop()
        self._log_monitor = worker_logs.LogMonitor(
            worker_logs.session_log_dir(self.session),
            emit=lambda batch: loop.call_soon_threadsafe(
                self._on_log_batch, batch))
        self._log_monitor.start()
        return self.port

    async def _health_loop(self) -> None:
        """Application-level liveness probes (reference
        `gcs_health_check_manager.h:45`): TCP-disconnect reaping misses a
        hung-but-connected process (SIGSTOP, deadlocked GIL, wedged PJRT
        call) — its socket stays open while callers stall forever. Probe
        every worker and node daemon on a cadence; after
        `health_check_misses` consecutive timeouts, close its socket,
        which drives the NORMAL failure path (actor restart per
        max_restarts, lease revocation, task retry)."""
        interval = _config.get("health_check_interval_s")
        timeout = _config.get("health_check_timeout_s")
        budget = max(1, _config.get("health_check_misses"))
        if interval <= 0:
            return
        misses: Dict[bytes, int] = {}

        async def probe(key: bytes, conn) -> None:
            try:
                await asyncio.wait_for(conn.request("health_ping"), timeout)
                misses.pop(key, None)
            except asyncio.TimeoutError:
                m = misses.get(key, 0) + 1
                misses[key] = m
                if m >= budget:
                    misses.pop(key, None)
                    print(f"[ray_tpu_torch] health: {budget} missed probes, "
                          f"declaring process dead", flush=True)
                    await conn.close()   # reap via the on_close path
            except Exception:
                misses.pop(key, None)   # disconnects reap themselves

        while not self._shutdown:
            await asyncio.sleep(interval)
            probes = []
            for w in list(self.workers.values()):
                # drivers are probed too — a wedged driver holds leases
                # and refs; its reap path already handles driver death
                if w.conn is not None and not w.conn.closed:
                    probes.append(probe(w.worker_id.binary(), w.conn))
            for node in list(self.nodes.values()):
                if node is self.head_node:
                    continue
                if node.conn is not None and not node.conn.closed:
                    probes.append(probe(node.node_id.binary(), node.conn))
            if probes:
                await asyncio.gather(*probes, return_exceptions=True)

    def notify_task_done(self, w: WorkerInfo) -> None:
        if w.current_record is not None:
            self._unpin_task(w.current_record)
        w.running_task = None
        w.current_record = None
        self._release(w)
        node = self.nodes.get(w.node_id)
        if (not w.is_driver and w.actor_id is None and not w.retiring
                and w.leased_to is None and not w.pooled
                and node is not None and w not in node.idle):
            node.idle.append(w)
            # waiting lease requests outrank the head-path queue: the
            # lease turns EVERY future same-shape task of that client
            # into a direct push, draining the queue's source
            self._grant_lease_waiters(node)
        self._kick()

    def _grant_lease_waiters(self, node: "NodeInfo") -> None:
        """Serve queued lease/pool waiters from a node that freed a worker.

        Each waiter carries its full scheduling shape: a TPU-slice-affine
        lease (label_selector) or a pip-isolated one (venv_key) must NOT
        be granted a worker on a non-matching node — skip it and keep
        scanning so an eligible later waiter still gets the worker."""
        if not self._lease_waiters or not node.idle:
            return
        remaining = []
        for ent in self._lease_waiters:
            if ent["fut"].done():
                continue  # timed out / cancelled
            if (not node.idle
                    or (ent.get("node_id") is not None
                        and ent["node_id"] != node.node_id)
                    or not node.matches_labels(ent.get("selector"))
                    or any(node.available.get(r, 0) < v
                           for r, v in ent["resources"].items())):
                remaining.append(ent)
                continue
            lw = self._idle_worker_on(node, ent.get("venv_key"))
            if lw is None:
                remaining.append(ent)
                continue
            self._acquire(lw, ent["resources"])
            ent["fut"].set_result(lw)
        self._lease_waiters[:] = remaining

    # ------------------------------------------- epoch / pool reconciliation
    def _stale_epoch(self, method: str, node: Optional[NodeInfo]) -> None:
        """Count + record a rejected stale-epoch operation and route its
        sender into the reconciliation handshake."""
        self.sched_totals["stale_epoch_rejects"] += 1
        self.lease_events.append(
            {"ts": time.time(), "kind": "stale_epoch", "method": method,
             "node_id": node.node_id.hex() if node is not None else None,
             "epoch": self.cluster_epoch})
        if node is not None and node.conn is not None and not node.conn.closed:
            try:
                node.conn.push("reconcile_request")
            except Exception:
                pass

    def _adopt_pooled(self, node: NodeInfo, w: WorkerInfo,
                      item: dict) -> None:
        """Restore a daemon-reported pool carve-out onto `w`: re-home the
        worker to the reporting node if a head restart parked it elsewhere
        (register_worker falls back to the head node when the daemon has
        not re-registered yet), debit the ledger once, and remember the
        carve-out generation for idempotent release."""
        old = self.nodes.get(w.node_id)
        if old is not None and old is not node:
            old.workers.discard(w.worker_id)
            if w in old.idle:
                old.idle.remove(w)
            old.unadopted.discard(w)
            w.node_id = node.node_id
            node.workers.add(w.worker_id)
        if w in node.idle:
            node.idle.remove(w)
        node.unadopted.discard(w)
        if not w.pooled:
            self._acquire(w, item.get("resources") or {})
            w.pooled = True
        w.leased_to = None
        if item.get("venv_key") is not None:
            w.venv_key = item["venv_key"]
        seq = item.get("seq")
        if seq is None:
            self._pool_seq += 1
            seq = self._pool_seq
        else:
            self._pool_seq = max(self._pool_seq, seq)
        w.pool_grant_seq = seq

    def _tell_daemon_actor(self, w: WorkerInfo) -> None:
        """Tell `w`'s node daemon which actor `w` now hosts (or that it
        hosts none) and what it holds: after a head restart the daemon's
        reconciliation report names the process, and the new head holds
        its resources before anything else is granted on the node."""
        node = self.nodes.get(w.node_id)
        if node is None or node.conn is None or node.conn.closed:
            return
        try:
            node.conn.push(
                "actor_worker", wid=w.worker_id.binary(), pid=w.pid,
                actor_id=w.actor_id.binary() if w.actor_id else None,
                resources=dict(w.acquired),
                pg=w.acquired_pg.binary() if w.acquired_pg else None,
                bundle=w.acquired_bundle)
        except Exception:
            pass

    def _hold_actor_worker(self, node: NodeInfo, item: dict) -> None:
        """A daemon's reconciliation report names an actor process that
        outlived the head: debit what it held on `node` now, before any
        grant there, and re-adopt the process when it re-registers. An
        actor this head re-created or removed meanwhile, or a restored one
        whose resources are no longer free here (its placement group
        bundle moved), ends the process, so one actor never runs twice.
        An actor this head does not know (not detached, so not in the
        snapshot) keeps running, out of the idle pool."""
        wid, aid = WorkerID(item["wid"]), ActorID(item["actor_id"])
        w = self.workers.get(wid)
        if w is not None and w.actor_id is not None:
            return  # already hosting it under this head (a re-reconcile)
        info = self.actors.get(aid)
        resources = item.get("resources") or {}
        pg = bundle = None
        if item.get("pg"):
            pg = self.pgs.get(PlacementGroupID(item["pg"]))
        if pg is not None:
            idx = item.get("bundle")
            if (pg.state == "CREATED" and idx is not None
                    and pg.bundles[idx].node_id == node.node_id):
                bundle = pg.bundles[idx]
            fits = bundle is not None and bundle.fits(resources)
        else:
            fits = node.fits(resources)
        if info is not None and (info.worker is not None
                                 or info.state == "DEAD" or not fits):
            if w is not None:
                self._terminate_worker(w)
            elif node.conn is not None and not node.conn.closed:
                node.conn.push("kill_worker", pid=item["pid"])
            return
        hold = SimpleNamespace(node_id=node.node_id, actor_id=aid,
                               acquired={}, acquired_pg=None,
                               acquired_bundle=None)
        if fits:
            self._acquire(hold, resources, pg, bundle)
        if info is not None:
            info.readopt_until = time.monotonic() + ACTOR_HOLD_S
        if w is not None:
            self._adopt_actor_worker(node, w, hold)
            return
        node.pending_actors[wid] = hold
        asyncio.get_running_loop().call_later(
            ACTOR_HOLD_S, self._drop_actor_hold, node, wid)

    def _drop_actor_hold(self, node: NodeInfo, wid: WorkerID) -> None:
        """The reported actor process never re-registered: give its
        resources back, and let a restored actor be re-created."""
        hold = node.pending_actors.pop(wid, None)
        if hold is None:
            return
        self._release(hold)
        info = self.actors.get(hold.actor_id)
        if info is not None and info.worker is None:
            info.readopt_until = 0.0
        self._kick()

    def _adopt_actor_worker(self, node: NodeInfo, w: WorkerInfo,
                            hold: SimpleNamespace) -> None:
        """Re-adopt an actor onto the process that still hosts it (it
        survived a head restart): home the worker on `node`, move the
        resources held for it onto it, and publish its address."""
        old = self.nodes.get(w.node_id)
        if old is not None and old is not node:
            old.workers.discard(w.worker_id)
            old.unadopted.discard(w)
            if w in old.idle:
                old.idle.remove(w)
            w.node_id = node.node_id
            node.workers.add(w.worker_id)
        node.unadopted.discard(w)
        if w in node.idle:
            node.idle.remove(w)
        w.acquired = hold.acquired
        w.acquired_pg, w.acquired_bundle = hold.acquired_pg, hold.acquired_bundle
        w.actor_id = hold.actor_id
        info = self.actors.get(hold.actor_id)
        if info is not None:
            if info.state == "DEAD":
                # removed while held: its disconnect gives the hold back
                self._terminate_worker(w)
                return
            info.worker = w
            info.readopt_until = 0.0
            self.notify_actor_ready(info, (w.host or "127.0.0.1", w.port))
        self.lease_events.append({"ts": time.time(), "kind": "actor_readopt",
                                  "actor_id": hold.actor_id.hex(),
                                  "node_id": node.node_id.hex(),
                                  "pid": w.pid, "restored": info is not None})
        self._view_changed()

    def _promote_unadopted(self, node: NodeInfo, w: WorkerInfo) -> None:
        """A parked reconnecting worker the daemon's reconcile did not
        claim (or whose daemon never reported in time): expose it to
        normal head dispatch."""
        if w not in node.unadopted or self.workers.get(w.worker_id) is not w:
            return
        node.unadopted.discard(w)
        if (not w.pooled and w.conn is not None and not w.conn.closed
                and w not in node.idle):
            node.idle.append(w)
            self._grant_lease_waiters(node)
            self._kick()

    def notify_actor_ready(self, info: ActorInfo, address) -> None:
        info.state = "ALIVE"
        info.address = tuple(address)
        info.ready_event.set()
        self._publish("actor_state", {"actor_id": info.actor_id.binary(),
                                      "state": "ALIVE"})

    async def stop(self) -> None:
        self._shutdown = True
        if self._log_monitor is not None:
            self._log_monitor.stop()
        for node in self.nodes.values():
            if node.conn is not None and not node.conn.closed:
                node.conn.push("shutdown_node")
        for w in list(self.workers.values()):
            if not w.is_driver:
                self._terminate_worker(w)
        if self._server:
            await self._server.stop()
        if getattr(self, "_data_server", None):
            await self._data_server.stop()
        if getattr(self, "pull_manager", None) is not None:
            await self.pull_manager.close()
        self.store.shutdown()
