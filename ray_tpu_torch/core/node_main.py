"""Node daemon (`python -m ray_tpu_torch.core.node_main`): joins a cluster.

The per-node agent — the raylet's role split (SURVEY §2.1 N1/N3): advertise
this node's resources+labels to the head, spawn/kill local worker processes
on request, AND run the node-local half of the two-level scheduler: a
scheduler server that grants/returns worker leases from a local pool, so a
client in steady state never touches the head (reference
`ClusterTaskManager::ScheduleAndDispatchTasks` + worker-pool ownership).
Pool state is gossiped to the head as versioned resource-view deltas
(`ray_syncer` role); the head pushes back the compacted cluster view.
Workers connect straight to the head; object data rides the node-local shm
store.

`ray start --address=...` equivalent for worker nodes.

Counterpart of `ray_tpu/core/node_main.py`, with GPUs where the JAX
package counts TPU chips: the daemon advertises `num_gpus` ("GPU"),
detected as the head detects them (config, then `CUDA_VISIBLE_DEVICES`,
then NVML in a child interpreter) when not given. It imports no torch and
maps no CUDA library. Its workers run this package's `core.worker_main`
and inherit its `CUDA_VISIBLE_DEVICES`, which is how a node's cards reach
its workers. SIGTERM stops it through the same path as `shutdown_node`:
its workers are killed and its store (under `store_isolation`, a
namespaced arena and segments) is unlinked.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.core import protocol
from ray_tpu_torch.core.ids import NodeID
from ray_tpu_torch.core.resource_view import ClusterView, matches_labels


class NodeDaemon:
    def __init__(self, head_host: str, head_port: int,
                 num_cpus=None, num_gpus=None, resources=None,
                 labels=None, max_workers=None):
        from ray_tpu_torch.core.resources import node_labels, node_resources

        self.head_host, self.head_port = head_host, head_port
        self.node_id = NodeID.generate()
        self.resources = node_resources(num_cpus, num_gpus, resources)
        self.labels = {**node_labels(), **(labels or {})}
        self.max_workers = max_workers or max(
            int(self.resources.get("CPU", 4)) * 2, 8)
        self.session: str = ""
        self.conn: protocol.Connection = None
        self.procs: Dict[int, subprocess.Popen] = {}
        # the actor each of our workers hosts, as the head placed it (its
        # pid, actor id, resources, placement group bundle): reported at
        # every reconcile, so a restarted head holds those resources
        # before it grants anything here and re-adopts the process
        self.actor_workers: Dict[bytes, dict] = {}
        self.stopping = asyncio.Event()
        # object data plane: this daemon serves its node's store to remote
        # pullers (the raylet/object-manager role). Under isolation mode
        # the node gets its own store namespace, making single-machine
        # clusters exercise real remote fetches.
        self.store = None
        self.data_port: int = 0
        self._data_server: protocol.Server = None
        # node-local scheduler: warm lease pool + gossip state
        self.sched_port: int = 0
        self._sched_server: protocol.Server = None
        self.pool_idle: List[dict] = []     # {wid, addr, venv_key, shape, since}
        self.pool_leases: Dict[bytes, dict] = {}  # wid -> pool entry
        self.cluster_view = ClusterView()
        self._gossip_version = 0
        self._gossip_pending = False
        # flight recorder: bounded ring of lease-lifecycle/gossip events +
        # monotonic counters, both piggybacked on the resource_view_delta
        # gossip this daemon already sends — telemetry costs zero extra
        # round trips (core/flight_recorder.py)
        from ray_tpu_torch.core.flight_recorder import EventRing

        self.fr_events = EventRing(_config.get("flight_recorder_events"))
        self.sched_stats = {"local_grants": 0, "spillbacks": 0,
                            "pool_acquires": 0, "lease_returns": 0,
                            "pool_releases": 0, "pool_worker_deaths": 0,
                            "peer_spillbacks": 0, "peer_grants": 0,
                            # data-plane cold misses: pulls that fell back
                            # to the head's locate_object (the scoped
                            # directory didn't cover the serving node —
                            # interest-on-demand widening should make
                            # these stop recurring per node)
                            "locate_fallbacks": 0}
        # interest-on-demand: shards this daemon widened its scoped view
        # subscription to (beyond its own), re-asserted after reconnects
        self._interest_extra: set = set()
        self._fr_metrics_ts = 0.0   # last registry snapshot ride-along
        self._last_gossip_ts = 0.0  # heartbeat bookkeeping (monotonic)
        # partition tolerance: the cluster epoch observed from the head
        # (stamped into pool/lease traffic; stale-epoch ops are rejected
        # head-side and routed into reconciliation), drained-but-unacked
        # flight-recorder events (resent until the head acks their seq),
        # and pool_release carve-out returns awaiting delivery (requeued
        # with bounded backoff instead of fire-and-forget — a release
        # lost mid-head-outage must not leak the head-side carve-out)
        self.head_epoch = 0
        self._reconnecting = False
        self._fr_pending: List[dict] = []
        self._pending_releases: List[dict] = []
        # object data plane: cached copy of the gossiped object directory
        # (applied from cluster_view broadcasts), the full metas of
        # objects PRIMARY on this node (the spill-restore inventory the
        # reconcile handshake re-advertises after a head restart), queued
        # replica announcements for the next gossip delta, and the node
        # pull manager (created with the store in start())
        from ray_tpu_torch.core.object_directory import ObjectDirectory

        self.object_dir = ObjectDirectory()
        self.local_objects: Dict[bytes, object] = {}   # oid bytes -> meta
        self._dir_out: List[dict] = []
        self.pull = None
        isolation = _config.get("store_isolation")
        self.store_ns = _config.get("store_namespace") or (
            self.node_id.hex()[:8] if isolation else "")
        self._create_arena = isolation

    async def start(self):
        from ray_tpu_torch.core import flight_recorder, object_transfer
        from ray_tpu_torch.util import metrics as _metrics

        _metrics.disable_pusher()  # daemon metrics ride gossip, not the KV
        flight_recorder.install("daemon")
        self._data_server = protocol.Server(
            object_transfer.make_data_handlers(lambda: self.store,
                                               lambda: self.pull),
            name="node-data")
        self.data_port = await self._data_server.start(
            host=_config.get("bind_host"))
        self._sched_server = protocol.Server(
            {}, on_connect=self._on_sched_connect, name="node-sched")
        self.sched_port = await self._sched_server.start(
            host=_config.get("bind_host"))
        self.conn = await protocol.connect(
            self.head_host, self.head_port,
            handlers=self._head_handlers(), name="node")
        self.conn.on_close = self._on_head_conn_close
        reply = await self.conn.request(
            "register_node", node_id=self.node_id.binary(),
            resources=self.resources, labels=self.labels,
            max_workers=self.max_workers, data_port=self.data_port,
            sched_port=self.sched_port,
            # interest-scoped view plane: when the head shards the
            # cluster_view broadcast, this daemon only needs the shard it
            # lives in (its own entry + neighbors) plus the digest — full
            # fan-out of the whole node list does not scale past ~200
            # nodes ("auto" = the head computes the scope; ignored when
            # sharding is off)
            interest="auto")
        self.session = reply["session"]
        self.head_epoch = reply.get("epoch", 0)
        # reconciliation handshake runs on EVERY (re)connect — trivially
        # empty on first boot, the ledger-rebuild source of truth after a
        # head restart
        await self._send_reconcile()
        asyncio.ensure_future(self._pool_shrink_loop())
        asyncio.ensure_future(self._fr_heartbeat_loop())
        asyncio.ensure_future(self._release_flush_loop())
        from ray_tpu_torch.core.store import SharedMemoryStore
        from ray_tpu_torch.core.store import (
            default_store_bytes as _default_store_bytes)

        self.store = SharedMemoryStore(
            self.session,
            capacity_bytes=(
                int(_config.get("object_store_bytes"))
                or _default_store_bytes()),
            create_arena=self._create_arena, namespace=self.store_ns)
        # spills retarget our local meta copy; the head owns the canonical
        # entry and must learn the new location
        self.store.on_spill = lambda m: self.conn.push("object_spilled",
                                                       meta=m)
        # node pull manager: local workers' remote pulls funnel through
        # here (`pull_object` on the data server) so each object crosses
        # the network once per node; pulled replicas are announced into
        # the gossiped directory as extra sources for everyone else
        self.pull = object_transfer.PullManager(
            lambda: self.store, role="daemon",
            resolve=self._resolve_pull_sources,
            on_replica=self._on_replica_created,
            on_replica_gone=self._on_replica_dropped)
        # tail this node's worker log files; new lines ride the control
        # connection to the head, which fans them out to drivers and keeps
        # its ring for the CLI/dashboard (reference log_monitor.py role)
        from ray_tpu_torch.core import worker_logs

        loop = asyncio.get_running_loop()

        def _emit(batch):
            loop.call_soon_threadsafe(
                lambda: self.conn.push("log_batch", entries=batch)
                if self.conn is not None and not self.conn.closed else None)

        self._log_monitor = worker_logs.LogMonitor(
            worker_logs.session_log_dir(
                self.session, f"node-{self.node_id.hex()[:12]}"),
            emit=_emit)
        self._log_monitor.start()

    async def _health_ping(self):
        return True

    def _head_handlers(self) -> Dict[str, object]:
        return {
            "spawn_worker": self._spawn_worker,
            "kill_worker": self._kill_worker,
            "shutdown_node": self._shutdown_node,
            "free_object": self._free_object,
            "drop_replica": self._on_drop_replica,
            "adopt_object": self._adopt_object,
            "health_ping": self._health_ping,
            "cluster_view": self._on_cluster_view,
            "pool_worker_died": self._on_pool_worker_died,
            "actor_worker": self._on_actor_worker,
            "pool_trim": self._on_pool_trim,
            "reconcile_request": self._on_reconcile_request,
            "chaos": self._on_chaos,
        }

    async def _on_pool_trim(self, resources=None):
        """Head-pushed reclaim: queued head-path tasks are starving for
        capacity this pool holds idle (pools can otherwise hoard a
        node's entire ledger until pool_idle_s). Release one idle worker
        — preferring the starving shape — through the normal ack-tracked
        release path."""
        shape = tuple(sorted(resources.items())) if resources else None
        ent = self._pool_take(shape, None) if shape is not None else None
        if ent is None and self.pool_idle:
            ent = self.pool_idle.pop()
        if ent is None:
            return False
        self._fr("pool_release", worker=ent["wid"].hex()[:12], trim=True)
        self._pending_releases.append(
            {"wid": ent["wid"], "seq": ent.get("seq"),
             "epoch": self.head_epoch, "attempts": 0,
             "next_try": time.monotonic()})
        self._gossip_soon()
        return True

    async def _on_reconcile_request(self):
        """Head-pushed when it saw a stale-epoch op from us: re-run the
        inventory handshake so its ledger matches our pools."""
        asyncio.ensure_future(self._send_reconcile())
        return True

    async def _on_chaos(self, spec):
        """Chaos control plane: the head relays a fault plan for THIS
        process (tests partition the daemon<->head edge on demand)."""
        protocol.configure_chaos(spec)
        self._fr("chaos_config", spec=spec)
        return True

    # -------------------------------------------- head outage / reconnect
    def _on_head_conn_close(self, c) -> None:
        """Graceful degradation instead of suicide: during a head outage
        or partition the daemon keeps serving warm-path leases from its
        existing pools, queues gossip/flight-recorder deltas, and drains
        them after the reconciliation handshake on heal."""
        if self.stopping.is_set() or self._reconnecting:
            return
        timeout = float(_config.get("node_reconnect_timeout_s"))
        if timeout <= 0:
            self.stopping.set()
            return
        self._reconnecting = True
        self._fr("head_lost", epoch=self.head_epoch)
        asyncio.ensure_future(self._head_reconnect_loop(timeout))

    async def _head_reconnect_loop(self, timeout: float) -> None:
        try:
            deadline = time.monotonic() + timeout
            delay = 0.2
            while not self.stopping.is_set() and time.monotonic() < deadline:
                try:
                    conn = await protocol.connect(
                        self.head_host, self.head_port,
                        handlers=self._head_handlers(), name="node")
                except OSError:
                    await asyncio.sleep(delay)
                    delay = min(delay * 1.6, 2.0)
                    continue
                try:
                    reply = await conn.request(
                        "register_node", node_id=self.node_id.binary(),
                        resources=self.resources, labels=self.labels,
                        max_workers=self.max_workers,
                        data_port=self.data_port,
                        sched_port=self.sched_port,
                        interest="auto")
                except Exception:
                    try:
                        await conn.close()
                    except Exception:
                        pass
                    await asyncio.sleep(delay)
                    delay = min(delay * 1.6, 2.0)
                    continue
                self.conn = conn
                conn.on_close = self._on_head_conn_close
                self.head_epoch = reply.get("epoch", 0)
                self._fr("head_reconnect", epoch=self.head_epoch)
                await self._send_reconcile()
                if self._interest_extra:
                    # re-assert on-demand interest widening: the fresh
                    # registration reset our view_sub to the auto scope
                    try:
                        conn.push("widen_interest",
                                  shards=sorted(self._interest_extra))
                    except Exception:
                        pass
                # drain queued telemetry + re-advertise pool state under
                # the (possibly new) epoch
                self._gossip_send(bump=True)
                if conn.closed:
                    # the head died again mid-handshake; its on_close was
                    # swallowed by the _reconnecting guard — retry here
                    # instead of returning detached forever
                    await asyncio.sleep(delay)
                    continue
                return
            self.stopping.set()
        finally:
            self._reconnecting = False
            if (not self.stopping.is_set() and self.conn is not None
                    and self.conn.closed):
                # close landed between the in-loop check and the guard
                # clearing: re-enter the normal head-loss path now that
                # it will no longer be swallowed
                self._on_head_conn_close(self.conn)

    async def _send_reconcile(self) -> None:
        """Report the full pool inventory (idle + live local leases) and
        the live actor processes so the head rebuilds its carve-out ledger
        from us — the daemon is the source of truth for carved capacity."""
        inventory = []
        for ent in list(self.pool_idle) + list(self.pool_leases.values()):
            inventory.append({
                "wid": ent["wid"],
                "resources": dict(ent.get("res") or dict(ent["shape"])),
                "venv_key": ent.get("venv_key"),
                "seq": ent.get("seq")})
        for wid, ent in list(self.actor_workers.items()):
            proc = self.procs.get(ent["pid"])
            if proc is None or proc.poll() is not None:
                del self.actor_workers[wid]
        if self.conn is None or self.conn.closed:
            return
        # spill-restore: re-advertise this node's surviving object
        # inventory (primary shm/arena/spilled metas cached from the
        # directory gossip + our pulled replicas) so a restarted head
        # rebuilds its object directory from daemon truth — shm objects
        # no longer die with the head
        objects = None
        if _config.get("object_directory"):
            objects = {
                "metas": list(self.local_objects.values()),
                "replicas": [oid.binary() for oid in
                             (self.pull.replica_ids() if self.pull else ())]}
        try:
            rep = await self.conn.request(
                "pool_reconcile", inventory=inventory,
                epoch=self.head_epoch, objects=objects,
                actors=list(self.actor_workers.values()))
        except protocol.RpcError:
            return
        if rep:
            self.head_epoch = rep.get("epoch", self.head_epoch)
            self._fr("pool_reconcile", reported=len(inventory),
                     adopted=rep.get("adopted"),
                     released=rep.get("released"),
                     objects=len(self.local_objects))
        # the rebuilt ledger covers releases queued under a dead epoch
        # (their workers are simply absent from the report) — drop them
        self._pending_releases = [p for p in self._pending_releases
                                  if p["epoch"] == self.head_epoch]

    # ------------------------------------------- node-local scheduling
    def _on_sched_connect(self, conn: protocol.Connection) -> None:
        """Per-client scheduler session. Leases are bound to the client's
        live connection — its death returns every held worker to the pool
        (the renew protocol is connection liveness, like the reference's
        lease expiry on client disconnect)."""
        held: set = set()

        def _spill(reason: str) -> dict:
            self._fr("spillback", reason=reason)
            return {"spill": reason}

        async def lease_grant(resources, label_selector=None, venv_key=None,
                              epoch=None, referred=None):
            if epoch is not None and self.head_epoch \
                    and epoch != self.head_epoch:
                # the client's cached view predates a head restart (or
                # lags ours): refuse and let it spill to the head, which
                # grants under the current epoch — stale-epoch traffic is
                # fenced, never silently applied. The same fence covers
                # peer-referred grants: a daemon partitioned across an
                # epoch bump cannot double-grant against a rebuilt ledger.
                if referred:
                    self._fr("peer_refuse", reason="epoch", referrer=referred)
                return _spill("epoch")
            if not matches_labels(self.labels, label_selector):
                if referred:
                    self._fr("peer_refuse", reason="labels",
                             referrer=referred)
                return _spill("labels")
            shape = tuple(sorted(resources.items()))
            t0 = time.monotonic()
            ent = self._pool_take(shape, venv_key)
            warm = ent is not None
            if ent is None and referred:
                # a peer daemon referred this client here expecting a warm
                # worker; the referral was stale — refuse WITHOUT
                # cascading (no head carve, no further referral: referral
                # chains must terminate after one hop)
                self._fr("peer_refuse", reason="cold", referrer=referred)
                return _spill("cold")
            if ent is None:
                # cold pool. Daemon-to-daemon spillback first: a peer
                # whose gossiped pool shows warm idle workers can grant
                # NOW with zero head involvement (warm steal beats a cold
                # head carve, and it is the only path that keeps task
                # throughput alive while the head is paused/partitioned).
                # The head carve remains the growth path when no peer
                # advertises warm capacity — the last resort, not the
                # default.
                peers = self._spill_candidates(resources, label_selector)
                if peers:
                    self._fr("peer_spill", shape=list(shape),
                             peers=[p["node_id"][:12] for p in peers])
                    return {"spill": "peer", "peers": peers}
                if self.conn is None or self.conn.closed:
                    return _spill("head")
                try:
                    fut = self.conn.request_future(
                        "pool_acquire", resources=resources,
                        venv_key=venv_key, epoch=self.head_epoch)
                except Exception:
                    return _spill("head")
                try:
                    # bounded: a SIGSTOPped head keeps the TCP connection
                    # alive, so an unbounded carve RPC would stall every
                    # cold grant on this node for the whole outage. The
                    # request itself is shielded — a LATE grant (slow
                    # worker spawn, head resuming) is adopted into the
                    # pool instead of leaking the head-side carve-out.
                    rep = await asyncio.wait_for(
                        asyncio.shield(fut),
                        timeout=float(
                            _config.get("pool_acquire_timeout_s")))
                except protocol.RpcError:
                    return _spill("head")
                except asyncio.TimeoutError:
                    fut.add_done_callback(
                        lambda f: self._adopt_late_carve(
                            f, venv_key, shape, dict(resources)))
                    return _spill("head")
                if rep is None:
                    return _spill("resources")
                self._fr("pool_acquire", shape=list(shape),
                         wait_s=round(time.monotonic() - t0, 6))
                ent = {"wid": rep["worker_id"], "addr": tuple(rep["addr"]),
                       "venv_key": venv_key, "shape": shape,
                       "res": dict(resources),
                       "seq": rep.get("grant_seq"),
                       "since": time.monotonic()}
                if conn.closed:
                    # client died during the head round trip: its on_close
                    # already drained `held`, so lease it to nobody — pool
                    # the fresh worker instead of leaking it forever
                    self.pool_idle.append(ent)
                    self._gossip_soon()
                    return None
            self.pool_leases[ent["wid"]] = ent
            held.add(ent["wid"])
            if referred:
                # warm grant for a peer referral: count it separately so
                # the mesh is observable (lease_peer_spillbacks_total /
                # peer_grants on /metrics and in the lease-event stream)
                self._fr("peer_grant", shape=list(shape), referrer=referred,
                         worker=ent["wid"].hex()[:12])
            self._fr("local_grant", shape=list(shape), warm=warm,
                     worker=ent["wid"].hex()[:12])
            self._gossip_soon()
            rep = {"worker_id": ent["wid"], "addr": ent["addr"]}
            if referred:
                rep["peer"] = self.node_id.hex()
            return rep

        async def lease_return(worker_id):
            held.discard(worker_id)
            self._fr("lease_return", worker=worker_id.hex()[:12])
            self._pool_return(worker_id)
            return True

        async def health_ping():
            return True

        conn.handlers.update({"lease_grant": lease_grant,
                              "lease_return": lease_return,
                              "health_ping": health_ping})
        orig_close = conn.on_close

        def on_close(c):
            if orig_close:
                orig_close(c)
            for wid in list(held):
                self._pool_return(wid)

        conn.on_close = on_close

    _FR_COUNTERS = {"local_grant": "local_grants", "spillback": "spillbacks",
                    "pool_acquire": "pool_acquires",
                    "lease_return": "lease_returns",
                    "pool_release": "pool_releases",
                    "pool_worker_died": "pool_worker_deaths",
                    "peer_spill": "peer_spillbacks",
                    "peer_grant": "peer_grants"}

    def _adopt_late_carve(self, fut, venv_key, shape, resources) -> None:
        """A pool_acquire we timed out on completed anyway: the head has
        already debited its ledger and marked the worker pooled, so
        dropping the reply would leak the carve-out forever (the head
        never dispatches to pooled workers). Adopt it into the idle pool
        instead — the next matching grant serves it warm."""
        if fut.cancelled() or fut.exception() is not None:
            return
        rep = fut.result()
        if not rep:
            return
        self._fr("pool_acquire", shape=list(shape), late=True)
        self.pool_idle.append(
            {"wid": rep["worker_id"], "addr": tuple(rep["addr"]),
             "venv_key": venv_key, "shape": shape, "res": resources,
             "seq": rep.get("grant_seq"), "since": time.monotonic()})
        self._gossip_soon()

    def _spill_candidates(self, resources, label_selector) -> List[dict]:
        """Peer daemons this node can refer a cold lease request to,
        resolved entirely from the cached cluster view + digest (zero
        head RPCs — that is the point)."""
        limit = int(_config.get("peer_spill_attempts"))
        if limit <= 0:
            return []
        return self.cluster_view.spill_candidates(
            resources, label_selector, exclude=self.node_id.hex(),
            limit=limit)

    def _fr(self, kind: str, **detail) -> None:
        """Record a flight-recorder event + bump its lifetime counter; the
        ring drains into the next gossip delta (no RPC of its own)."""
        self.fr_events.record(kind, **detail)
        key = self._FR_COUNTERS.get(kind)
        if key is not None:
            self.sched_stats[key] += 1

    def _pool_take(self, shape: tuple, venv_key):
        for i in range(len(self.pool_idle) - 1, -1, -1):
            ent = self.pool_idle[i]
            if ent["shape"] == shape and ent["venv_key"] == venv_key:
                del self.pool_idle[i]
                return ent
        return None

    def _pool_return(self, worker_id: bytes) -> None:
        ent = self.pool_leases.pop(worker_id, None)
        if ent is None:
            return  # already reaped (worker died) or double return
        ent["since"] = time.monotonic()
        self.pool_idle.append(ent)
        self._gossip_soon()

    async def _pool_shrink_loop(self) -> None:
        """Return pooled workers (and their head-side carve-outs) after
        they idle too long — the pool borrows capacity, it doesn't own
        it forever."""
        idle_s = _config.get("pool_idle_s")
        while not self.stopping.is_set():
            await asyncio.sleep(max(idle_s / 2, 0.5))
            now = time.monotonic()
            keep = [e for e in self.pool_idle
                    if now - e["since"] <= idle_s]
            drop = [e for e in self.pool_idle
                    if now - e["since"] > idle_s]
            if not drop:
                continue
            self.pool_idle = keep
            for ent in drop:
                self._fr("pool_release", worker=ent["wid"].hex()[:12],
                         idle_s=round(now - ent["since"], 3))
                # NOT fire-and-forget: an unreachable head mid-release
                # used to leak the head-side carve-out forever — queue it
                # for delivery with bounded backoff; the (epoch,
                # grant_seq) key makes duplicates/retries idempotent
                self._pending_releases.append(
                    {"wid": ent["wid"], "seq": ent.get("seq"),
                     "epoch": self.head_epoch, "attempts": 0,
                     "next_try": time.monotonic()})
            self._gossip_soon()

    async def _release_flush_loop(self) -> None:
        """Deliver queued pool_release returns; retry with bounded
        exponential backoff while the head is unreachable. Stale-epoch
        entries are settled by the reconciliation handshake instead
        (the head rebuilds its ledger from our inventory)."""
        while not self.stopping.is_set():
            await asyncio.sleep(0.25)
            if not self._pending_releases:
                continue
            if self.conn is None or self.conn.closed:
                continue
            now = time.monotonic()
            for p in list(self._pending_releases):
                if p["next_try"] > now:
                    continue
                try:
                    await self.conn.request(
                        "pool_release", worker_id=p["wid"],
                        grant_seq=p["seq"], epoch=p["epoch"])
                except protocol.RpcError:
                    p["attempts"] += 1
                    p["next_try"] = time.monotonic() + min(
                        0.5 * (2 ** p["attempts"]), 5.0)
                    continue
                # applied, idempotent no-op, or stale-epoch (reconcile
                # covers it): the head-side carve-out is settled
                try:
                    self._pending_releases.remove(p)
                except ValueError:
                    pass

    def _gossip_soon(self) -> None:
        """Debounced versioned delta to the head (ray_syncer node half)."""
        if self._gossip_pending:
            return
        self._gossip_pending = True
        asyncio.get_running_loop().call_later(
            _config.get("gossip_debounce_s"), self._gossip_flush)

    def _gossip_flush(self) -> None:
        self._gossip_pending = False
        self._gossip_send(bump=True)

    def _gossip_send(self, bump: bool) -> None:
        """Send a resource_view_delta (a request now: the reply acks the
        flight-recorder batch). `bump=True` is a real state change (new
        version, head re-evaluates the view); `bump=False` is the
        telemetry heartbeat — it resends the CURRENT version so the head
        merges the piggybacked flight-recorder payload and refreshes its
        staleness clock without the view plane rebroadcasting anything.

        Delivery acks: drained ring events wait in `_fr_pending` until
        the head acknowledges their seq; un-acked batches ride every
        delta (the head drops duplicates by per-node seq) and survive a
        dying connection — a delta lost mid-daemon-death no longer loses
        its drained batch (the reconnect resends it)."""
        if self.conn is None or self.conn.closed:
            return  # ring + pending keep buffering; drained on reconnect
        if bump:
            self._gossip_version += 1
        # resend buffer bounded at 1024 (drained ≤256 per delta): when
        # acks stall long enough to fill it, further events stay in the
        # ring, which bounds itself and counts overflow as dropped
        room = min(256, 1024 - len(self._fr_pending))
        if room > 0:
            self._fr_pending.extend(self.fr_events.drain(limit=room))
        events = list(self._fr_pending)
        gossip = {"view_version": self.cluster_view.version,
                  "view_age_s": round(self.cluster_view.staleness_s(), 3),
                  "dir_age_s": round(self.object_dir.staleness_s(), 3),
                  "dir_v": self.object_dir.last_v,
                  "events_dropped": self.fr_events.dropped}
        # replica announcements (pull-replica created / evicted) ride the
        # same delta; a batch lost with a dying connection only delays an
        # optimization, so no ack tracking — the reconcile handshake
        # re-advertises surviving replicas wholesale anyway
        dir_out, self._dir_out = self._dir_out, []
        stats = dict(self.sched_stats)
        if self.pull is not None:
            stats.update(self.pull.stats)
            stats["replica_count"] = self.pull.replica_count()
        if self.store is not None:
            # object-store pressure rides the gossip so the head can stamp
            # store_frac into the broadcast view entries — the data
            # plane's backpressure signal, zero extra RPCs
            stats["store_used"] = int(self.store.used)
            stats["store_cap"] = int(getattr(self.store, "capacity", 0))
        metrics_snap = None
        drained_spans = None
        now = time.monotonic()
        from ray_tpu_torch.util import metrics as _metrics
        from ray_tpu_torch.util import tracing as _tracing

        if now - self._fr_metrics_ts >= _config.get(
                "metrics_push_interval_s"):
            self._fr_metrics_ts = now
            # full telemetry payload: registry snapshot + piggybacked
            # workload stats and drained spans (same channel, zero RPCs).
            # Spans drained explicitly so a failed/nacked delta can put
            # them back instead of holing the cross-process timeline.
            drained_spans = _tracing.drain_push_spans()
            metrics_snap = _metrics.push_payload(drained_spans)
        self._last_gossip_ts = now
        # per-shape composition of the warm pool (the exact sorted
        # (resource, amount) tuples _pool_take matches on): broadcast via
        # the view so peer-spillback referrals can skip peers that
        # provably hold no matching warm worker. Always sent (possibly
        # empty) — an empty list is a real signal ("warm but wrong-shaped
        # pools elsewhere won't help you"), None would mean "unknown".
        shape_counts: Dict[tuple, int] = {}
        for ent in self.pool_idle:
            sh = tuple(tuple(p) for p in (ent.get("shape") or ()))
            shape_counts[sh] = shape_counts.get(sh, 0) + 1
        pool_shapes = [[[list(p) for p in sh], c]
                       for sh, c in sorted(shape_counts.items())]
        try:
            fut = self.conn.request_future(
                "resource_view_delta", version=self._gossip_version,
                idle_workers=len(self.pool_idle),
                leased_workers=len(self.pool_leases),
                events=events, stats=stats,
                gossip=gossip, metrics=metrics_snap,
                epoch=self.head_epoch, objects=dir_out or None,
                pool_shapes=pool_shapes)
        except Exception:
            self._dir_out = dir_out + self._dir_out
            if drained_spans:
                _tracing.requeue_push_spans(drained_spans)
            return  # events stay pending; the next heartbeat retries

        def _acked(f, spans=drained_spans):
            if f.cancelled() or f.exception() is not None:
                if spans:
                    _tracing.requeue_push_spans(spans)
                return  # still pending; resent with the next delta
            rep = f.result()
            if not isinstance(rep, dict):
                # head replied but didn't merge (e.g. our node record is
                # mid-reconnect): the delta's telemetry never landed —
                # resend the spans like the failure path does
                if spans:
                    _tracing.requeue_push_spans(spans)
                return
            if rep.get("nack"):
                # stale epoch: the head dropped the whole delta before
                # the telemetry merge; reconciliation (already requested
                # by the head) will refresh the epoch — resend the spans
                # with a later delta like the event batch
                if spans:
                    _tracing.requeue_push_spans(spans)
                return
            ack = rep.get("acked_seq", 0)
            if ack:
                self._fr_pending = [e for e in self._fr_pending
                                    if e["seq"] > ack]

        fut.add_done_callback(_acked)

    async def _fr_heartbeat_loop(self) -> None:
        """Telemetry liveness: a quiet daemon (no pool churn → no deltas)
        must still deliver its ring/stats and keep the head's
        cluster_view_staleness_s honest — heartbeats reuse the gossip
        channel with an unchanged version (zero view-plane cost)."""
        interval = max(float(_config.get("metrics_push_interval_s")), 0.25)
        while not self.stopping.is_set():
            await asyncio.sleep(interval / 2)
            if time.monotonic() - self._last_gossip_ts >= interval:
                self._gossip_send(bump=False)

    async def _on_cluster_view(self, snap):
        prev_age = self.cluster_view.staleness_s()
        if "shards" in snap:
            # interest-scoped broadcast: only the shards this daemon
            # subscribed to (plus the digest) — adopt per-shard
            self.cluster_view.adopt_shards(snap)
            nodes = sum(len(b.get("nodes") or ())
                        for b in snap.get("shards") or ())
        else:
            self.cluster_view.adopt(snap)
            nodes = len(snap.get("nodes", []))
        self.head_epoch = snap.get("epoch", self.head_epoch)
        self._adopt_directory(snap.get("objects"))
        self._fr("view_adopt", version=snap.get("version"),
                 nodes=nodes, age_s=round(prev_age, 3))
        return True

    # ------------------------------------------------ object data plane
    def _adopt_directory(self, payload) -> None:
        """Apply an object-directory payload from a cluster_view push.

        Alongside the shared cache, track full metas of objects PRIMARY
        on this node in `local_objects` — the inventory the reconcile
        handshake re-advertises so a restarted head rebuilds its object
        directory from daemon truth. A FULL payload only ADDS to
        local_objects (a freshly restarted head's wholesale snapshot is
        empty — wiping here would destroy the very inventory the
        handshake exists to restore); removals ride explicit free
        records and head-pushed free_object."""
        if not payload:
            return
        me = self.node_id.hex()
        for rec in (payload.get("delta") or ()):
            op = rec.get("op")
            if op in ("seal", "spill"):
                meta = rec["meta"]
                if meta.node_id is not None and meta.node_id.hex() == me:
                    self.local_objects[meta.object_id.binary()] = meta
            elif op == "free":
                self.local_objects.pop(rec["oid"], None)
        for ent in (payload.get("full") or ()):
            meta = ent["meta"]
            if meta.node_id is not None and meta.node_id.hex() == me:
                self.local_objects[meta.object_id.binary()] = meta
        self.object_dir.apply(payload)

    async def _resolve_pull_sources(self, meta) -> list:
        """Pull sources for this node's pull manager: the cached gossiped
        directory + cluster-view data addresses first (zero head RPCs on
        the warm path); the head's locate_object only on a cold miss."""
        from ray_tpu_torch.core.object_directory import resolve_addrs

        out = resolve_addrs(self.object_dir, meta,
                            self.cluster_view.data_addr_of,
                            self.head_host, exclude=self.node_id.hex())
        if not out and self.conn is not None and not self.conn.closed:
            self.sched_stats["locate_fallbacks"] += 1
            try:
                rep = await self.conn.request(
                    "locate_object",
                    object_id=meta.object_id.binary(), timeout=15)
            except protocol.RpcError:
                rep = None
            if rep:
                for s in (rep.get("sources")
                          or ([rep["data_addr"]]
                              if rep.get("data_addr") else [])):
                    out.append((s[0] or self.head_host, s[1]))
                self._maybe_widen_interest(rep.get("nodes") or ())
        return out

    def _maybe_widen_interest(self, serving_hexes) -> None:
        """Interest-on-demand (ROADMAP item 1 follow-on): a cold miss on
        a scoped view means the serving node lives outside our interest
        shards — widen the subscription to its shard so repeated
        data-plane pulls from that neighborhood stop paying the
        locate_object fallback. One fire-and-forget push per new shard;
        the head replies with a fresh scoped view covering it."""
        nshards = self.cluster_view.nshards
        if nshards <= 1 or not serving_hexes:
            return
        from ray_tpu_torch.core.resource_view import shard_of

        own = shard_of(self.node_id.hex(), nshards)
        new = {shard_of(h, nshards) for h in serving_hexes}
        new -= self._interest_extra | {own}
        if not new:
            return
        self._interest_extra |= new
        self._fr("interest_widen", shards=sorted(new))
        if self.conn is not None and not self.conn.closed:
            try:
                self.conn.push("widen_interest", shards=sorted(new))
            except Exception:
                pass

    def _on_replica_created(self, local_meta) -> None:
        from ray_tpu_torch.core import object_directory as objdir

        self._dir_out.append(objdir.replica_record(
            local_meta.object_id, self.node_id.hex()))
        self._gossip_soon()

    def _on_replica_dropped(self, oid) -> None:
        from ray_tpu_torch.core import object_directory as objdir

        self._dir_out.append(objdir.replica_gone_record(
            oid, self.node_id.hex()))
        self._gossip_soon()

    async def _on_drop_replica(self, object_id):
        """Head-pushed when the canonical object is freed: unlink our
        pulled replica (the meta the head holds describes the primary's
        storage, not our copy)."""
        from ray_tpu_torch.core.ids import ObjectID

        if self.pull is not None:
            self.pull.drop(ObjectID(object_id))
        return True

    async def _on_pool_worker_died(self, worker_id):
        self.pool_leases.pop(worker_id, None)
        self.pool_idle = [e for e in self.pool_idle
                          if e["wid"] != worker_id]
        self._fr("pool_worker_died", worker=worker_id.hex()[:12])
        self._gossip_soon()
        return True

    async def _on_actor_worker(self, wid, pid, actor_id, resources,
                               pg=None, bundle=None):
        if actor_id is None:
            self.actor_workers.pop(wid, None)
        else:
            self.actor_workers[wid] = {
                "wid": wid, "pid": pid, "actor_id": actor_id,
                "resources": resources, "pg": pg, "bundle": bundle}
        return True

    async def _spawn_worker(self, pip=None, pip_key=None):
        from ray_tpu_torch.core.resources import strip_device_env
        from ray_tpu_torch.core import worker_logs

        env = strip_device_env(dict(os.environ))
        env["RAY_TPU_HEAD_PORT"] = str(self.head_port)
        env["RAY_TPU_HEAD_HOST"] = self.head_host
        env["RAY_TPU_SESSION"] = self.session
        env["RAY_TPU_NODE_ID"] = self.node_id.hex()
        # local workers route remote-object pulls through this daemon's
        # pull manager (each object crosses the network once per node)
        env["RAY_TPU_NODE_DATA_PORT"] = str(self.data_port)
        if self.store_ns:
            env["RAY_TPU_STORE_NAMESPACE"] = self.store_ns
        python = sys.executable
        if pip:
            # pip-isolated worker: build/reuse the content-addressed venv
            # OFF the daemon loop (first build runs pip install) and start
            # the worker from its interpreter (reference
            # runtime_env_agent.py:298 GetOrCreateRuntimeEnv + pip.py)
            from ray_tpu_torch.core import runtime_env as _renv

            loop = asyncio.get_running_loop()
            python = await loop.run_in_executor(
                None, _renv.materialize_venv, pip, pip_key)
            env["RAY_TPU_VENV_KEY"] = pip_key or _renv.pip_env_key(pip)
        # fd-level stdio capture; the daemon's LogMonitor tails these and
        # pushes appended lines to the head (reference log_monitor.py)
        out, err, tag = worker_logs.open_worker_logs(
            self.session, tag=f"{self.node_id.hex()[:6]}-{os.urandom(3).hex()}",
            subdir=f"node-{self.node_id.hex()[:12]}")
        env["RAY_TPU_LOG_TAG"] = tag
        env.setdefault("PYTHONUNBUFFERED", "1")
        with out, err:
            proc = subprocess.Popen(
                [python, "-m", "ray_tpu_torch.core.worker_main"],
                env=env, stdout=out, stderr=err)
        self.procs[proc.pid] = proc
        return proc.pid

    async def _kill_worker(self, pid):
        proc = self.procs.pop(pid, None)
        try:
            if proc is not None:
                proc.kill()
            else:
                os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        return True

    async def _adopt_object(self, meta):
        """Track an object the head can't see (isolation/multi-host):
        capacity accounting + watermark spilling live with this node."""
        if self.store is not None:
            try:
                self.store.adopt(meta)
            except Exception:
                pass
        return True

    async def _free_object(self, meta):
        """Head-forwarded free of an object living on this node."""
        self.local_objects.pop(meta.object_id.binary(), None)
        if self.pull is not None:
            self.pull.drop(meta.object_id)
        if self.store is not None:
            try:
                self.store.free(meta)
            except Exception:
                pass
        return True

    async def _shutdown_node(self):
        self.stopping.set()
        return True

    async def run(self):
        # SIGTERM (Cluster.shutdown, the CLI's stop) takes the same path
        # as a head-pushed shutdown_node: without it the default action
        # skips the teardown below and the node's shm outlives it
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM,
                                                      self.stopping.set)
        await self.stopping.wait()
        if getattr(self, "_log_monitor", None) is not None:
            self._log_monitor.stop()
        for proc in self.procs.values():
            try:
                proc.kill()
            except ProcessLookupError:
                pass
        if self._sched_server is not None:
            await self._sched_server.stop()
        if self._data_server is not None:
            await self._data_server.stop()
        if self.pull is not None:
            await self.pull.close()
        if self.store is not None:
            # node death takes its objects with it (reference: plasma dies
            # with the raylet); unlink what this store still maps
            self.store.shutdown()


async def amain(args):
    protocol.enable_eager_tasks(asyncio.get_running_loop())
    host, port_s = args.address.rsplit(":", 1)
    daemon = NodeDaemon(
        host, int(port_s), num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        resources=json.loads(args.resources) if args.resources else None,
        labels=json.loads(args.labels) if args.labels else None,
        max_workers=args.max_workers)
    await daemon.start()
    print(f"RAY_TPU_NODE_ID={daemon.node_id.hex()}", flush=True)
    await daemon.run()


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--address", required=True, help="head host:port")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument("--num-gpus", type=int, default=None)
    p.add_argument("--resources", type=str, default=None)
    p.add_argument("--labels", type=str, default=None)
    p.add_argument("--max-workers", type=int, default=None)
    args = p.parse_args()
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
