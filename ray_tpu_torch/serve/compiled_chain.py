"""Compiled serve replica chain: the serving plane's standing fast path
(counterpart of `ray_tpu/serve/compiled_chain.py`). It imports no torch.

The dynamic handle path (serve/handle.py) pays per-request work on every
hop: routing-table refresh, replica pick, actor-call RPC submission,
result resolution. This module compiles a replica CHAIN (proxy ->
preprocess -> ... -> model replica) ONCE into ring-channel edges
(ray_tpu_torch/dag): the caller writes the input ring and reads the output
ring, with zero control-plane RPCs per warm request (counted by the
interposer in tests/test_torch_serve_compiled.py). Scheduling work happens
only at (re)compile time.

Batched ring entries: one entry carries up to `batch_max` queued requests,
so an engine's continuous batching still applies across an entry
(`ReplicaActor.handle_chain` hands the whole entry to `batch_call` when the
callable exposes it). The writer coalesces adaptively: an idle chain ships
a lone request at once; once entries are in flight it waits a few ms to
fill the next one. `max_inflight` keeps entries pipelined in each ring.

Lanes: `lanes=k` compiles k independent rings, spread round-robin over the
deployment's healthy replicas in sorted tag order (lane i runs over
replica i % m of each stage), decided once at compile time. Lanes sharing
a replica each hold one of its executor threads, so keep lanes <=
max_ongoing_requests. `maybe_rebalance` recompiles when replicas were
added (no death to observe).

Failure model: the chain records the cluster epoch and a local generation
at compile time. A chain replica dying (the `actor_state` pubsub, an infra
error marker drained from a ring, or a ring read or write timeout) fences
the generation: new submissions take the dynamic handle path at once,
in-flight entries are drained where possible and failed over otherwise,
and a background thread recompiles over the surviving or replaced
replicas. Requests never see a 500 for infrastructure reasons. Sampled
requests (1 in `tracing_compiled_sample_n`) carry their trace context in
the ring entry (`TracedValue`); a telemetry thread publishes ring
occupancy (`publish_ring_stats`) every `ring_telemetry_interval_s`.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Dict, List, Optional

CHAIN_ERR = "__rtpu_chain_error__"


def infra_error(detail: str) -> dict:
    """Marker for an infrastructure failure: the chain client fails the
    item over to the dynamic handle path instead of surfacing an error."""
    return {CHAIN_ERR: detail, "infra": True}


def is_chain_error(value) -> bool:
    return isinstance(value, dict) and CHAIN_ERR in value


class TracedValue:
    """Envelope for a 1-in-N sampled request: the W3C carrier rides the
    ring entry next to the value, so each stage can parent its span to
    the submitter's (and re-wrap its output with its OWN context for the
    next stage) — the compiled path's submit→stage→stage span chain with
    zero extra RPCs. Stages that don't know about tracing would see the
    envelope, so `ReplicaActor.handle_chain` unwraps before the callable
    and re-wraps after."""

    __slots__ = ("carrier", "value")

    def __init__(self, carrier, value):
        self.carrier = carrier
        self.value = value

    def __reduce__(self):
        return (TracedValue, (self.carrier, self.value))


def unwrap_traced(value):
    """(carrier, inner_value) — carrier is None for plain values."""
    if isinstance(value, TracedValue):
        return value.carrier, value.value
    return None, value


class ChainResponse:
    """Future for one request submitted to the chain."""

    def __init__(self, value):
        self.request = value
        self._ev = threading.Event()
        self._value = None
        self._exc: Optional[BaseException] = None
        self._cbs: List = []
        self._cb_lock = threading.Lock()

    def _finish(self) -> None:
        with self._cb_lock:
            self._ev.set()
            cbs, self._cbs = self._cbs, []
        for cb in cbs:
            try:
                cb(self)
            except Exception:
                pass

    def _set(self, value) -> None:
        self._value = value
        self._finish()

    def _set_exc(self, exc: BaseException) -> None:
        self._exc = exc
        self._finish()

    def done(self) -> bool:
        return self._ev.is_set()

    def add_done_callback(self, fn) -> None:
        """Invoke `fn(self)` once the response completes — immediately if
        it already has. Runs on the completing thread: an asyncio caller
        (the proxy) bridges with loop.call_soon_threadsafe instead of
        parking an executor thread per in-flight request."""
        with self._cb_lock:
            if not self._ev.is_set():
                self._cbs.append(fn)
                return
        try:
            fn(self)
        except Exception:
            pass

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError("chain request timed out")
        if self._exc is not None:
            raise self._exc
        return self._value


class CompiledServeChain:
    """Compile a sequential deployment chain into channel edges.

    deployments: deployment names in chain order; each stage's output is
    the next stage's input (`value = stage(value)`).
    """

    def __init__(self, deployments: List[str], *,
                 lanes: int = 2, max_inflight: int = 4, batch_max: int = 8,
                 coalesce_ms: float = 3.0,
                 channel_capacity: int = 1 << 20,
                 entry_timeout_s: float = 60.0,
                 recompile_timeout_s: float = 60.0,
                 controller=None, plane: str = "serve_chain"):
        if not deployments:
            raise ValueError("need at least one deployment")
        self.deployments = list(deployments)
        # telemetry plane label: in-process chains publish as
        # "serve_chain"; the proxies' ingress chains publish as
        # "serve_proxy", so the ring telemetry attributes stalls on the
        # proxy edge separately
        self.plane = plane
        self.lanes = max(1, int(lanes))
        self.max_inflight = max(1, int(max_inflight))
        self.batch_max = max(1, int(batch_max))
        self.coalesce_s = max(0.0, coalesce_ms) / 1000.0
        self.capacity = channel_capacity
        self.entry_timeout_s = entry_timeout_s
        self.recompile_timeout_s = recompile_timeout_s
        self._controller = controller
        self._cdags: List[Any] = []
        self._targets: List[tuple] = []       # lane 0: (dep, tag, handle)
        self._lane_targets: List[List[tuple]] = []   # per lane
        self._compiled_tagsets: Dict[str, tuple] = {}
        self._last_rebalance = 0.0
        self._lane_rr = 0                     # round-robin cursor
        self._actor_ids: set = set()
        self.generation = 0
        self.epoch = None
        self._broken = True                   # until first compile
        self._shutdown = False
        self._lock = threading.RLock()
        self._subq: "queue.Queue" = queue.Queue()
        self._pendqs: List["queue.Queue"] = []   # one FIFO per lane
        self._lane_outstanding: List[int] = []
        self._dyn_handles: Dict[str, Any] = {}
        self._dyn_pool = None
        self._death_cb = None
        self._dead_aids: set = set()   # actor ids observed dead (pubsub)
        self._threads: List[threading.Thread] = []
        # lifetime counters (tests/bench/observability)
        self.stats = {"compiled": 0, "dynamic_fallback": 0, "recompiles": 0,
                      "fenced": 0, "entries": 0, "drained_on_fence": 0}
        # bounded event log (fences, recompile attempts, failovers):
        # the chain's own flight recorder for drills and debugging
        self.events: List[tuple] = []
        # hot-path observatory state: sampled-tracing counter, a small
        # completed-latency window (p99 for the hotpath row), and the
        # ring-telemetry thread started by start()
        self._trace_seq = 0
        self._lat_window: List[float] = []
        self.chain_key = "+".join(self.deployments)

    def _log(self, kind: str, **detail) -> None:
        with self._lock:
            self.events.append((round(time.time(), 3), kind, detail))
            if len(self.events) > 200:
                del self.events[:100]

    def _emit_chain_event(self, kind: str, **detail) -> None:
        """Mirror a chain lifecycle event into the head's flight-recorder
        lease-event log (state.list_lease_events / timeline reconcile
        row), so replica-death windows on the compiled plane show up
        next to the scheduler's view. Best-effort, and NEVER on the warm
        path — fences/failovers already pay control-plane RPCs."""
        try:
            from ray_tpu_torch.core.api import _global_client

            _global_client().head_request(
                "chain_event", chain=self.chain_key, kind=kind,
                detail=detail)
        except Exception:
            pass

    # ----------------------------------------------------------- bring-up
    def _ctrl(self):
        if self._controller is None:
            from ray_tpu_torch.serve.api import _get_or_create_controller

            self._controller = _get_or_create_controller()
        return self._controller

    def _resolve_targets(self, exclude: Optional[set] = None) -> List[tuple]:
        """ALL healthy replicas per deployment, from the controller's
        routing table (compile-time only — never on the request path).
        Returns [(deployment, {tag: handle}), ...] in chain order."""
        import ray_tpu_torch

        targets = []
        deadline = time.monotonic() + self.recompile_timeout_s
        for dep in self.deployments:
            while True:
                table = ray_tpu_torch.get(
                    self._ctrl().get_routing_table.remote(dep), timeout=30)
                if table is None:
                    raise KeyError(f"deployment {dep!r} not found")
                replicas = {t: h for t, h in table["replicas"].items()
                            if not exclude
                            or h._actor_id.binary() not in exclude}
                if replicas:
                    targets.append((dep, replicas))
                    break
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no live replicas for {dep!r} within "
                        f"{self.recompile_timeout_s}s")
                time.sleep(0.2)
        return targets

    def _compile(self, exclude: Optional[set] = None) -> None:
        """(Re)build the compiled chain; only path that talks to the
        control plane. Each lane is an independent channel ring, and lane
        i's stage-j ring targets replica i % m_j of deployment j — k
        lanes over m replicas spread the standing rings across the whole
        deployment (per-lane replica assignment, zero per-request
        routing). Lanes sharing a replica each occupy one of its executor
        threads, so their entries still execute concurrently."""
        from ray_tpu_torch.core.api import _global_client
        from ray_tpu_torch.dag.nodes import InputNode

        by_dep = self._resolve_targets(exclude=exclude)
        lane_targets = []
        for lane in range(self.lanes):
            picks = []
            for dep, replicas in by_dep:
                tags = sorted(replicas)
                tag = tags[lane % len(tags)]
                picks.append((dep, tag, replicas[tag]))
            lane_targets.append(picks)
        cdags = []
        for picks in lane_targets:
            with InputNode() as inp:
                node = inp
                for _dep, _tag, handle in picks:
                    node = handle.handle_chain.bind(node)
            cdags.append(node.experimental_compile(
                channel_capacity=self.capacity,
                max_inflight=self.max_inflight))
        # warm every lane BEFORE publishing the generation: the writer /
        # drainer threads must never share channel handles with these
        # warm-up reads (same cursor + scratch buffer), so the chain
        # stays broken (dynamic path) until the new rings proved alive
        try:
            refs = [cd.execute([], timeout=self.entry_timeout_s)
                    for cd in cdags]
            for ref in refs:
                ref.get(timeout=self.entry_timeout_s)
        except Exception:
            # a dead target mid-warm: release the half-built generation
            # (surviving stages' exec loops exit on channel close)
            self._teardown_all(cdags)
            raise
        with self._lock:
            # shutdown() ran while this (re)compile warmed: it took the
            # old generation only, so this one is ours to release
            late = self._shutdown
            if not late:
                self._publish(lane_targets, by_dep, cdags)
        if late:
            self._teardown_all(cdags)
            return
        self._log("compiled", generation=self.generation,
                  targets=[[(d, t) for d, t, _h in picks]
                           for picks in lane_targets])

    def _publish(self, lane_targets, by_dep, cdags) -> None:
        """Make a warmed generation live (under `_lock`)."""
        from ray_tpu_torch.core.api import _global_client

        self._targets = lane_targets[0]
        self._lane_targets = lane_targets
        self._compiled_tagsets = {
            dep: tuple(sorted(replicas)) for dep, replicas in by_dep}
        self._actor_ids = {h._actor_id.binary()
                           for picks in lane_targets
                           for _, _, h in picks}
        self._cdags = cdags
        self._pendqs = [queue.Queue() for _ in range(self.lanes)]
        self._lane_outstanding = [0] * self.lanes
        self._lane_rr = 0
        self.epoch = getattr(_global_client(), "cluster_epoch", None)
        self.generation += 1
        self._broken = False
        self.stats["recompiles"] += 1

    @staticmethod
    def _teardown_all(cdags) -> None:
        for cd in cdags:
            try:
                cd.teardown()
            except Exception:
                pass

    def start(self) -> "CompiledServeChain":
        from ray_tpu_torch.core.api import _global_client

        self._compile()   # compiles AND warms before going live

        # event-time death detection: a chain actor dying
        # fences the generation immediately, not at the next timeout
        def on_actor_state(msg):
            if msg.get("state") not in ("DEAD", "RESTARTING"):
                return
            aid = msg.get("actor_id")
            with self._lock:
                hit = aid in self._actor_ids
                if hit:
                    self._dead_aids.add(aid)
                hit = hit and not self._broken
            if hit:
                # pubsub callbacks run on the client loop thread: fence
                # on a worker thread, never block the loop
                threading.Thread(
                    target=self._fence, args=("actor_death",),
                    daemon=True, name="chain-fence").start()

        self._death_cb = on_actor_state
        _global_client().subscribe_channel("actor_state", on_actor_state)

        t = threading.Thread(target=self._writer_loop, daemon=True,
                             name="chain-writer")
        t.start()
        self._threads.append(t)
        for lane in range(self.lanes):
            t = threading.Thread(target=self._drainer_loop, args=(lane,),
                                 daemon=True, name=f"chain-drainer-{lane}")
            t.start()
            self._threads.append(t)
        try:
            from ray_tpu_torch.core import config as _cfg

            interval = float(_cfg.get("ring_telemetry_interval_s"))
        except Exception:
            interval = 0.0
        if interval > 0:
            t = threading.Thread(target=self._telemetry_loop,
                                 args=(interval,), daemon=True,
                                 name="chain-telemetry")
            t.start()
            self._threads.append(t)
        return self

    # ------------------------------------------------------------ request
    def _maybe_trace(self, value):
        """Sample 1-in-`tracing_compiled_sample_n` submissions for span
        capture when this request is traced (cluster tracing on, or the
        caller holds a span — e.g. an adopted client traceparent): opens
        the chain.submit span and wraps the value with its carrier so
        every stage span parents into the same trace. Unsampled requests
        pay one int check — the zero-RPC warm path is untouched."""
        try:
            from ray_tpu_torch.core import config as _cfg
            from ray_tpu_torch.util import tracing

            n = int(_cfg.get("tracing_compiled_sample_n"))
            if n <= 0 or not tracing.is_recording():
                return value
            seq = self._trace_seq
            self._trace_seq = seq + 1
            if seq % n:
                return value
            with tracing.start_span(
                    "chain.submit",
                    attributes={"ray_tpu_torch.op": "chain_submit",
                                "chain": self.chain_key}) as sp:
                if sp is None:
                    return value
                carrier = {"traceparent": sp.traceparent()}
            return TracedValue(carrier, value)
        except Exception:
            return value

    def submit(self, value) -> ChainResponse:
        """Enqueue one request; never raises for infra reasons — a broken
        chain window routes to the dynamic handle path."""
        if self._shutdown:
            raise RuntimeError("chain was shut down")
        resp = ChainResponse(self._maybe_trace(value))
        resp._t0 = time.monotonic()
        with self._lock:
            broken = self._broken
        if broken:
            self._dynamic_submit([resp])
        else:
            self._subq.put(resp)
        return resp

    def call(self, value, timeout: Optional[float] = None):
        return self.submit(value).result(timeout or self.entry_timeout_s)

    __call__ = call

    # ------------------------------------------------------- worker loops
    def _writer_loop(self) -> None:
        """Adaptive batching dispatcher. An entry dispatches when a FREE
        lane exists AND (the entry is full, or the chain is idle, or the
        coalesce window expired). While every lane is busy, arriving
        requests keep joining the forming entry instead of queueing
        behind a busy ring — at saturation this is exactly the admission
        shape the engine's continuous batching wants, and an idle chain
        ships a lone request with zero added latency."""
        entries: List[ChainResponse] = []
        window_end = 0.0
        while not self._shutdown:
            if not entries:
                try:
                    entries = [self._subq.get(timeout=0.2)]
                except queue.Empty:
                    continue
                window_end = time.monotonic() + self.coalesce_s
            while len(entries) < self.batch_max:
                try:
                    entries.append(self._subq.get_nowait())
                except queue.Empty:
                    break
            with self._lock:
                broken, gen = self._broken, self.generation
                lane = None
                if not broken and self._cdags:
                    free = [i for i in range(len(self._cdags))
                            if self._lane_outstanding[i] < self.max_inflight]
                    if free:
                        # least-outstanding first, round-robin among ties:
                        # an idle chain would otherwise send EVERY entry
                        # down lane 0, defeating the multi-replica lane
                        # spread exactly when requests arrive sequentially
                        n_lanes = len(self._cdags)
                        rr = self._lane_rr
                        lane = min(free, key=lambda i: (
                            self._lane_outstanding[i], (i - rr) % n_lanes))
                        busy = any(o > 0 for o in self._lane_outstanding)
                        if (busy and len(entries) < self.batch_max
                                and time.monotonic() < window_end):
                            lane = None   # keep coalescing
                        else:
                            cdag = self._cdags[lane]
                            pendq = self._pendqs[lane]
                            self._lane_outstanding[lane] += 1
                            self._lane_rr = (lane + 1) % n_lanes
            if broken:
                self._dynamic_submit(entries)
                entries = []
                continue
            if lane is None:
                time.sleep(0.0005)
                continue
            try:
                ref = cdag.execute([e.request for e in entries],
                                   timeout=self.entry_timeout_s)
                self.stats["entries"] += 1
                pendq.put((gen, ref, entries))
                with self._lock:
                    fenced = gen != self.generation or self._broken
                if fenced:
                    # a fence swapped the pendqs while we were inside
                    # execute(): this put may have landed on an orphaned
                    # queue no drainer reads. Reclaim whatever is still
                    # there (the fence's own drain pops items exactly
                    # once too) so no caller is stranded.
                    self._reclaim_pendq(pendq)
            except Exception:
                # ring write failed (dead stage / torn down mid-swap):
                # fail over this batch, fence if still current
                self._lane_done(lane, gen)
                self._dynamic_submit(entries)
                self._maybe_fence(gen, "execute_failed")
            entries = []
        # shutdown: requests popped into the local coalescing buffer but
        # never dispatched still belong to callers — fail them over
        if entries:
            self._dynamic_submit(entries)

    def _reclaim_pendq(self, pendq: "queue.Queue") -> None:
        """Drain an orphaned (fenced-generation) pending queue: deliver
        what the rings still produced, fail over the rest."""
        while True:
            try:
                pgen, ref, entries = pendq.get_nowait()
            except queue.Empty:
                return
            try:
                results = ref.get(timeout=2.0)
                self._deliver(entries, results, pgen)
            except Exception:
                self._dynamic_submit([e for e in entries if not e.done()])

    def _drainer_loop(self, lane: int) -> None:
        while not self._shutdown:
            with self._lock:
                pendq = (self._pendqs[lane]
                         if lane < len(self._pendqs) else None)
            if pendq is None:
                time.sleep(0.2)
                continue
            try:
                gen, ref, entries = pendq.get(timeout=0.2)
            except queue.Empty:
                continue
            try:
                results = ref.get(timeout=self.entry_timeout_s)
            except Exception:
                self._lane_done(lane, gen)
                self._dynamic_submit(entries)
                self._maybe_fence(gen, "drain_failed")
                continue
            self._lane_done(lane, gen)
            self._deliver(entries, results, gen)

    def _lane_done(self, lane: int, gen: int) -> None:
        with self._lock:
            if gen == self.generation and lane < len(self._lane_outstanding):
                self._lane_outstanding[lane] -= 1

    def _telemetry_loop(self, interval: float) -> None:
        """Hot-path observatory sampler: lock-free shm-ring header
        snapshots per lane (occupancy + writer/reader stall attribution
        -> dag_ring_* gauges) plus one aggregated chain row (compiled
        p99 over the recent window, lifetime counters) — all riding the
        existing per-process metrics push. Zero new RPC channels, and
        the native snapshot never takes the channel mutex, so sampling a
        stalled ring cannot slow the stall down further."""
        from ray_tpu_torch.dag.channel import publish_ring_stats
        from ray_tpu_torch.util import metrics

        next_t = time.monotonic() + interval
        while not self._shutdown:
            time.sleep(0.1)
            if time.monotonic() < next_t:
                continue
            next_t = time.monotonic() + interval
            with self._lock:
                cdags = list(self._cdags)
                window = sorted(self._lat_window)
            snaps = {}
            for lane, cd in enumerate(cdags):
                try:
                    for name, s in cd.ring_snapshots().items():
                        snaps[f"{lane}/{name}"] = s
                except Exception:
                    pass
            if snaps:
                publish_ring_stats(self.plane, self.chain_key, snaps)
            try:
                row = {"generation": self.generation,
                       "compiled": self.stats["compiled"],
                       "dynamic_fallback": self.stats["dynamic_fallback"],
                       "fenced": self.stats["fenced"],
                       "entries": self.stats["entries"]}
                if window:
                    row["p99_s"] = round(
                        window[max(0, int(len(window) * 0.99) - 1)], 6)
                metrics.publish_workload(self.plane, self.chain_key, row)
            except Exception:
                pass

    def _deliver(self, entries, results, gen) -> None:
        ok = isinstance(results, list) and len(results) == len(entries)
        if not ok:
            self._dynamic_submit(entries)
            self._maybe_fence(gen, "bad_entry_shape")
            return
        infra_hit = False
        for e, r in zip(entries, results):
            # sampled requests come back in their trace envelope (the
            # last stage re-wrapped with its own context): unwrap before
            # the error check, deliver the inner value, and close the
            # trace with an end-to-end chain.deliver span backdated to
            # the submit time
            carrier, r = unwrap_traced(r)
            if is_chain_error(r):
                if r.get("infra"):
                    infra_hit = True
                    self._dynamic_submit([e])
                else:
                    e._set_exc(RuntimeError(r[CHAIN_ERR]))
            else:
                # counted before the delivery wakes the caller, who may
                # read the stats at once
                self.stats["compiled"] += 1
                e._set(r)
                dt = time.monotonic() - getattr(e, "_t0", time.monotonic())
                with self._lock:
                    self._lat_window.append(dt)
                    if len(self._lat_window) > 512:
                        del self._lat_window[:256]
                if carrier is not None:
                    try:
                        from ray_tpu_torch.util import tracing

                        with tracing.start_span(
                                "chain.deliver", carrier=carrier,
                                attributes={"ray_tpu_torch.op": "chain_deliver",
                                            "chain": self.chain_key,
                                            "duration_s": dt}) as sp:
                            if sp is not None:
                                sp.start_ts = time.time() - dt
                    except Exception:
                        pass
        if infra_hit:
            self._maybe_fence(gen, "infra_marker")

    # ------------------------------------------------------ failure plane
    def _maybe_fence(self, gen: int, reason: str) -> None:
        with self._lock:
            if gen != self.generation or self._broken:
                return
        self._fence(reason)

    def _fence(self, reason: str) -> None:
        """Fence the current generation: stop the compiled path, drain
        or fail over everything in flight, then recompile in background.
        Anything stamped with the old generation is rejected and
        reconciled, never silently retried."""
        with self._lock:
            if self._broken or self._shutdown:
                return
            self._broken = True
            self.stats["fenced"] += 1
            self.events.append((round(time.time(), 3), "fence",
                                {"reason": reason, "gen": self.generation}))
            cdags = self._cdags
            self._cdags = []
            pendqs = self._pendqs
            self._pendqs = []
            self._lane_outstanding = []
            gen = self.generation
        self._emit_chain_event("chain_fence", reason=reason, gen=gen)
        # drain-first: entries that already passed the dead stage may
        # still complete from the output ring; everything else fails
        # over. Bounded short — callers are waiting.
        failed_over = 0
        pending = []
        for pq in pendqs:
            while True:
                try:
                    pending.append(pq.get_nowait())
                except queue.Empty:
                    break
        for pgen, ref, entries in pending:
            # entries still in pendq were never delivered at all
            try:
                results = ref.get(timeout=2.0)
                self._deliver(entries, results, pgen)
                self.stats["drained_on_fence"] += len(entries)
            except Exception:
                undone = [e for e in entries if not e.done()]
                failed_over += len(undone)
                self._dynamic_submit(undone)
        # submissions queued but not yet written also fail over
        backlog = []
        while True:
            try:
                backlog.append(self._subq.get_nowait())
            except queue.Empty:
                break
        if backlog:
            failed_over += len(backlog)
            self._dynamic_submit(backlog)
        if failed_over:
            self._emit_chain_event("chain_failover", reason=reason,
                                   gen=gen, entries=failed_over)

        del gen   # fenced generation: superseded by the recompile below

        def _teardown_and_recompile():
            self._teardown_all(cdags)
            deadline = time.monotonic() + self.recompile_timeout_s
            while not self._shutdown and time.monotonic() < deadline:
                try:
                    # exclude pubsub-observed corpses: the controller may
                    # not have reconciled the death yet, and recompiling
                    # over one would fence again immediately
                    with self._lock:
                        dead = set(self._dead_aids)
                    self._compile(exclude=dead)   # warms before going live
                    return
                except Exception as e:  # noqa: BLE001
                    # stay broken: the dynamic path keeps serving while
                    # the controller replaces the replica; retry
                    self._log("recompile_retry", error=repr(e)[:200])
                    with self._lock:
                        stale = self._cdags
                        self._cdags = []
                        self._broken = True
                    self._teardown_all(stale)
                    time.sleep(0.5)

        threading.Thread(target=_teardown_and_recompile, daemon=True,
                         name="chain-recompile").start()

    def recompile(self) -> None:
        """Manual recompile (tests / membership change without a death)."""
        self._fence("manual")

    def maybe_rebalance(self, replica_tags: Dict[str, set],
                        min_interval_s: float = 5.0) -> bool:
        """Recompile when the deployment's healthy replica set GREW or
        otherwise drifted from what the lanes were compiled over (replica
        deaths already fence via pubsub; autoscale-up has no death to
        observe). Callers feed fresh routing-table tag sets — e.g. the
        proxy's 1 s table refresh — so this costs zero extra RPCs.
        Rate-limited: a fence drains in-flight entries to the dynamic
        path, so rebalance storms would hurt more than a briefly
        lopsided lane assignment. Returns True when a fence was issued."""
        with self._lock:
            if self._broken or self._shutdown or not self._compiled_tagsets:
                return False
            now = time.monotonic()
            if now - self._last_rebalance < min_interval_s:
                return False
            drift = False
            for dep, compiled in self._compiled_tagsets.items():
                fresh = replica_tags.get(dep)
                if fresh is not None and tuple(sorted(fresh)) != compiled:
                    drift = True
                    break
            if not drift:
                return False
            self._last_rebalance = now
        self._fence("rebalance")
        return True

    # ------------------------------------------------------- dynamic path
    def _dyn_handle(self, dep: str):
        if dep not in self._dyn_handles:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            self._dyn_handles[dep] = DeploymentHandle(dep, self._ctrl())
        return self._dyn_handles[dep]

    def _dynamic_submit(self, entries: List[ChainResponse]) -> None:
        """Serve entries through the dynamic handle path (router-level
        replica failover; never a 500 for infra reasons)."""
        if not entries:
            return
        if self._dyn_pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._lock:
                if self._dyn_pool is None:
                    self._dyn_pool = ThreadPoolExecutor(
                        max_workers=16, thread_name_prefix="chain-dyn")

        from ray_tpu_torch.core.exceptions import (ActorDiedError,
                                             ActorUnavailableError,
                                             WorkerCrashedError)

        infra_excs = (ActorDiedError, ActorUnavailableError,
                      WorkerCrashedError, ConnectionError)

        entries = [e for e in entries if not e.done()]
        if not entries:
            return

        def run(e: ChainResponse):
            # infra-aware retry: right after a replica death the routing
            # table may still list the corpse until the controller
            # reconciles — refresh and retry until the replacement lands
            # (the never-500 contract), bounded by the entry timeout
            deadline = time.monotonic() + self.entry_timeout_s
            while True:
                try:
                    # a sampled request failing over sheds its trace
                    # envelope: the dynamic path opens its own spans
                    _carrier, value = unwrap_traced(e.request)
                    for dep in self.deployments:
                        h = self._dyn_handle(dep)
                        value = h.remote(value).result(
                            timeout=max(1.0, deadline - time.monotonic()))
                    e._set(value)
                    self.stats["dynamic_fallback"] += 1
                    return
                except infra_excs as exc:
                    if time.monotonic() > deadline:
                        e._set_exc(exc)
                        return
                    for dep in self.deployments:
                        try:
                            self._dyn_handle(dep)._refresh_table(force=True)
                        except Exception:
                            pass
                    time.sleep(0.2)
                except Exception as exc:
                    e._set_exc(exc)
                    return

        for e in entries:
            self._dyn_pool.submit(run, e)

    # ------------------------------------------------------------ control
    def targets(self) -> List[tuple]:
        """Lane 0's (deployment, tag) chain — kept for compatibility;
        lane_targets() exposes the full per-lane spread."""
        with self._lock:
            return [(d, t) for d, t, _h in self._targets]

    def lane_targets(self) -> List[List[tuple]]:
        with self._lock:
            return [[(d, t) for d, t, _h in picks]
                    for picks in self._lane_targets]

    def is_compiled(self) -> bool:
        with self._lock:
            return not self._broken

    def wait_compiled(self, timeout: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.is_compiled():
                return True
            time.sleep(0.1)
        return False

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        if self._death_cb is not None:
            try:
                from ray_tpu_torch.core.api import _global_client

                _global_client().unsubscribe_channel("actor_state",
                                                     self._death_cb)
            except Exception:
                pass
        with self._lock:
            cdags = self._cdags
            self._cdags = []
            pendqs = self._pendqs
            self._pendqs = []
            self._broken = True
        # fail over anything still queued/in flight before teardown
        leftovers: List[ChainResponse] = []
        while True:
            try:
                leftovers.append(self._subq.get_nowait())
            except queue.Empty:
                break
        pend = []
        for pq in pendqs:
            while True:
                try:
                    pend.append(pq.get_nowait())
                except queue.Empty:
                    break
        for _gen, ref, entries in pend:
            try:
                results = ref.get(timeout=5.0)
                self._deliver(entries, results, _gen)
            except Exception:
                leftovers.extend(e for e in entries if not e.done())
        if leftovers:
            self._dynamic_submit(leftovers)
        self._teardown_all(cdags)
        # the writer may have been blocked inside execute() and a drainer
        # inside ref.get(); teardown woke them, and their exit/failover
        # paths submit through the dynamic pool — join them ALL before
        # closing the pool so no caller's entry is stranded by a
        # submit-after-shutdown
        for t in self._threads:
            t.join(timeout=15)
        if self._dyn_pool is not None:
            self._dyn_pool.shutdown(wait=True)
