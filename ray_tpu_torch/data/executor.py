"""Operator-graph streaming executor for Data pipelines (counterpart of
`ray_tpu/data/executor.py`, on the port's core and `util.metrics`).

Behavioral parity with the reference's StreamingExecutor
(`python/ray/data/_internal/execution/streaming_executor.py:61`,
`streaming_executor_state.py` Topology/OpState,
`backpressure_policy/concurrency_cap_backpressure_policy.py`): the op
chain lowers to a Topology of physical stages, each with its own input
queue, in-flight cap, and stats; the scheduling loop admits work to ANY
stage with capacity, so a block can be in stage 3 while another is still
in stage 1 — inter-operator concurrency, not a fused per-block chain.

Fault tolerance & the data plane: inter-stage blocks are
directory-announced objects pulled through node PullManagers — the
executor ships dep metas with each dispatch (zero get_meta round trips
warm) and prefetches a completed block into the consuming stage's node
before its task dispatches. Every stage task registers its spec in the
head's lineage ledger (`options(lineage=True, data_stage=True)`), so a
block lost to node death is lazily rebuilt by re-running exactly its
producing task; a consumer task that surfaces ObjectLostError (its INPUT
died mid-flight) is retried by the executor instead of failing the
pipeline. Backpressure is two-signal: a congested downstream queue sheds
upstream admission, and gossiped store-pressure rows
(`ClusterView.max_store_frac`) stop stage-0 input admission before the
cluster store OOMs. Consumed intermediates release their lineage entries
eagerly (per-partition chain release) so a long pipeline's footprint
stays bounded by the in-flight window.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.core import config as _config

_GAUGES: Dict[str, Any] = {}


def _metrics() -> Dict[str, Any]:
    """Live per-operator series in the cluster metrics registry (the
    reference streaming executor's Gauge set, streaming_executor.py:105)
    — visible at /metrics as ray_tpu_data_*. ONE shared object per name
    (stages are tag values): per-stage objects would overwrite each
    other in the registry."""
    from ray_tpu_torch.util import metrics as _m

    if not _GAUGES:
        _GAUGES["in_flight"] = _m.Gauge(
            "data_op_in_flight", "Data operator in-flight block tasks",
            tag_keys=("op",))
        _GAUGES["queued"] = _m.Gauge(
            "data_op_queued", "Data operator queued blocks",
            tag_keys=("op",))
        _GAUGES["backpressure"] = _m.Counter(
            "data_backpressure_total",
            "Admission ticks shed by live-signal backpressure",
            tag_keys=("op", "reason"))
        _GAUGES["retries"] = _m.Counter(
            "data_input_retries_total",
            "Pipeline consumer tasks retried after their input block "
            "went lost (rides lineage reconstruction)", tag_keys=("op",))
        _GAUGES["prefetch"] = _m.Counter(
            "data_prefetch_total",
            "Blocks staged into the consuming stage's node ahead of "
            "dispatch", tag_keys=("op",))
    return _GAUGES


def _op_gauges(stage: "Stage", in_flight: int, queued: int) -> None:
    try:
        m = _metrics()
        m["in_flight"].set(in_flight, {"op": stage.name})
        m["queued"].set(queued, {"op": stage.name})
    except Exception:
        pass   # metrics must never break execution


class OpStats:
    """Per-operator execution counters (reference OpState metrics +
    `Dataset.stats()` per-op rows)."""

    def __init__(self, name: str):
        self.name = name
        self.submitted = 0
        self.completed = 0
        self.bytes_out = 0
        self.retried = 0        # resubmits after a lost-input failure
        self.prefetches = 0     # blocks staged ahead of dispatch
        self.throttled = 0      # admission ticks shed by backpressure
        self.first_submit_ts: Optional[float] = None
        self.last_complete_ts: Optional[float] = None
        # (submit_ts, complete_ts) per block — the overlap evidence
        self.intervals: List[Tuple[float, float]] = []
        self._open: Dict[Any, float] = {}

    def on_submit(self, ref: Any) -> None:
        now = time.monotonic()
        self.submitted += 1
        if self.first_submit_ts is None:
            self.first_submit_ts = now
        self._open[ref] = now

    def on_complete(self, ref: Any, nbytes: int) -> None:
        now = time.monotonic()
        self.completed += 1
        self.bytes_out += nbytes
        self.last_complete_ts = now
        start = self._open.pop(ref, now)
        self.intervals.append((start, now))

    def summary(self) -> str:
        wall = ((self.last_complete_ts or 0) - (self.first_submit_ts or 0))
        out = (f"{self.name}: {self.completed} blocks, "
               f"{self.bytes_out / 1e6:.2f} MB, {wall:.3f}s busy")
        extras = []
        if self.retried:
            extras.append(f"{self.retried} retried")
        if self.prefetches:
            extras.append(f"{self.prefetches} prefetched")
        if self.throttled:
            extras.append(f"{self.throttled} throttled")
        if extras:
            out += " (" + ", ".join(extras) + ")"
        return out


class Stage:
    """One physical operator: turns an upstream block ref into a
    downstream block ref. `max_in_flight` is the per-op concurrency cap
    (reference ConcurrencyCapBackpressurePolicy)."""

    def __init__(self, name: str, max_in_flight: int = 16):
        self.name = name
        self.max_in_flight = max_in_flight
        self.stats = OpStats(name)

    def submit(self, ref: Any) -> Any:
        raise NotImplementedError

    def prefetch_target(self):
        """Data-server address of the node this stage's next task will
        run on, or None (no prefetch)."""
        return None

    def close(self) -> None:
        pass


class TaskStage(Stage):
    """Fused chain of per-block task ops (reference TaskPoolMapOperator;
    adjacent map/filter/flat_map fuse into ONE task — the physical-plan
    fusion rule). Tasks carry `lineage=True` so the head can re-run them
    when their output block is lost, and `data_stage=True` so those
    reconstructions count into data_blocks_reconstructed_total."""

    def __init__(self, ops: List[Any], max_in_flight: int = 16):
        names = ",".join(o.kind for o in ops) or "read"
        super().__init__(f"Map({names})", max_in_flight)
        import ray_tpu_torch
        from ray_tpu_torch.data.dataset import _exec_chain

        self._task = ray_tpu_torch.remote(_exec_chain).options(
            name=f"data:{names or 'read'}", lineage=True, data_stage=True)
        self._ops = ops
        self._pf_cache: Tuple[float, Any] = (0.0, None)

    def submit(self, ref: Any) -> Any:
        return self._task.remote(ref, self._ops)

    def prefetch_target(self):
        """The current lease's node for this task shape, resolved from
        cache and memoized briefly (leases are sticky; re-resolving per
        block would cost a lock + view scan each)."""
        now = time.monotonic()
        ts, addr = self._pf_cache
        if now - ts < 2.0:
            return addr
        addr = None
        try:
            from ray_tpu_torch.core.api import _build_resources, _global_client

            client = _global_client()
            fn_key = self._task._ensure_exported()
            addr = client.lease_data_addr(
                fn_key, {"resources": _build_resources(self._task._options)})
        except Exception:
            addr = None
        self._pf_cache = (now, addr)
        return addr


class ActorStage(Stage):
    """Callable-class UDF over a shared actor pool (reference
    ActorPoolMapOperator). In-flight cap = pool size by default: one
    outstanding call per actor keeps the pool busy without queue blowup.
    Round-robin is deterministic, so the prefetch target PEEKS the next
    assignment (`_rr` increments only at submit): input blocks start
    pulling toward the very node whose actor will consume them, like
    lease-path stages."""

    def __init__(self, op: Any):
        super().__init__(f"ActorMap(x{op.concurrency})",
                         max_in_flight=max(op.concurrency, 1))
        from ray_tpu_torch.data.dataset import _BlockActor

        self._op = op
        self.pool = [_BlockActor.remote(op.fn)
                     for _ in range(max(op.concurrency, 1))]
        self._rr = 0
        self._addr_cache: Dict[int, Any] = {}  # pool idx -> data addr

    def submit(self, ref: Any) -> Any:
        actor = self.pool[self._rr % len(self.pool)]
        self._rr += 1
        return actor.apply.remote(ref, self._op.batch_format)

    def prefetch_target(self):
        """Data-server address of the NEXT round-robin actor's node.
        Actors are pinned to their node for life, so resolution (one
        head RPC + a view lookup) is memoized per pool slot."""
        if not self.pool:
            return None
        i = self._rr % len(self.pool)
        if i in self._addr_cache:
            return self._addr_cache[i]
        addr = None
        try:
            from ray_tpu_torch.core.api import _global_client
            from ray_tpu_torch.core.ids import NodeID

            client = _global_client()
            reply = client.head_request(
                "get_actor_address",
                actor_id=self.pool[i]._actor_id.binary())
            node_id = reply.get("node_id")
            if reply.get("state") != "DEAD" and node_id:
                addr = client.cluster_view.data_addr_of(
                    NodeID(node_id).hex())
        except Exception:
            addr = None
        if addr is not None:  # don't cache failures: actor may be pending
            self._addr_cache[i] = addr
        return addr

    def close(self) -> None:
        import ray_tpu_torch

        pool, self.pool = self.pool, []   # idempotent
        for a in pool:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass


class StreamingExecutor:
    """Drives a Topology of stages over the input partitions.

    Scheduling loop (reference streaming_executor.py:61): each tick,
    admit queued blocks into every stage with spare in-flight capacity
    (downstream-first, so finished work drains before new work enters),
    then wait for ANY in-flight task across ALL stages and route its
    output to the next stage's queue. Input admission (stage 0) is
    additionally governed by the adaptive byte budget AND the gossiped
    store-pressure signal; inter-stage admission sheds when the
    downstream queue is congested."""

    def __init__(self, stages: List[Stage], partitions: List[Any],
                 input_window: Callable[[], int]):
        self.stages = stages
        self.partitions = partitions
        self.input_window = input_window
        # per-stage input queues of (partition_idx, ref)
        self.queues: List[deque] = [deque() for _ in stages]
        # in-flight output ref -> (partition_idx, input ref) — the input
        # is kept so a lost-input failure can resubmit the same task
        self.in_flight: List[Dict[Any, Tuple[int, Any]]] = [{} for _ in stages]
        self.results: Dict[int, Any] = {}
        # lineage recovery + eager release bookkeeping
        self._retries: Dict[Tuple[int, int], int] = {}
        self.input_retries = 0
        self.prefetches = 0
        self._chain: Dict[int, List[Any]] = {}   # idx -> intermediate refs
        self._released: List[Any] = []           # release batch buffer
        self._prefetch_on = _config.get("data_prefetch")
        self._eager_release = _config.get("data_eager_release")
        self._retry_cap = int(_config.get("data_input_retries"))
        self._highwater = float(_config.get("data_store_highwater"))

    # ------------------------------------------------------- admission
    def _store_hot(self) -> bool:
        """Gossiped store-pressure signal, read entirely from the cached
        cluster view (zero RPCs): True when ANY node's object store runs
        above the highwater fraction."""
        if self._highwater <= 0:
            return False
        try:
            from ray_tpu_torch.core.api import _global_client

            return (_global_client().cluster_view.max_store_frac()
                    >= self._highwater)
        except Exception:
            return False

    def _admit(self) -> None:
        store_hot = self._store_hot()
        for si in range(len(self.stages) - 1, -1, -1):
            stage, q, fl = self.stages[si], self.queues[si], self.in_flight[si]
            cap = stage.max_in_flight
            if si + 1 < len(self.stages):
                # a slow/degraded downstream stage sheds UPSTREAM
                # admission: feeding a stage whose input queue already
                # holds 2x its concurrency only grows store footprint
                nxt = self.stages[si + 1]
                if len(self.queues[si + 1]) >= 2 * nxt.max_in_flight:
                    cap = 0
            if si == 0:
                cap = min(cap, self.input_window())
                if store_hot:
                    # the cluster store is at the highwater: stop
                    # admitting NEW inputs (downstream stages keep
                    # draining, so pressure falls instead of OOMing)
                    cap = 0
            if q and cap <= 0:
                stage.stats.throttled += 1
                try:
                    _metrics()["backpressure"].inc(tags={
                        "op": stage.name,
                        "reason": "store" if (si == 0 and store_hot)
                        else "queue"})
                except Exception:
                    pass
            while q and len(fl) < cap:
                idx, ref = q.popleft()
                out = stage.submit(ref)
                stage.stats.on_submit(out)
                fl[out] = (idx, ref)
            _op_gauges(stage, len(fl), len(q))

    # -------------------------------------------------------- recovery
    def _lost_input(self, client, ref: Any) -> bool:
        """True when a completed stage task's result is an
        ObjectLostError — its INPUT died mid-flight (node loss), which
        is retryable once lineage rebuilds the input — as opposed to a
        user-code failure, which is not."""
        meta = client.local_metas.get(ref.id)
        if meta is None:
            # join the lease call's reply (populates local_metas); a
            # head-scheduled task has no pending call and falls through
            try:
                if client._resolve_pending_call(ref.id, timeout=5):
                    meta = client.local_metas.get(ref.id)
            except Exception:
                meta = client.local_metas.get(ref.id)
        if meta is None:
            # cold-path (head-scheduled) task: one bounded meta lookup —
            # error results are inline and never enter the gossiped
            # directory, so only the head can show the error bit. Lease
            # results carry their meta in the reply, so the warm path
            # never reaches here.
            try:
                meta = client.head_request(
                    "get_meta", object_id=ref.id.binary(), timeout=10)
            except Exception:
                return False
            if meta is not None:
                client.local_metas[ref.id] = meta
        if meta is None or not getattr(meta, "error", False):
            return False
        from ray_tpu_torch.core.exceptions import ObjectLostError

        try:
            client.get([ref])
        except ObjectLostError:
            return True
        except Exception:
            return False
        return False

    def _retry(self, si: int, idx: int, src: Any) -> bool:
        """Resubmit stage si's task for partition idx with the same
        input. The retried task's dependency fetch triggers lineage
        reconstruction of the lost block at the head (get_meta /
        locate_object park until the producer re-runs)."""
        key = (si, idx)
        count = self._retries.get(key, 0)
        if count >= self._retry_cap:
            return False
        self._retries[key] = count + 1
        self.input_retries += 1
        stage = self.stages[si]
        stage.stats.retried += 1
        try:
            _metrics()["retries"].inc(tags={"op": stage.name})
        except Exception:
            pass
        out = stage.submit(src)
        stage.stats.on_submit(out)
        self.in_flight[si][out] = (idx, src)
        return True

    # -------------------------------------------------------- prefetch
    def _prefetch(self, si: int, ref: Any, client) -> None:
        """Stage the block onto the consuming stage's node before its
        task dispatches (ROADMAP item 1 push-side prefetch follow-on,
        delivered on the data plane where it pays): the node PullManager
        dedups with the dispatch-time fetch if they race."""
        if not self._prefetch_on:
            return
        stage = self.stages[si]
        addr = stage.prefetch_target()
        if addr is None:
            return
        try:
            if client.prefetch_object(ref, addr):
                stage.stats.prefetches += 1
                self.prefetches += 1
                _metrics()["prefetch"].inc(tags={"op": stage.name})
        except Exception:
            pass

    # ---------------------------------------------------- eager release
    def release_partition(self, idx: int, final_ref: Any = None) -> None:
        """Called by the consumer once partition idx's final block has
        been fetched: the chain's intermediate (and final) blocks can
        never be needed again, so their lineage entries retire NOW —
        dropping the input dep pins that would otherwise hold every
        intermediate block until cap eviction."""
        refs = self._chain.pop(idx, [])
        if final_ref is not None:
            refs = refs + [final_ref]
        if not refs or not self._eager_release:
            return
        try:
            from ray_tpu_torch.core.api import _global_client

            _global_client().head_push(
                "release_lineage",
                return_ids=[r.id.binary() for r in refs])
        except Exception:
            pass

    # ------------------------------------------------------------- run
    def run(self) -> Iterator[Tuple[int, Any]]:
        """Yields (partition_idx, final block ref) as they complete —
        UNORDERED; the caller handles ordered emission."""
        import ray_tpu_torch
        from ray_tpu_torch.core.api import _global_client

        client = _global_client()
        next_input = 0
        n = len(self.partitions)
        emitted = 0
        try:
            while emitted < n:
                # feed stage-0 queue lazily (partition thunks are cheap
                # handles; real IO happens in the stage task)
                while (next_input < n
                       and len(self.queues[0]) + len(self.in_flight[0])
                       < self.input_window()):
                    self.queues[0].append(
                        (next_input, self.partitions[next_input]))
                    next_input += 1
                self._admit()
                all_refs = [r for fl in self.in_flight for r in fl]
                if not all_refs:
                    if next_input >= n and not any(self.queues):
                        break
                    # queued work shed by backpressure with nothing in
                    # flight: yield the CPU until the signal clears
                    time.sleep(0.02)
                    continue
                ready, _ = ray_tpu_torch.wait(all_refs, num_returns=1,
                                              timeout=300)
                for ref in ready:
                    for si, fl in enumerate(self.in_flight):
                        if ref not in fl:
                            continue
                        idx, src = fl.pop(ref)
                        if (self._lost_input(client, ref)
                                and self._retry(si, idx, src)):
                            break
                        # size probe rides the ref; fetching the block
                        # is deferred to the consumer
                        self.stages[si].stats.on_complete(ref, 0)
                        if si + 1 < len(self.stages):
                            self._chain.setdefault(idx, []).append(ref)
                            self.queues[si + 1].append((idx, ref))
                            self._prefetch(si + 1, ref, client)
                        else:
                            emitted += 1
                            yield idx, ref
                        break
        finally:
            self.close()

    def close(self) -> None:
        for s in self.stages:
            s.close()
        self._chain.clear()

    def per_op_stats(self) -> List[OpStats]:
        return [s.stats for s in self.stages]
