"""State API implementation.

Each `list_*` supports the reference's filter grammar subset:
`filters=[("key", "=", value), ("key", "!=", value)]` plus `limit`
(`python/ray/util/state/api.py` list_tasks/list_actors/... semantics).
"""

from __future__ import annotations

from collections import Counter
from typing import Any, List, Optional, Sequence, Tuple


def _client():
    from ray_tpu_torch.core.api import _auto_init, _global_client

    _auto_init()
    return _global_client()


def _apply_filters(rows: List[dict],
                   filters: Optional[Sequence[Tuple[str, str, Any]]],
                   limit: Optional[int]) -> List[dict]:
    if filters:
        for key, op, val in filters:
            if op == "=":
                rows = [r for r in rows if r.get(key) == val]
            elif op == "!=":
                rows = [r for r in rows if r.get(key) != val]
            else:
                raise ValueError(f"unsupported filter op {op!r} (use '=' or '!=')")
    return rows[:limit] if limit else rows


def _list(kind: str, filters=None, limit: Optional[int] = None) -> List[dict]:
    rows = _client().head_request("list_state", kind=kind)
    return _apply_filters(rows, filters, limit)


def list_tasks(filters=None, limit=None) -> List[dict]:
    """Queued (not-yet-dispatched) tasks; completed ones are in
    `list_task_events`."""
    return _list("tasks", filters, limit)


def list_task_events(filters=None, limit=None) -> List[dict]:
    """Task lifecycle transitions (PENDING_* / RUNNING / FINISHED / FAILED)."""
    return _list("task_events", filters, limit)


def list_actors(filters=None, limit=None) -> List[dict]:
    return _list("actors", filters, limit)


def list_workers(filters=None, limit=None) -> List[dict]:
    return _list("workers", filters, limit)


def list_objects(filters=None, limit=None) -> List[dict]:
    return _list("objects", filters, limit)


def list_nodes(filters=None, limit=None) -> List[dict]:
    return _list("nodes", filters, limit)


def list_placement_groups(filters=None, limit=None) -> List[dict]:
    return _list("placement_groups", filters, limit)


def list_lease_events(filters=None, limit=None) -> List[dict]:
    """Flight-recorder lease-lifecycle events merged at the head: each
    node daemon's local grants/spillbacks/pool churn (piggybacked on the
    resource-view gossip, ack-tracked so a dying connection cannot drop a
    drained batch) plus head-granted leases, node deaths, and the
    partition-tolerance protocol (reconciliation handshakes, stale-epoch
    rejections, head reconnects). Row keys: kind (local_grant | spillback
    | pool_acquire | lease_return | pool_release | pool_worker_died |
    view_adopt | head_grant | node_dead | node_reregister |
    pool_reconcile | stale_epoch | head_lost | head_reconnect |
    chaos_config), node_id, ts, and per-kind detail."""
    return _list("lease_events", filters, limit)


def list_scheduler_stats(filters=None, limit=None) -> List[dict]:
    """Per-node two-level-scheduler telemetry: lifetime local-grant /
    spillback counters, warm-pool size (idle_workers / leased_workers as
    gossiped by the daemon vs pooled_workers as carved in the head
    ledger — equal after reconciliation), the reconciliation state
    (reconciled / pending_pool), gossip health (view version, view age)
    and head-observed delta staleness — one row per node daemon plus one
    `is_head` row with the head's grant totals, cluster epoch, and
    stale-epoch reject / reconcile counters."""
    return _list("scheduler_stats", filters, limit)


def list_serve_stats(filters=None, limit=None) -> List[dict]:
    """Live serve load merged at the head from telemetry piggybacked on
    the existing metrics-push/gossip channel (zero new RPCs): one row per
    replica (kind=serve_replica: queue_depth, inflight, ewma_latency_s,
    total) plus any serve-scoped rows other publishers add. Row keys:
    kind, key, stats, ts, proc."""
    return _list("serve_stats", filters, limit)


def list_workload_stats(filters=None, limit=None) -> List[dict]:
    """Every workload telemetry row the head has merged — serve replicas
    AND train workers (kind=train_worker: step, last_step_s,
    ewma_step_s, steps_per_s per rank). Superset of
    `list_serve_stats`."""
    return _list("workload_stats", filters, limit)


def list_trace_spans(filters=None, limit=None) -> List[dict]:
    """Finished spans pushed by every process (workload flight
    recorder), tagged with proc/node — `ray_tpu_torch.timeline(
    format="chrome")` merges them into one cross-process trace. Row
    keys: name, trace_id, span_id, parent_id, start_ts, end_ts,
    attributes, proc, node."""
    return _list("trace_spans", filters, limit)


def get_actor(actor_id: str) -> Optional[dict]:
    rows = list_actors(filters=[("actor_id", "=", actor_id)])
    return rows[0] if rows else None


def get_placement_group(pg_id: str) -> Optional[dict]:
    rows = list_placement_groups(filters=[("pg_id", "=", pg_id)])
    return rows[0] if rows else None


# ------------------------------------------------------------------ summary
# pure row-level helpers shared with the dashboard's /api/summary
def summarize_task_rows(events: List[dict]) -> dict:
    """Latest state per task id, counted (reference `ray summary tasks`)."""
    latest: dict = {}
    for ev in events:
        latest[ev["task_id"]] = ev["state"]
    return {"total": len(latest), "by_state": dict(Counter(latest.values()))}


def summarize_actor_rows(rows: List[dict]) -> dict:
    counts = Counter(a["state"] for a in rows)
    return {"total": sum(counts.values()), "by_state": dict(counts)}


def summarize_object_rows(rows: List[dict]) -> dict:
    return {"total": len(rows),
            "total_size_bytes": sum(r.get("size") or 0 for r in rows),
            "by_kind": dict(Counter(r["kind"] for r in rows))}


def summarize_tasks() -> dict:
    return summarize_task_rows(_list("task_events"))


def summarize_actors() -> dict:
    return summarize_actor_rows(_list("actors"))


def summarize_objects() -> dict:
    return summarize_object_rows(_list("objects"))


def subscribe(channel: str):
    """Subscribe to a head pubsub channel; returns a queue.Queue of event
    dicts (reference pubsub channels: node/actor/object state). Usage:

        q = state.subscribe("object_state")
        evt = q.get(timeout=5)   # {"object_id": ..., "state": "SEALED"}
    """
    import queue as _q

    from ray_tpu_torch.core.api import _global_client

    out: "_q.Queue" = _q.Queue()
    _global_client().subscribe_channel(channel, out.put)
    return out
