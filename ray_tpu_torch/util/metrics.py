"""Metrics API: Counter / Gauge / Histogram with Prometheus export.

Parity: `ray.util.metrics` (`python/ray/util/metrics.py` → Cython
`includes/metric.pxi` → per-node agent → Prometheus). Here every process
keeps a local registry and a background thread pushes snapshots into the
head's KV (`_metrics` namespace, one key per process); the dashboard's
`/metrics` endpoint aggregates all snapshots into Prometheus text
exposition format.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_REGISTRY: Dict[Tuple[str, Tuple[Tuple[str, str], ...]], "Metric"] = {}
_LOCK = threading.Lock()
def _PUSH_INTERVAL_S() -> float:
    from ray_tpu_torch.core import config as _config

    return _config.get("metrics_push_interval_s")
_pusher: Optional[threading.Thread] = None
_pusher_stop = threading.Event()
_pusher_enabled = True

# sub-millisecond leading buckets: warm-path RPCs and span latencies sit
# well under 1 ms on localhost — without them every warm observation
# landed in one bucket and p50/p99 were indistinguishable
DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.0001, 0.00025, 0.0005,
    0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 50.0, 100.0]

# process-local live-load telemetry (serve replicas: queue depth /
# in-flight / EWMA latency; train workers: step time / throughput).
# Rides the SAME channel as metric snapshots — the pusher for processes
# with a CoreClient, resource_view_delta gossip for node daemons — so
# live load reaches the head with zero new RPC channels.
_WORKLOADS: Dict[Tuple[str, str], dict] = {}


class Metric:
    """Base: a named metric with fixed tag keys; `.set_default_tags` then
    record with per-call tag values (reference API shape)."""

    kind = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        if not name or not name.replace("_", "a").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        # (sorted tag-value tuple) -> value
        self._series: Dict[Tuple[Tuple[str, str], ...], float] = {}
        with _LOCK:
            _REGISTRY[(name, self.tag_keys)] = self
        _ensure_pusher()

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]):
        merged = {**self._default_tags, **(tags or {})}
        unknown = set(merged) - set(self.tag_keys)
        if unknown:
            raise ValueError(f"unknown tag(s) {unknown} for metric {self.name}")
        return tuple(sorted(merged.items()))

    def _snapshot(self) -> List[dict]:
        with _LOCK:
            return [{"tags": dict(k), "value": v}
                    for k, v in self._series.items()]


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        k = self._key(tags)
        with _LOCK:
            self._series[k] = self._series.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with _LOCK:
            self._series[self._key(tags)] = float(value)


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        # series value: {"buckets": [...], "sum": s, "count": n}
        self._hseries: Dict[Tuple, dict] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        k = self._key(tags)
        with _LOCK:
            h = self._hseries.setdefault(
                k, {"buckets": [0] * (len(self.boundaries) + 1),
                    "sum": 0.0, "count": 0})
            i = 0
            while i < len(self.boundaries) and value > self.boundaries[i]:
                i += 1
            h["buckets"][i] += 1
            h["sum"] += value
            h["count"] += 1

    def _snapshot(self) -> List[dict]:
        with _LOCK:
            return [{"tags": dict(k), "histogram": dict(v),
                     "boundaries": list(self.boundaries)}
                    for k, v in self._hseries.items()]


# ------------------------------------------------------ workload telemetry
def publish_workload(kind: str, key: str, stats: Dict[str, object]) -> None:
    """Publish one workload's live-load dict (e.g. kind="serve_replica",
    key=replica_tag). Overwrites the previous value — this is a gauge-like
    snapshot, not an event stream; the head merges the latest copy into
    `state.list_serve_stats()` / `GET /api/workloads`."""
    with _LOCK:
        _WORKLOADS[(kind, key)] = {"kind": kind, "key": key,
                                   "stats": dict(stats), "ts": time.time()}


def workload_snapshot() -> List[dict]:
    with _LOCK:
        return [dict(v) for v in _WORKLOADS.values()]


# ------------------------------------------------------------------ export
def snapshot_all() -> List[dict]:
    with _LOCK:
        metrics = list(_REGISTRY.values())
    return [{"name": m.name, "kind": m.kind, "description": m.description,
             "series": m._snapshot()} for m in metrics]


def push_payload(spans: Optional[List[dict]] = None) -> List[dict]:
    """Full telemetry payload for one push/gossip tick: the metric
    registry snapshot plus two reserved families (names starting "__",
    skipped by the Prometheus renderer) — live workload stats and the
    finished-span batch for the head's cross-process trace buffer.

    Callers that can detect a failed send should drain spans themselves
    and pass them in, so they can `tracing.requeue_push_spans` on
    failure instead of silently losing the batch."""
    payload = snapshot_all()
    wl = workload_snapshot()
    if wl:
        payload.append({"name": "__workloads__", "kind": "workload",
                        "description": "", "series": wl})
    if spans is None:
        from ray_tpu_torch.util import tracing

        spans = tracing.drain_push_spans()
    if spans:
        payload.append({"name": "__spans__", "kind": "spans",
                        "description": "", "series": spans})
    return payload


def _push_once(wait: bool = False) -> bool:
    from ray_tpu_torch.core import api as core_api

    if not core_api.is_initialized():
        return False
    client = core_api._global_client()
    try:
        # a push, not a round trip: snapshots are telemetry and must never
        # add head RPCs to otherwise head-free paths (the warm-path
        # zero-head-RPC contract counts requests, not pushes). The head
        # stores it under the _metrics KV namespace keyed by this
        # process's worker id and expires it on disconnect. Fire-and-forget
        # loses the old round trip's failure signal, so surface the one
        # observable failure mode — a dead head connection — explicitly.
        conn = getattr(client, "conn", None)
        if conn is None or conn.closed:
            return False
    except Exception:
        return False
    from ray_tpu_torch.util import tracing

    spans = tracing.drain_push_spans()
    try:
        value = json.dumps(push_payload(spans)).encode()
        if wait:
            # final flush before the connection closes: a push written
            # just before close can die to a TCP RST (an unread inbound
            # broadcast in our receive buffer at close() turns the FIN
            # into RST, and the head discards undelivered frames) — one
            # shutdown-time round trip guarantees the head PROCESSED the
            # last snapshot/spans before we hang up. Bounded: a head
            # that is ALREADY gone must not stall shutdown behind the
            # reconnect window.
            import asyncio as _asyncio

            fut = _asyncio.run_coroutine_threadsafe(
                conn.request("metrics_push", value=value), client.loop)
            try:
                fut.result(timeout=5)
            except BaseException:
                fut.cancel()
                raise
        else:
            client.head_push("metrics_push", value=value)
        return True
    except Exception:
        # transient head outage: the batch rides the next push instead
        # of silently holing the cross-process timeline
        tracing.requeue_push_spans(spans)
        return False


def disable_pusher() -> None:
    """Processes with no CoreClient (head, node daemons) never have
    anything the pusher could deliver — let them opt out so Metric
    creation doesn't spawn a thread that wakes forever for nothing.
    Daemon registries reach the head by riding gossip instead."""
    global _pusher_enabled
    _pusher_enabled = False


def _ensure_pusher() -> None:
    global _pusher, _pusher_stop
    with _LOCK:
        if _pusher is not None or not _pusher_enabled:
            return
        # per-generation stop event, captured by the thread's closure: a
        # stale thread that outlives its join timeout keeps watching ITS
        # OWN (set) event and exits, regardless of later generations
        stop = _pusher_stop = threading.Event()

        def loop():
            while not stop.wait(_PUSH_INTERVAL_S()):
                _push_once()

        _pusher = threading.Thread(target=loop, daemon=True,
                                   name="metrics-pusher")
        _pusher.start()


def stop_pusher() -> None:
    """Stop the background pusher thread (called by `ray_tpu.shutdown()`);
    the next Metric creation restarts it."""
    global _pusher
    with _LOCK:
        thread, _pusher = _pusher, None
        _pusher_stop.set()
    if thread is not None:
        thread.join(timeout=2)


def flush(wait: bool = False) -> bool:
    """Push this process's metrics to the head immediately. `wait=True`
    turns it into a round trip (used once at shutdown so the final
    snapshot provably lands before the connection closes)."""
    return _push_once(wait=wait)


# -------------------------------------------------- Prometheus text format
def _esc_label(v: str) -> str:
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_tags(tags: Dict[str, str], extra: Optional[Dict[str, str]] = None) -> str:
    merged = {**tags, **(extra or {})}
    if not merged:
        return ""
    inner = ",".join(f'{k}="{_esc_label(v)}"' for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def render_prometheus(snapshots: Dict[str, List[dict]]) -> str:
    """snapshots: {process_key: snapshot_all() output} → exposition text.

    Prometheus exposition requires every sample of a metric family to sit
    under a single `# TYPE` block, so samples are grouped by metric name
    across processes first (per-process iteration would interleave
    families and make strict parsers drop samples)."""
    # name -> {"kind", "description", "samples": [(proc, series_dict)]}
    families: Dict[str, dict] = {}
    for proc, metrics in sorted(snapshots.items()):
        for m in metrics:
            if m["name"].startswith("__"):
                continue  # reserved piggyback families (workloads, spans)
            fam = families.setdefault(
                m["name"], {"kind": m["kind"],
                            "description": m["description"], "samples": []})
            for s in m["series"]:
                fam["samples"].append((proc, s))
    out: List[str] = []
    for mname in sorted(families):
        fam = families[mname]
        name = f"ray_tpu_{mname}"
        desc = str(fam["description"]).replace("\\", "\\\\").replace(
            "\n", "\\n")
        out.append(f"# HELP {name} {desc}")
        out.append(f"# TYPE {name} {fam['kind']}")
        for proc, s in fam["samples"]:
            tags = {**s["tags"], "proc": proc}
            if "histogram" in s:
                h, bounds = s["histogram"], s["boundaries"]
                acc = 0
                for b, c in zip(bounds + [float("inf")], h["buckets"]):
                    acc += c
                    le = "+Inf" if b == float("inf") else repr(b)
                    out.append(f"{name}_bucket"
                               f"{_fmt_tags(tags, {'le': le})} {acc}")
                out.append(f"{name}_sum{_fmt_tags(tags)} {h['sum']}")
                out.append(f"{name}_count{_fmt_tags(tags)} {h['count']}")
            else:
                out.append(f"{name}{_fmt_tags(tags)} {s['value']}")
    return "\n".join(out) + "\n"
