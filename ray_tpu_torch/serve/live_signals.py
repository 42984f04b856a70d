"""Live-signal routing + SLO admission control over gossiped replica load
(counterpart of `ray_tpu/serve/live_signals.py`).

The workload flight recorder already gossips every serve replica's
queue depth / in-flight / EWMA latency to the head (zero new RPCs:
`ray_tpu_torch.util.metrics.publish_workload` rides the metrics-push channel,
merged into `state.list_serve_stats()`). This module is the consumer
side of that plane:

- `LiveLoadCache` — a per-process, TTL-refreshed view of the merged
  rows, shared by the HTTP proxy, the gRPC proxy, `DeploymentHandle`,
  and the serve controller's autoscaler.
- `replica_score` — the effective queue depth a router compares in its
  pow-2 choice: the gossiped queue when fresh (each router only sees its
  OWN in-flight; the gossiped row sees the replica's true admitted
  load), blended with the local count so a burst this router just sent
  is never invisible.
- `SLOConfig` + `admission_decision` — SLO-aware bounded queues at the
  ingress: shed (HTTP 429 / gRPC RESOURCE_EXHAUSTED, with Retry-After)
  when every replica's queue is at the bound or when the EWMA-projected
  wait of the BEST replica already exceeds the route's SLO.

The policy functions are pure (load rows in, decision out) so they are
unit-testable without a cluster.
"""

from __future__ import annotations

import asyncio
import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Tuple


def _flag(name: str, default: float) -> float:
    try:
        from ray_tpu_torch.core import config as _config

        return float(_config.get(name))
    except Exception:
        return default


@dataclasses.dataclass
class SLOConfig:
    """Per-deployment admission policy (rides the routing table to every
    ingress). `slo_s`: shed when the best replica's EWMA-projected wait
    exceeds this (0 disables). `max_queue`: shed when every replica's
    effective queue depth reaches this bound (0 = unbounded).
    `retry_after_s`: floor for the Retry-After hint on sheds."""

    slo_s: float = 0.0
    max_queue: int = 0
    retry_after_s: float = 1.0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def as_slo(value) -> Optional[SLOConfig]:
    if value is None:
        return None
    if isinstance(value, SLOConfig):
        return value
    if isinstance(value, dict):
        return SLOConfig(**value)
    raise TypeError(f"slo_config must be SLOConfig or dict, got {value!r}")


class LiveLoadCache:
    """TTL-cached view of the gossiped serve-replica load rows, keyed
    deployment -> replica tag. Refresh failures are swallowed (routers
    must keep routing on local counts through a head outage)."""

    def __init__(self, refresh_s: Optional[float] = None):
        self._refresh_s = refresh_s
        self._rows: Dict[str, Dict[str, dict]] = {}
        self._ts = 0.0
        self._lock = threading.Lock()

    def _period(self) -> float:
        if self._refresh_s is not None:
            return self._refresh_s
        return _flag("serve_live_signal_refresh_s", 1.0)

    def refresh(self, force: bool = False) -> None:
        period = self._period()
        if period <= 0:
            return                    # live-signal consumption disabled
        now = time.monotonic()
        with self._lock:
            if not force and now - self._ts < period:
                return
            self._ts = now            # claim the slot even on failure
        rows = self._gossiped_rows()
        if rows is None:
            # no broadcast-fed view in this process (remote driver, serve
            # plane not yet announced): fall back to one state-API pull —
            # but only inside an already-initialized runtime. The state
            # client AUTO-INITS a default single-node runtime otherwise,
            # and a router consulted pre-init (unit tests, standalone
            # tooling) must not leave that runtime behind to starve the
            # cluster a later ray_tpu_torch.init() actually wants.
            try:
                from ray_tpu_torch.core import api as core_api

                if not core_api.is_initialized():
                    return
                from ray_tpu_torch.util import state

                rows = state.list_serve_stats(
                    filters=[("kind", "=", "serve_replica")])
            except Exception:
                return
        merged: Dict[str, Dict[str, dict]] = {}
        for r in rows:
            st = r.get("stats") or {}
            dep = st.get("deployment")
            if not dep:
                continue
            merged.setdefault(dep, {})[r.get("key")] = {
                **st, "ts": r.get("ts", 0.0)}
        with self._lock:
            self._rows = merged

    @staticmethod
    def _gossiped_rows() -> Optional[list]:
        """Serve-load rows adopted from the cluster_view broadcast: the
        zero-RPC primary source (the head piggybacks changed rows on the
        snapshots every subscribed process already receives). None when
        this process has never adopted a row batch."""
        try:
            from ray_tpu_torch.core import api as core_api

            if not core_api.is_initialized():
                return None
            return core_api._global_client().cluster_view.serve_loads
        except Exception:
            return None

    async def refresh_async(self, force: bool = False) -> None:
        """Event-loop-safe refresh: the state call is a blocking head
        round trip, so it runs on the default executor."""
        period = self._period()
        if period <= 0:
            return
        if not force and time.monotonic() - self._ts < period:
            return
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, lambda: self.refresh(force))

    def snapshot(self) -> Dict[str, Dict[str, dict]]:
        with self._lock:
            return {dep: dict(rows) for dep, rows in self._rows.items()}

    def rows_for(self, deployment: str) -> Dict[str, dict]:
        with self._lock:
            return dict(self._rows.get(deployment, {}))

    def row(self, deployment: str, tag: str) -> Optional[dict]:
        with self._lock:
            return self._rows.get(deployment, {}).get(tag)


_cache: Optional[LiveLoadCache] = None
_cache_lock = threading.Lock()


def get_cache() -> LiveLoadCache:
    """Process-wide cache: the proxy's routers, handles, and the
    controller share one refresh cadence per process."""
    global _cache
    with _cache_lock:
        if _cache is None:
            _cache = LiveLoadCache()
        return _cache


# ------------------------------------------------------------ pure policy
def replica_score(local_inflight: int, row: Optional[dict], now: float,
                  max_age_s: float) -> float:
    """Effective queue depth for routing/admission: the gossiped row when
    fresh (it sees ALL routers' traffic), never below the local count
    (this router's just-sent burst hasn't been gossiped yet)."""
    if row and now - (row.get("ts") or 0.0) <= max_age_s:
        return max(float(local_inflight), float(row.get("queue_depth") or 0))
    return float(local_inflight)


def ewma_of(row: Optional[dict]) -> float:
    """EWMA service latency of a replica row; unlike queue depth it does
    not decay with row age (an idle replica's last measured service time
    is still the best estimate)."""
    return float((row or {}).get("ewma_latency_s") or 0.0)


def prefix_match_len(row: Optional[dict], chain_hexes, now: float,
                     max_age_s: float) -> int:
    """Longest-matching-prefix depth a replica's gossiped load row
    advertises for a prompt: `chain_hexes` is the prompt's rolling chain
    hashes in prefix order (hex), the row's `prefix_roots` the replica's
    resident set. Stale rows (including those of departed replicas whose
    last row still lingers in the cache) advertise NOTHING — a dead
    replica's residency must never attract traffic."""
    if not chain_hexes or not row:
        return 0
    if now - (row.get("ts") or 0.0) > max_age_s:
        return 0
    roots = row.get("prefix_roots")
    if not roots:
        return 0
    roots = set(roots)
    best = 0
    for i, h in enumerate(chain_hexes):
        if h in roots:
            best = i + 1
    return best


def pick_prefix_affinity(tags, chain_hexes, row_of, score_of, now: float,
                         max_age_s: float,
                         max_imbalance: float = 8.0) -> Optional[object]:
    """Prefix-affinity replica pick: the tag whose fresh row advertises
    the deepest resident match for the prompt (queue score breaks ties —
    among equally-warm replicas the shorter queue wins). A warm replica
    whose queue runs `max_imbalance` past the least-loaded candidate is
    excluded — the sole replica holding a popular prefix must not absorb
    the whole workload while peers idle; past that point recomputing the
    prefix on an idle replica is cheaper than waiting. None when no
    (eligible) replica advertises any match, so the caller falls back to
    pow-2 on load alone."""
    scores = {t: score_of(t) for t in tags}
    if not scores:
        return None
    min_score = min(scores.values())
    best_tag, best_key = None, None
    for t in tags:
        if scores[t] - min_score > max_imbalance:
            continue   # overloaded vs an idle peer: not a candidate
        depth = prefix_match_len(row_of(t), chain_hexes, now, max_age_s)
        if depth <= 0:
            continue
        key = (-depth, scores[t])
        if best_key is None or key < best_key:
            best_tag, best_key = t, key
    return best_tag


def pick_pow2(tags, score_of, ewma_of_tag) -> object:
    """Power-of-two-choices over live scores with an EWMA-latency
    tiebreak — the shared core of the proxy router's and
    DeploymentHandle's replica pick. `score_of`/`ewma_of_tag` map a tag
    to its effective queue depth / service EWMA."""
    if len(tags) == 1:
        return tags[0]
    a, b = random.sample(list(tags), 2)
    sa, sb = score_of(a), score_of(b)
    if sa == sb:
        return a if ewma_of_tag(a) <= ewma_of_tag(b) else b
    return a if sa < sb else b


def admission_decision(slo, replicas: List[Tuple[int, Optional[dict]]],
                       now: Optional[float] = None,
                       max_age_s: Optional[float] = None) -> Optional[dict]:
    """Admit (None) or shed ({"reason", "retry_after_s",
    "projected_wait_s"}) one ingress request.

    `replicas`: [(local_inflight, gossiped_row_or_None)] for the route's
    current replica set. Sheds when every replica's effective queue is at
    `max_queue`, or when even the best replica's EWMA-projected wait
    (service EWMA x queued-ahead+1) exceeds `slo_s`.
    """
    slo = as_slo(slo)
    if slo is None or not replicas or (slo.slo_s <= 0 and slo.max_queue <= 0):
        return None
    now = time.time() if now is None else now
    if max_age_s is None:
        max_age_s = _flag("serve_live_signal_max_age_s", 5.0)
    scored = [(replica_score(local, row, now, max_age_s), row)
              for local, row in replicas]
    best_queue = min(q for q, _ in scored)
    if slo.max_queue > 0 and best_queue >= slo.max_queue:
        return {"reason": "queue_full",
                "retry_after_s": slo.retry_after_s,
                "projected_wait_s": None}
    if slo.slo_s > 0:
        projections = [ewma_of(row) * (q + 1.0) for q, row in scored]
        best = min(projections)
        if best > slo.slo_s:
            return {"reason": "slo",
                    "retry_after_s": max(slo.retry_after_s,
                                         round(best - slo.slo_s, 2)),
                    "projected_wait_s": round(best, 4)}
    return None
