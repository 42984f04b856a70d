"""Head-side anomaly watchdogs over the merged workload telemetry.

A periodic pass on the head (zero extra RPCs — it reads what the gossip
plane and the metrics pusher already delivered) flags:

- **slow_pull** — object pulls whose duration landed above
  ``workload_slow_pull_s`` (delta-counted from the merged
  ``object_pull_seconds`` histograms, so each slow pull is flagged once);
- **train_straggler** — a gang member whose EWMA step time exceeds
  ``workload_straggler_factor`` x its gang's median (per-run grouping of
  the gossiped train-worker rows);
- **slo_route** — a serve route whose estimated p99 latency (from the
  merged ``serve_request_seconds`` buckets) exceeds ``serve_p99_slo_s``;
- **serve_shedding** — a route whose admission control kept shedding
  (``serve_shed_total`` deltas positive across consecutive passes): one
  shedding pass is a burst absorber doing its job; sustained shedding is
  capacity starvation the autoscaler/operator should see;
- **hotpath_regression** — drift on the compiled planes' golden signals
  (``hotpath_drift`` > 0): a ring whose stall ratio (stall seconds per
  wall second, writer+reader, delta-judged between passes) or a compiled
  chain whose gossiped p99 lands ``hotpath_drift``x above its own
  rolling EWMA baseline, plus a per-rank fused-step phase straggler
  (one rank's timed ``train_phase`` step far above the gang median, the
  slowest-vs-median phase named for attribution). Baselines freeze
  while a key is regressed so a sustained regression cannot launder
  itself into the baseline.

Anomalies land in the flight-recorder event stream
(``kind="workload_anomaly"``, visible in ``state.list_lease_events()``
and ``GET /api/workloads``) and bump
``workload_anomalies_total{kind}`` — the live-signal substrate
cluster-view-aware routing and spillback debugging route on.

`scan` is pure (telemetry in, anomalies + carried state out) so the
policies are unit-testable without a cluster.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

# a repeating condition (stuck straggler, persistently slow route) is
# re-flagged at most this often — the event stream stays readable
REFLAG_INTERVAL_S = 30.0
# workload rows older than this are a dead process's last breath, not
# live load — never judged
FRESH_S = 30.0


# a route's p99 is judged over the observations since the PREVIOUS pass
# (cumulative-since-process-start buckets would keep a recovered route
# flagging forever); windows with too few samples are skipped
MIN_WINDOW_SAMPLES = 20

# admission-control shedding must persist for this many consecutive
# passes before it's flagged (a single-pass shed burst is the bounded
# queue absorbing a spike, not an anomaly)
SHED_SUSTAIN_PASSES = 2


def _count_above(series: dict, threshold: float) -> int:
    """Observations provably above `threshold`: sum of buckets whose
    LOWER edge is >= threshold (conservative — a bucket straddling the
    threshold is not counted; the overflow bucket's lower edge is the
    last boundary)."""
    hist = series.get("histogram")
    bounds = series.get("boundaries")
    if not hist or not bounds:
        return 0
    above = 0
    for i, c in enumerate(hist["buckets"]):
        lower = bounds[i - 1] if i > 0 else 0.0
        if lower >= threshold:
            above += c
    return above


def _merge_buckets(series_list: List[dict]) -> Dict[object, int]:
    """Merge histogram series into {boundary: count, "count": total};
    overflow observations land under the "count" total only (their
    boundary is unbounded)."""
    merged: Dict[object, int] = {"count": 0}
    for s in series_list:
        hist = s.get("histogram")
        bounds = s.get("boundaries")
        if not hist or not bounds:
            continue
        for i, c in enumerate(hist["buckets"]):
            if i < len(bounds):
                merged[bounds[i]] = merged.get(bounds[i], 0) + c
        merged["count"] += hist["count"]
    return merged


def _p99_from_buckets(buckets: Dict[object, int]) -> Optional[float]:
    """Upper-bound p99: the boundary at which cumulative count reaches
    99% of the total (total includes overflow, so an overflow-heavy
    window reports the largest boundary — a floor, "worse than this")."""
    total = buckets.get("count", 0)
    bounds = sorted(b for b in buckets if b != "count")
    if total <= 0 or not bounds:
        return None
    target = 0.99 * total
    acc = 0
    for b in bounds:
        acc += buckets[b]
        if acc >= target:
            return b
    return bounds[-1]


def estimate_p99(series_list: List[dict]) -> Optional[float]:
    """Upper-bound p99 from merged histogram buckets."""
    return _p99_from_buckets(_merge_buckets(series_list))


def scan(workload_rows: List[dict],
         families: Dict[str, List[Tuple[str, dict]]],
         now: float, *, slow_pull_s: float, straggler_factor: float,
         p99_slo_s: float, hotpath_drift: float = 0.0,
         state: Optional[dict] = None
         ) -> Tuple[List[dict], dict]:
    """One watchdog pass.

    `workload_rows`: merged `__workloads__` rows ({kind, key, stats, ts,
    proc}); `families`: {metric_name: [(proc, series_dict), ...]} from
    the merged metric snapshots; `state`: the previous pass's carry
    (slow-pull high-water counts, re-flag timestamps).
    """
    state = dict(state or {})
    # a fresh state (new head, incl. post-restart) baselines the
    # cumulative counters silently on its first pass: worker histograms
    # survive the head, its high-water carry does not — flagging the
    # whole history as "new" would bury the post-recovery event stream
    primed = bool(state.get("primed"))
    state["primed"] = True
    seen: Dict = dict(state.get("slow_pull_seen") or {})
    last_flag: Dict = dict(state.get("last_flag") or {})
    anomalies: List[dict] = []

    def flag(key, anomaly: dict) -> None:
        if now - last_flag.get(key, 0.0) < REFLAG_INTERVAL_S:
            return
        last_flag[key] = now
        anomalies.append(anomaly)

    # ---- slow pulls (delta-counted per series, no re-flag needed)
    for proc, s in families.get("object_pull_seconds", ()):
        above = _count_above(s, slow_pull_s)
        skey = (proc, tuple(sorted((s.get("tags") or {}).items())))
        prev = seen.get(skey, 0)
        if above > prev and primed:
            anomalies.append({
                "anomaly": "slow_pull", "proc": proc,
                "role": (s.get("tags") or {}).get("role"),
                "count": above - prev, "threshold_s": slow_pull_s})
        if above:
            seen[skey] = above

    # ---- train-step stragglers (per-gang outliers)
    gangs: Dict[str, List[dict]] = {}
    for row in workload_rows:
        if row.get("kind") != "train_worker":
            continue
        if now - row.get("ts", 0) > FRESH_S:
            continue
        stats = row.get("stats") or {}
        gangs.setdefault(str(stats.get("run", "train")), []).append(stats)
    for run, members in gangs.items():
        steps = [m.get("ewma_step_s") for m in members
                 if m.get("ewma_step_s")]
        if len(steps) < 2:
            continue
        # median_low: in an even-sized gang the interpolated median is
        # dragged toward the straggler itself (a 2-worker gang could
        # never flag); the low median compares against the healthy half
        med = statistics.median_low(steps)
        if med <= 0:
            continue
        for m in members:
            ewma = m.get("ewma_step_s") or 0.0
            if ewma > straggler_factor * med:
                flag(("straggler", run, m.get("rank")), {
                    "anomaly": "train_straggler", "run": run,
                    "rank": m.get("rank"), "ewma_step_s": round(ewma, 4),
                    "gang_median_s": round(med, 4)})

    # ---- p99-over-SLO routes, judged over THIS pass's window (bucket
    # deltas vs the previous pass — cumulative counts would keep a
    # long-recovered route flagging forever)
    prev_routes: Dict = dict(state.get("route_hist") or {})
    new_routes: Dict = {}
    if p99_slo_s > 0:
        by_route: Dict[str, List[dict]] = {}
        for _proc, s in families.get("serve_request_seconds", ()):
            route = (s.get("tags") or {}).get("route", "?")
            by_route.setdefault(route, []).append(s)
        for route, series in by_route.items():
            merged = _merge_buckets(series)
            new_routes[route] = merged
            prev = prev_routes.get(route)
            if prev is None:
                continue  # baseline pass for a newly seen route
            # clamp negatives: a replica restart resets its counters
            window = {b: max(c - prev.get(b, 0), 0)
                      for b, c in merged.items()}
            if window.get("count", 0) < MIN_WINDOW_SAMPLES:
                continue
            p99 = _p99_from_buckets(window)
            if p99 is not None and p99 > p99_slo_s:
                flag(("slo_route", route), {
                    "anomaly": "slo_route", "route": route,
                    "p99_s": p99, "slo_s": p99_slo_s,
                    "window_requests": window["count"]})
    state["route_hist"] = new_routes

    # ---- sustained load shedding (proxy admission control): judged on
    # serve_shed_total deltas per route, summed across processes and shed
    # reasons; flagged only after SHED_SUSTAIN_PASSES consecutive passes
    # with fresh sheds (a replica restart's counter reset reads as a
    # non-positive delta and clears the streak)
    prev_shed: Dict = dict(state.get("shed_seen") or {})
    streaks: Dict = dict(state.get("shed_streak") or {})
    shed_totals: Dict[str, float] = {}
    for _proc, s in families.get("serve_shed_total", ()):
        route = (s.get("tags") or {}).get("route", "?")
        shed_totals[route] = shed_totals.get(route, 0.0) + (
            s.get("value") or 0.0)
    for route, total in shed_totals.items():
        if route not in prev_shed:
            streaks[route] = 0        # baseline pass for a new route
        elif total - prev_shed[route] > 0:
            streaks[route] = streaks.get(route, 0) + 1
            if streaks[route] >= SHED_SUSTAIN_PASSES:
                flag(("serve_shedding", route), {
                    "anomaly": "serve_shedding", "route": route,
                    "shed_in_window": int(total - prev_shed[route]),
                    "sustained_passes": streaks[route]})
        else:
            streaks[route] = 0
    state["shed_seen"] = shed_totals
    state["shed_streak"] = {k: v for k, v in streaks.items()
                            if k in shed_totals}

    # ---- hot-path regression watch (compiled planes): each golden
    # signal is judged against its OWN rolling EWMA baseline — absolute
    # thresholds can't cover a 4-lane ring and a 2-stage LLM chain with
    # one number. The baseline warms over 3 samples, then freezes while
    # the key is regressed (updating it would absorb the regression and
    # silence the very next pass).
    if hotpath_drift > 0:
        base: Dict = dict(state.get("hotpath_base") or {})
        fresh_keys = set()

        def drift_check(bkey, value, floor, detail):
            fresh_keys.add(bkey)
            b = base.get(bkey)
            if b is None:
                base[bkey] = {"ewma": value, "n": 1}
                return
            if b["n"] >= 3 and value > max(floor, hotpath_drift * b["ewma"]):
                flag(("hotpath", bkey), {
                    "anomaly": "hotpath_regression",
                    "value": round(value, 6),
                    "baseline": round(b["ewma"], 6),
                    "drift": hotpath_drift, **detail})
                return
            b["ewma"] = 0.8 * b["ewma"] + 0.2 * value
            b["n"] += 1

        # ring stall ratio: stall seconds accrued per wall second since
        # the previous pass (cumulative counters delta'd per ring key);
        # the 0.05 floor keeps an all-idle ring's noise unflaggable
        prev_stall: Dict = dict(state.get("hotpath_stall") or {})
        new_stall: Dict = {}
        for row in workload_rows:
            if now - row.get("ts", 0) > FRESH_S:
                continue
            stats = row.get("stats") or {}
            key = str(row.get("key", "?"))
            if row.get("kind") == "hotpath":
                cum = ((stats.get("writer_stall_s") or 0.0)
                       + (stats.get("reader_stall_s") or 0.0))
                prev = prev_stall.get(key)
                new_stall[key] = (cum, row.get("ts", now))
                if prev is None:
                    continue
                dt = row.get("ts", now) - prev[1]
                if dt <= 0:
                    continue
                drift_check(("ring", key), max(cum - prev[0], 0.0) / dt,
                            0.05, {"metric": "ring_stall_ratio",
                                   "plane": stats.get("plane"),
                                   "key": key})
            elif row.get("kind") == "serve_chain":
                p99 = stats.get("p99_s")
                if p99:
                    drift_check(("chain_p99", key), float(p99), 0.0,
                                {"metric": "chain_p99_s", "chain": key})
        state["hotpath_stall"] = new_stall

        # fused-step phase stragglers: timed-step rows gossiped per rank
        # (key "run:rank"); one rank far above the gang's low median is
        # flagged with its slowest-vs-median phase named, so "rank 3 is
        # slow" arrives as "rank 3's inter-host allreduce is slow"
        runs: Dict[str, List[dict]] = {}
        for row in workload_rows:
            if row.get("kind") != "train_phase":
                continue
            if now - row.get("ts", 0) > FRESH_S:
                continue
            run = str(row.get("key", "?")).rsplit(":", 1)[0]
            runs.setdefault(run, []).append(row.get("stats") or {})
        for run, members in runs.items():
            steps = [m.get("step_s") for m in members if m.get("step_s")]
            if len(steps) < 2:
                continue
            med = statistics.median_low(steps)
            if med <= 0:
                continue
            phase_names = sorted({k for m in members for k in m
                                  if k.endswith("_s") and k != "step_s"})
            med_phase = {p: statistics.median_low(
                [m.get(p) or 0.0 for m in members]) for p in phase_names}
            for m in members:
                step = m.get("step_s") or 0.0
                if step > straggler_factor * med:
                    worst = max(phase_names, default=None,
                                key=lambda p: (m.get(p) or 0.0)
                                - med_phase[p])
                    flag(("phase_straggler", run, m.get("rank")), {
                        "anomaly": "hotpath_regression",
                        "metric": "train_phase_step_s", "run": run,
                        "rank": m.get("rank"), "step_s": round(step, 4),
                        "gang_median_s": round(med, 4),
                        "phase": worst[:-2] if worst else None})
        state["hotpath_base"] = {k: v for k, v in base.items()
                                 if k in fresh_keys}

    # prune the carry so a long-lived head doesn't accumulate state for
    # every process/run/route that ever existed: slow-pull high-waters
    # die with their process's snapshot, re-flag stamps age out once
    # they can no longer suppress anything
    live_procs = {proc for series in families.values()
                  for proc, _ in series}
    state["slow_pull_seen"] = {k: v for k, v in seen.items()
                               if k[0] in live_procs}
    state["last_flag"] = {k: v for k, v in last_flag.items()
                          if now - v < 2 * REFLAG_INTERVAL_S}
    return anomalies, state
