"""`ray_tpu_torch.timeline()`: Chrome-trace dump of task execution.

Parity: the `ray timeline` CLI (`python/ray/scripts/scripts.py`) which turns
profile events into a chrome://tracing JSON file. Here RUNNING→FINISHED/
FAILED transitions from the head's task-event buffer become complete ("X")
trace events, one row per worker.

With tracing enabled, the driver's flight-recorder scheduling phases are
merged in: each traced task gets its own row showing submit →
lease-acquire[local|peer|spillback|head] → dispatch → run as distinct
sub-spans ("peer" = a daemon-referred grant completed at a peer
daemon's warm pool; "parked" submits mark cold tasks that waited in the
client-local dispatch queue), with Chrome flow arrows (`s`/`f` events
keyed by task id) connecting submit to the run slice — the two-level
scheduler's warm path made visible per task.

A `head-reconcile` row renders the head's reconciliation phases from the
merged lease-event stream: node_dead→reregister/pool_reconcile windows,
head_lost→head_reconnect outages, stale-epoch rejects, and the train
controller's group_start/death_detected/restore/resize spans.
"""

from __future__ import annotations

import json
from typing import List, Optional


def _sched_phase_events(trace: List[dict]) -> None:
    """Append the driver-side scheduling-phase events (flight recorder)
    for traced tasks; no-op when nothing was recorded."""
    from ray_tpu_torch.core.api import _global_client, is_initialized

    if not is_initialized():
        return
    client = _global_client()
    events = list(getattr(client, "sched_events", ()) or ())
    flows = {}   # task_id -> phases seen (for flow arrows)
    for ev in events:
        t0, t1 = ev.get("t0"), ev.get("t1")
        if t0 is None or t1 is None:
            continue
        task_id = ev.get("task_id")
        mode = ev.get("mode")
        phase = ev["phase"]
        name = phase if phase in ("submit", "dispatch", "run") else \
            f"{phase}[{mode}]"
        tid = task_id[:12] if task_id else "lease-pool"
        trace.append({
            "name": name, "cat": "sched", "ph": "X",
            # floor at 0.1µs: sub-resolution phases must stay visible (and
            # nonzero) in chrome://tracing
            "ts": t0 * 1e6, "dur": max(t1 - t0, 1e-7) * 1e6,
            "pid": "driver-sched", "tid": tid,
            "args": {k: v for k, v in ev.items()
                     if k not in ("t0", "t1") and v is not None},
        })
        if task_id:
            flows.setdefault(task_id, {})[phase] = ev
    # flow arrows: submit → run (falling back to dispatch) per task
    for task_id, phases in flows.items():
        src = phases.get("submit")
        dst = phases.get("run") or phases.get("dispatch")
        if src is None or dst is None:
            continue
        common = {"cat": "sched", "name": "sched-flow", "id": task_id,
                  "pid": "driver-sched", "tid": task_id[:12]}
        trace.append({**common, "ph": "s", "ts": src["t1"] * 1e6})
        trace.append({**common, "ph": "f", "bp": "e",
                      "ts": dst["t0"] * 1e6})


def _reconcile_phase_events(trace: List[dict]) -> None:
    """Head-side reconciliation phases from the merged flight-recorder
    lease-event stream: epoch-fence / pool-reconcile windows and train
    controller restarts become spans so 'why did the cluster pause here'
    is answerable from the same trace as the task rows. Best-effort —
    a head that predates these event kinds just contributes nothing."""
    from ray_tpu_torch.util.state import list_lease_events

    try:
        events = list_lease_events()
    except Exception:
        return
    PID = "head-reconcile"
    # windows opened by a loss event, closed by the matching recovery
    open_windows = {}   # (kind_family, node_id) -> open event
    pairs = {"node_dead": ("node_reregister", "pool_reconcile"),
             "head_lost": ("head_reconnect",)}
    closers = {c: fam for fam, cs in pairs.items() for c in cs}
    for ev in events:
        kind = ev.get("kind", "")
        nid = (ev.get("node_id") or "")[:12]
        if kind in pairs:
            open_windows[(kind, nid)] = ev
            continue
        if kind in closers:
            fam = closers[kind]
            start = open_windows.pop((fam, nid), None)
            if start is not None:
                trace.append({
                    "name": f"{fam}→{kind}", "cat": "reconcile", "ph": "X",
                    "ts": start["ts"] * 1e6,
                    "dur": max(ev["ts"] - start["ts"], 1e-7) * 1e6,
                    "pid": PID, "tid": nid or "head",
                    "args": {"node_id": ev.get("node_id")}})
            continue
        if kind.startswith("train_"):
            t0, t1 = ev.get("t0"), ev.get("t1")
            row = {"cat": "train", "pid": PID,
                   "tid": f"train:{ev.get('run', '?')}",
                   "args": {k: v for k, v in ev.items()
                            if k not in ("t0", "t1") and v is not None}}
            if t0 is not None and t1 is not None:
                trace.append({**row, "name": kind, "ph": "X",
                              "ts": t0 * 1e6,
                              "dur": max(t1 - t0, 1e-7) * 1e6})
            else:
                trace.append({**row, "name": kind, "ph": "i",
                              "ts": ev["ts"] * 1e6, "s": "t"})
            continue
        if kind in ("chain_fence", "chain_failover"):
            # compiled serve plane: a fence (replica death / ring failure)
            # and any failover burst render as instants on the chain's
            # own reconcile lane, next to the scheduler's node_dead
            # windows they usually coincide with
            trace.append({
                "name": kind, "cat": "reconcile", "ph": "i",
                "ts": ev["ts"] * 1e6, "s": "t", "pid": PID,
                "tid": f"chain:{ev.get('chain', '?')}",
                "args": {k: v for k, v in ev.items()
                         if k != "ts" and v is not None}})
            continue
        if kind == "stale_epoch":
            trace.append({
                "name": "stale_epoch", "cat": "reconcile", "ph": "i",
                "ts": ev["ts"] * 1e6, "s": "t", "pid": PID,
                "tid": nid or "head",
                "args": {"method": ev.get("method"),
                         "epoch": ev.get("epoch")}})
    # still-open windows (node died, never came back): begin events
    for (fam, nid), start in open_windows.items():
        trace.append({"name": fam, "cat": "reconcile", "ph": "B",
                      "ts": start["ts"] * 1e6, "pid": PID,
                      "tid": nid or "head",
                      "args": {"node_id": start.get("node_id")}})


def _workload_span_events(trace: List[dict]) -> None:
    """Merge the workload flight recorder's spans — serve request spans,
    replica/actor execution, object pulls, collective ops, train steps —
    into the trace: the driver's own finished spans plus every span other
    processes pushed to the head, deduped by span id. pid = node,
    tid = process; Chrome flow arrows (`s`/`f`, keyed by the child span
    id) connect parent→child across process boundaries so one request's
    proxy → replica → task path reads as one connected lane."""
    spans = {}
    # label local spans exactly as the head labels this process's pushed
    # copies, and let head copies win on overlap — otherwise one process
    # renders as two lanes ("driver" + its worker id) with false
    # cross-process flow arrows between them
    proc = node = "driver"
    try:
        from ray_tpu_torch.core.api import _global_client, is_initialized

        if is_initialized():
            client = _global_client()
            proc = client.worker_id.hex()[:12]
            nid = (client.node_info or {}).get("node_id")
            if nid is not None:
                node = nid.hex()[:12]
    except Exception:
        pass
    try:
        from ray_tpu_torch.util import tracing

        for s in tracing.get_finished_spans():
            spans[s.span_id] = {**s.to_dict(), "proc": proc, "node": node}
    except Exception:
        pass
    try:
        from ray_tpu_torch.util.state import list_trace_spans

        for row in list_trace_spans():
            if row.get("span_id"):
                spans[row["span_id"]] = row
    except Exception:
        pass

    def _pid(sd):
        return sd.get("node") or sd.get("proc") or "?"

    def _tid(sd):
        return sd.get("proc") or "?"

    for sd in spans.values():
        start, end = sd.get("start_ts"), sd.get("end_ts")
        if not start:
            continue
        trace.append({
            "name": sd.get("name", "span"), "cat": "span", "ph": "X",
            "ts": start * 1e6,
            "dur": max((end or start) - start, 1e-7) * 1e6,
            "pid": _pid(sd), "tid": _tid(sd),
            "args": {"trace_id": sd.get("trace_id"),
                     "span_id": sd.get("span_id"),
                     "parent_id": sd.get("parent_id"),
                     **(sd.get("attributes") or {})},
        })
    # flow arrows only where BOTH ends exist (every flow event must pair)
    for sd in spans.values():
        parent = spans.get(sd.get("parent_id"))
        if parent is None or not sd.get("start_ts") \
                or not parent.get("start_ts"):
            continue
        if _pid(parent) == _pid(sd) and _tid(parent) == _tid(sd):
            continue  # same lane: nesting is already visible
        common = {"cat": "span-flow", "name": "trace-flow",
                  "id": sd["span_id"]}
        trace.append({**common, "ph": "s", "pid": _pid(parent),
                      "tid": _tid(parent),
                      "ts": parent["start_ts"] * 1e6})
        trace.append({**common, "ph": "f", "bp": "e", "pid": _pid(sd),
                      "tid": _tid(sd),
                      "ts": max(sd["start_ts"], parent["start_ts"]) * 1e6})


def timeline(filename: Optional[str] = None, *,
             format: Optional[str] = None) -> List[dict]:
    """Build Chrome trace events; write to `filename` if given.

    `format="chrome"` writes the JSON *Object* envelope
    (`{"traceEvents": [...]}`) that Perfetto/chrome://tracing load
    directly; the default (legacy) writes the bare event array. Both
    carry the same merged content: task phases, driver scheduling
    phases, head-reconcile windows, and the workload flight recorder's
    cross-process spans (serve requests, replica execution, object
    pulls, collective ops, train steps) with flow arrows across
    processes."""
    from ray_tpu_torch.util.state import list_task_events

    events = list_task_events()
    open_spans = {}   # task_id -> RUNNING event
    trace: List[dict] = []
    names = {}
    for ev in events:
        if ev["state"] == "RUNNING":
            open_spans[ev["task_id"]] = ev
            if ev["name"]:
                names[ev["task_id"]] = ev["name"]
        elif ev["state"] in ("FINISHED", "FAILED"):
            start = open_spans.pop(ev["task_id"], None)
            if start is None:
                continue
            trace.append({
                "name": names.get(ev["task_id"], "task"),
                "cat": "task",
                "ph": "X",
                "ts": start["ts"] * 1e6,
                "dur": (ev["ts"] - start["ts"]) * 1e6,
                "pid": start["node_id"] or "head",
                "tid": start["worker_id"] or "worker",
                "args": {"task_id": ev["task_id"],
                         "failed": ev["state"] == "FAILED"},
            })
    # still-running tasks: begin events so they show in the trace
    for task_id, start in open_spans.items():
        trace.append({"name": names.get(task_id, "task"), "cat": "task",
                      "ph": "B", "ts": start["ts"] * 1e6,
                      "pid": start["node_id"] or "head",
                      "tid": start["worker_id"] or "worker",
                      "args": {"task_id": task_id}})
    _sched_phase_events(trace)
    _reconcile_phase_events(trace)
    _workload_span_events(trace)
    if filename:
        payload = ({"traceEvents": trace, "displayTimeUnit": "ms"}
                   if format == "chrome" else trace)
        with open(filename, "w") as f:
            json.dump(payload, f)
    return trace
