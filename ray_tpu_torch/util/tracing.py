"""Distributed tracing: spans around task submit/execute with W3C context
propagation.

Parity: `python/ray/util/tracing/tracing_helper.py` — the driver opens a
submission span and injects a W3C `traceparent` into the task spec; the
executing worker extracts it and opens a child execution span, so one trace
follows a task across processes.

This image ships only `opentelemetry-api` (no SDK), so the tracer here is
self-contained: 128-bit trace ids, 64-bit span ids, W3C traceparent
inject/extract, finished spans buffered in-process (drain with
`get_finished_spans()` or hand them to any exporter object with an
`export(spans)` method). When the OpenTelemetry SDK *is* installed, spans
are mirrored through it automatically.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from ray_tpu_torch.core import config as _config
import secrets
import threading
import time
from typing import Dict, List, Optional

_enabled = False
_lock = threading.Lock()
_finished: List["Span"] = []
# spans waiting to ride the next metrics push to the head (workload
# tracing: the head accumulates every process's spans so timeline() can
# merge one cross-process trace) — bounded separately from _finished
_push_queue: List[dict] = []
_dropped_counter = None
_exporter = None
_current: "contextvars.ContextVar[Optional[Span]]" = contextvars.ContextVar(
    "ray_tpu_span", default=None)


@dataclasses.dataclass
class Span:
    name: str
    trace_id: str            # 32 hex chars
    span_id: str             # 16 hex chars
    parent_id: Optional[str]
    attributes: Dict[str, object]
    start_ts: float = 0.0
    end_ts: float = 0.0

    @property
    def duration_s(self) -> float:
        return self.end_ts - self.start_ts

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    def to_dict(self) -> dict:
        """JSON-safe form (rides the metrics push to the head)."""
        attrs = {k: (v if isinstance(v, (str, int, float, bool)) else str(v))
                 for k, v in self.attributes.items()}
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "start_ts": self.start_ts, "end_ts": self.end_ts,
                "attributes": attrs}


def enable_tracing(exporter=None) -> None:
    """Turn tracing on (idempotent). `exporter`: optional object with
    `.export(list_of_spans)` called at each span end."""
    global _enabled, _exporter
    _enabled = True
    if exporter is not None:
        _exporter = exporter


def is_enabled() -> bool:
    global _enabled
    if not _enabled and _config.get("tracing"):
        _enabled = True
    return _enabled


def current_span() -> Optional[Span]:
    return _current.get()


def is_recording() -> bool:
    """True when a span opened now would record: tracing is enabled
    process-wide, or we are inside an active trace context (a remote
    caller's context adopted per-request — the OTel sampling model:
    the root decides, children follow the parent)."""
    return is_enabled() or _current.get() is not None


def get_finished_spans(clear: bool = False) -> List[Span]:
    with _lock:
        out = list(_finished)
        if clear:
            _finished.clear()
    return out


@contextlib.contextmanager
def start_span(name: str, *, carrier: Optional[Dict[str, str]] = None,
               attributes: Optional[dict] = None):
    """Open a span as current; parents to `carrier` (W3C traceparent dict)
    if given, else to the current in-process span.

    Records when tracing is enabled process-wide, OR when a parent
    context exists (a carrier, or an in-process current span): a traced
    request's children record in every process it crosses without
    flipping any process-wide switch — per-request tracing stays
    per-request."""
    parent_trace = parent_span = None
    carrier_sampled = False
    if carrier and "traceparent" in carrier:
        # strict parse: a malformed header (LBs and APM agents inject
        # these freely) must NOT force recording, and neither must a
        # valid one whose W3C sampled flag is 00
        try:
            _, t, s, flags = carrier["traceparent"].split("-")
        except ValueError:
            t = s = flags = None
        if t and len(t) == 32 and s and len(s) == 16:
            parent_trace, parent_span = t, s
            carrier_sampled = flags != "00"
    if not (is_enabled() or _current.get() is not None or carrier_sampled):
        yield None
        return
    if parent_trace is None:
        cur = _current.get()
        if cur is not None:
            parent_trace, parent_span = cur.trace_id, cur.span_id
    span = Span(name=name,
                trace_id=parent_trace or secrets.token_hex(16),
                span_id=secrets.token_hex(8),
                parent_id=parent_span,
                attributes=dict(attributes or {}),
                start_ts=time.time())
    token = _current.set(span)
    try:
        yield span
    finally:
        _current.reset(token)
        span.end_ts = time.time()
        cap = max(int(_config.get("tracing_buffer_spans")), 2)
        dropped = 0
        with _lock:
            _finished.append(span)
            if len(_finished) > cap:
                # drop the oldest half: amortized O(1) per span, and the
                # newest spans are the ones a live debugging session needs
                del _finished[:cap // 2]
            _push_queue.append(span.to_dict())
            if len(_push_queue) > cap:
                dropped = cap // 2
                del _push_queue[:dropped]
        if dropped:
            _count_dropped(dropped)
        if _exporter is not None:
            try:
                _exporter.export([span])
            except Exception:
                pass


def _count_dropped(n: int) -> None:
    """Spans dropped before reaching the head are invisible losses unless
    counted — `trace_spans_dropped_total` makes the budget observable."""
    global _dropped_counter
    try:
        if _dropped_counter is None:
            from ray_tpu_torch.util import metrics as _m

            _dropped_counter = _m.Counter(
                "trace_spans_dropped_total",
                "Finished spans dropped from the push buffer before the "
                "head could collect them (raise tracing_buffer_spans)")
        _dropped_counter.inc(n)
    except Exception:
        pass


def drain_push_spans(limit: int = 512) -> List[dict]:
    """Pop up to `limit` finished-span dicts for the metrics push (the
    head accumulates them for cross-process timeline export)."""
    with _lock:
        out = _push_queue[:limit]
        del _push_queue[:limit]
    return out


def requeue_push_spans(spans: List[dict]) -> None:
    """Put drained spans back after a failed push so a transient head
    outage doesn't silently hole the cross-process timeline; overflow
    (oldest first) is counted as dropped like any other loss."""
    if not spans:
        return
    cap = max(int(_config.get("tracing_buffer_spans")), 2)
    with _lock:
        _push_queue[:0] = spans
        overflow = len(_push_queue) - cap
        if overflow > 0:
            del _push_queue[:overflow]
    if overflow > 0:
        _count_dropped(overflow)


@contextlib.contextmanager
def adopt_context(carrier: Optional[Dict[str, str]]):
    """Make `carrier`'s span current WITHOUT recording a new span: code
    that runs on behalf of a remote caller (dependency fetches before the
    execute span opens, a daemon serving a pull) parents any spans it
    opens to the caller's context. A carrier's presence means the origin
    traces, so tracing is enabled here (same contract as execute_span)."""
    if not carrier or "traceparent" not in carrier:
        yield None
        return
    try:
        _, trace_id, span_id, _ = carrier["traceparent"].split("-")
    except ValueError:
        yield None
        return
    synthetic = Span(name="(remote)", trace_id=trace_id, span_id=span_id,
                     parent_id=None, attributes={})
    token = _current.set(synthetic)
    try:
        yield synthetic
    finally:
        _current.reset(token)


def inject_context() -> Optional[Dict[str, str]]:
    """Current span context as a W3C carrier (rides in the task spec).
    Keyed on the CURRENT span, not the process-wide switch: a span only
    becomes current when it recorded, so per-request traces propagate
    without enabling tracing for unrelated work."""
    cur = _current.get()
    if cur is None:
        return None
    return {"traceparent": cur.traceparent()}


def submit_span(task_name: str):
    if not is_recording():
        return contextlib.nullcontext()
    return start_span(f"{task_name}.remote",
                      attributes={"ray_tpu.op": "submit"})


def execute_span(task_name: str, carrier: Optional[Dict[str, str]]):
    if carrier is None:
        return contextlib.nullcontext()
    # the carrier's presence means the ORIGIN traces this operation;
    # start_span records on it without flipping this process's switch,
    # so one traced request doesn't turn tracing on for everything else
    return start_span(task_name, carrier=carrier,
                      attributes={"ray_tpu.op": "execute",
                                  "ray_tpu.pid": os.getpid()})


def request_span(name: str, carrier: Optional[Dict[str, str]],
                 attributes: Optional[dict] = None):
    """Root/continuation span for an ingress request (serve HTTP/gRPC
    proxies): a client-supplied W3C `traceparent` traces THIS request
    even when the cluster flag is off (the carrier clause in start_span
    — no process-wide state changes); without a carrier this opens a
    root span only when tracing is already enabled."""
    if not carrier and not is_enabled():
        return contextlib.nullcontext()
    return start_span(name, carrier=carrier, attributes=attributes)
