"""Tracing tests: spans around submit/execute with cross-process context.

The port's mirror of `tests/test_tracing.py`, case for case, against
`ray_tpu_torch` (GPUs counted by `num_gpus` where the JAX package counts
`num_tpu_chips`).

Mirrors `python/ray/tests/test_tracing.py`: driver trace context propagates
into the executing worker as one trace.
"""

import os

import pytest

import ray_tpu_torch
from ray_tpu_torch.util import tracing


@pytest.fixture(scope="module")
def cluster():
    os.environ["RAY_TPU_TRACING"] = "1"
    try:
        yield ray_tpu_torch.init(num_cpus=2, num_gpus=0, max_workers=4)
    finally:
        ray_tpu_torch.shutdown()
        os.environ.pop("RAY_TPU_TRACING", None)


def test_per_request_tracing_is_not_sticky():
    """A carrier-bearing span (client traceparent / task execute) records
    WITHOUT flipping the process-wide switch: one traced request must not
    turn tracing on for all subsequent untraced work.
    Runs FIRST in this module, before the cluster fixture exports
    RAY_TPU_TRACING=1 — but other MODULES in a full-suite run may have
    latched the process-global switch already, so snapshot/clear it."""
    saved_enabled = tracing._enabled
    saved_env = os.environ.pop("RAY_TPU_TRACING", None)
    tracing._enabled = False
    try:
        _assert_not_sticky()
    finally:
        tracing._enabled = saved_enabled
        if saved_env is not None:
            os.environ["RAY_TPU_TRACING"] = saved_env


def _assert_not_sticky():
    assert not tracing.is_enabled()
    with tracing.start_span(
            "forced", carrier={"traceparent":
                               f"00-{'ab' * 16}-{'cd' * 8}-01"}) as sp:
        assert sp is not None and sp.trace_id == "ab" * 16
        # children of an active context record too (is_recording), and
        # propagation works from the current span alone
        assert tracing.is_recording()
        assert tracing.inject_context()["traceparent"].startswith(
            f"00-{'ab' * 16}")
        with tracing.start_span("child") as child:
            assert child is not None and child.parent_id == sp.span_id
    # ...but the process-wide switch never flipped: carrier-less spans
    # outside the request record nothing
    assert not tracing.is_enabled() and not tracing.is_recording()
    with tracing.start_span("untraced") as sp2:
        assert sp2 is None


def test_trace_context_propagates_to_worker(cluster):
    tracing.enable_tracing()

    @ray_tpu_torch.remote
    def traced_task():
        span = tracing.current_span()
        return (span.trace_id, span.parent_id) if span else (None, None)

    with tracing.start_span("driver-root") as root:
        worker_trace_id, worker_parent = ray_tpu_torch.get(traced_task.remote(),
                                                     timeout=60)
        driver_trace_id = root.trace_id

    # one trace across processes: worker execution span shares the trace id
    # and is parented to the driver's submission span
    assert worker_trace_id == driver_trace_id
    spans = tracing.get_finished_spans()
    submit = [s for s in spans if s.name == "traced_task.remote"]
    assert submit and submit[0].trace_id == driver_trace_id
    assert worker_parent == submit[0].span_id
    assert submit[0].duration_s >= 0


def test_trace_propagates_through_nested_actor_call(cluster):
    """One trace id across THREE processes: driver submit → task execute
    → nested actor method call. The actor-call path injects the current
    span (the task's execute span) so the actor-side execution span
    parents to it — the chain a serve request rides proxy→replica."""
    tracing.enable_tracing()

    @ray_tpu_torch.remote
    class Probe:
        def snap(self):
            span = tracing.current_span()
            return (span.trace_id, span.parent_id) if span else (None, None)

    @ray_tpu_torch.remote
    def outer(h):
        span = tracing.current_span()
        inner = ray_tpu_torch.get(h.snap.remote(), timeout=60)
        return (span.trace_id if span else None,
                span.span_id if span else None, inner)

    h = Probe.remote()
    ray_tpu_torch.get(h.snap.remote(), timeout=60)  # actor warm-up
    with tracing.start_span("nested-root") as root:
        task_trace, task_span, (actor_trace, actor_parent) = ray_tpu_torch.get(
            outer.remote(h), timeout=60)
    assert task_trace == root.trace_id
    # the actor execution span continues the SAME trace and parents to
    # the in-task caller's span (the task's execute span)
    assert actor_trace == root.trace_id
    assert actor_parent == task_span


def test_span_exporter(cluster):
    class Sink:
        def __init__(self):
            self.spans = []

        def export(self, spans):
            self.spans.extend(spans)

    sink = Sink()
    tracing.enable_tracing(sink)
    with tracing.start_span("op", attributes={"k": "v"}):
        pass
    assert sink.spans and sink.spans[-1].name == "op"
    assert sink.spans[-1].attributes["k"] == "v"


def test_traceparent_roundtrip():
    tracing.enable_tracing()
    with tracing.start_span("outer") as outer:
        carrier = tracing.inject_context()
    assert carrier["traceparent"].startswith("00-" + outer.trace_id)
    with tracing.start_span("child", carrier=carrier) as child:
        assert child.trace_id == outer.trace_id
        assert child.parent_id == outer.span_id

