"""Compiled serving chain (counterpart of `ray_tpu/serve/compiled_chain.py`),
in part.

Ported so far: the per-item error markers and the trace envelope a ring
entry carries. `LLMServer.batch_call` returns the error marker for an item
that failed, as the chain's writer does, and `ReplicaActor.handle_chain`
peels and re-wraps the envelope. `CompiledServeChain` and `ChainResponse`,
the chain itself, are ROADMAP item 18b.
"""

from __future__ import annotations

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
