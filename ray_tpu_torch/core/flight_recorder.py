"""Control-plane flight recorder: always-on RPC instrumentation.

Every process (head, node daemon, driver, worker) registers ONE
interposer through `protocol.add_rpc_interposer` that turns the
existing req/push/rep event stream into `util/metrics` series:

- ``rpc_requests_total{method, role, kind}``  — counter per outbound
  request/push;
- ``rpc_latency_seconds{method, role}``       — histogram of
  request→reply latency (the interposer's "rep" events carry
  ``duration_s`` measured inside the protocol layer).

``role`` names the control-plane edge, derived from the connection name
plus which process we are: ``client_head`` (driver/worker → head),
``client_daemon`` (driver → node-daemon scheduler), ``client_worker``
(driver → leased/direct worker), ``daemon_head`` (node daemon → head),
``head_peer`` (head → daemon/worker over its accepted connections),
``data`` (bulk object pulls).

This is passive telemetry riding connections that already exist — it
adds zero RPCs anywhere. Daemons cannot push snapshots through the KV
pusher (they hold no CoreClient), so their registry piggybacks on the
`resource_view_delta` gossip instead (see `core/node_main.py`); drivers
and workers push through the normal metrics pusher; the head's registry
is read in-process by the dashboard's `/metrics` scrape.

Reference: the production pattern in "Collective Communication for
100k+ GPUs" (arXiv:2510.20171) — always-on lightweight telemetry on the
control plane, not bolted-on sampling.
"""

from __future__ import annotations

import time
from typing import Optional

from ray_tpu_torch.core import config as _config
from ray_tpu_torch.core import protocol

# latency buckets biased to control-plane RPC scales (100µs .. 10s)
RPC_LATENCY_BOUNDARIES = [
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0]

_installed: Optional[str] = None   # process role once installed
_interposer = None


def _role_of(conn_name: str, process_role: str) -> str:
    if conn_name == "head":
        # the head names its accepted connections "head" too; requests it
        # issues through them (spawn_worker, health_ping) are head→peer
        return "head_peer" if process_role == "head" else "client_head"
    if conn_name == "node":
        return "daemon_head"
    if conn_name.startswith("sched"):
        return "client_daemon"
    if conn_name.startswith(("lease-", "direct-", "dev-")):
        return "client_worker"
    if conn_name.startswith(("data-", "node-data", "head-data")):
        return "data"
    return conn_name or "other"


def install(process_role: str) -> bool:
    """Register the RPC metrics interposer for this process (idempotent).

    `process_role`: "head" | "daemon" | "driver" | "worker" — only used
    to disambiguate the head's outbound requests; the connection name
    carries the rest.
    """
    global _installed, _interposer
    if _installed is not None:
        return False
    if not _config.get("rpc_metrics"):
        return False
    from ray_tpu_torch.util import metrics

    requests = metrics.Counter(
        "rpc_requests_total",
        "Outbound control-plane RPCs by method and edge role",
        tag_keys=("method", "role", "kind"))
    latency = metrics.Histogram(
        "rpc_latency_seconds",
        "Control-plane request round-trip latency by method and edge role",
        boundaries=RPC_LATENCY_BOUNDARIES,
        tag_keys=("method", "role"))
    chaos = metrics.Counter(
        "chaos_injected_total",
        "Faults injected by the chaos plane (protocol.configure_chaos) "
        "by method and fault kind",
        tag_keys=("method", "kind"))

    def _record(name, kind, method, **extra):
        if kind == "chaos":
            chaos.inc(tags={"method": method,
                            "kind": extra.get("chaos_kind", "?")})
            return
        role = _role_of(name, process_role)
        if kind == "rep":
            latency.observe(extra.get("duration_s", 0.0),
                            tags={"method": method, "role": role})
        else:
            requests.inc(tags={"method": method, "role": role, "kind": kind})

    protocol.add_rpc_interposer(_record)
    _installed = process_role
    _interposer = _record
    return True


def uninstall() -> None:
    """Remove the interposer (tests)."""
    global _installed, _interposer
    if _interposer is not None:
        protocol.remove_rpc_interposer(_interposer)
    _installed = None
    _interposer = None


def installed_role() -> Optional[str]:
    return _installed


class EventRing:
    """Bounded ring of flight-recorder events with monotonic sequence
    numbers and drain-for-send — the node daemon's per-node buffer
    piggybacked on resource_view_delta gossip. Delivery reliability
    lives one level up: drained events wait in the daemon's ack-tracked
    pending buffer until the head acknowledges their seq (see
    node_main._gossip_send)."""

    def __init__(self, cap: int):
        from collections import deque

        self.cap = int(cap)
        self._events: "deque[dict]" = deque(maxlen=self.cap)
        self._seq = 0
        self.dropped = 0

    def record(self, kind: str, **detail) -> dict:
        self._seq += 1
        if len(self._events) == self.cap:
            self.dropped += 1
        ev = {"seq": self._seq, "ts": time.time(), "kind": kind, **detail}
        self._events.append(ev)
        return ev

    def drain(self, limit: Optional[int] = None) -> list:
        """Pop up to `limit` oldest events (all when limit is None)."""
        out = []
        n = len(self._events) if limit is None else min(limit,
                                                       len(self._events))
        for _ in range(n):
            out.append(self._events.popleft())
        return out

