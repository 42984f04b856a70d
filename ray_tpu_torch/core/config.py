"""Central config registry: every tunable in ONE table.

Parity: `src/ray/common/ray_config_def.h` (the reference's 222-flag
X-macro table) + `RayConfig` introspection. Before this module, ~40
`RAY_TPU_*` env vars were read ad hoc across ~25 files — no single list,
no introspection, no way to ask a running cluster what it's tuned to.

- `config.get("name")` — typed value: explicit override → env var →
  default. Call-time reads, so tests that set env vars keep working.
- `config.dump()` — every flag with value + where it came from
  (`ray-tpu config` CLI, `/api/config` dashboard, state API).
- **negotiated flags** adopt the HEAD's value at registration (shipped
  in the `register_worker` reply): a process whose environment differs
  from the head's must not silently diverge on semantics the whole
  cluster shares. Precedence for negotiated flags is override > head >
  env > default (the head beats local env, an explicit in-process
  `set()` beats everything); non-negotiated flags skip the head tier.
  `refcount` pioneered this; the mechanism is now general.

Adding a flag = one table row; a tunable is never read from the env
directly. NOT flags (deliberately): per-process identity the parent
hands each child it spawns — RAY_TPU_{HEAD_PORT,SESSION,NODE_ID,LOG_TAG,
VENV_KEY,JAX_COORDINATOR,JAX_NUM_PROCESSES,JAX_PROCESS_ID,NODE_IP} and
the GKE-preset TPU_* facts. Those are arguments, not tunables: two
processes on one host legitimately hold different values, so a shared
registry would be wrong.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class Flag:
    name: str           # python-side name (snake_case)
    env: str            # environment variable
    type: type          # bool | int | float | str
    default: Any
    doc: str
    negotiated: bool = False  # cluster-wide: clients adopt the head's value


def _b(v: str) -> bool:
    return v not in ("0", "false", "False", "")


FLAGS: List[Flag] = [
    # ----------------------------------------------------- object lifetime
    Flag("refcount", "RAY_TPU_REFCOUNT", bool, True,
         "Distributed reference counting drives object eviction "
         "(free() optional). Reference: ReferenceCounter.", negotiated=True),
    Flag("evict_grace_s", "RAY_TPU_EVICT_GRACE_S", float, 0.0,
         "Grace before evicting an interest-free object; 0 = fully "
         "explicit lifetime (borrow pins).", negotiated=True),
    Flag("refcount_flush_s", "RAY_TPU_REFCOUNT_FLUSH_S", float, 0.1,
         "Batching window for ref transitions pushed to the head."),
    Flag("lineage_cap", "RAY_TPU_LINEAGE_CAP", int, 10_000,
         "Max reconstructable-task lineage entries at the head."),
    Flag("lineage_bytes", "RAY_TPU_LINEAGE_BYTES", int, 256 << 20,
         "Byte cap for lineage specs (inline args pin memory)."),
    # ------------------------------------------------------- object store
    Flag("object_store_bytes", "RAY_TPU_OBJECT_STORE_BYTES", int, 0,
         "Node object-store capacity; 0 = 30% of RAM capped by /dev/shm."),
    Flag("store_isolation", "RAY_TPU_STORE_ISOLATION", bool, False,
         "Per-node store namespaces on one machine (forces real "
         "cross-node transfers in tests)."),
    Flag("store_namespace", "RAY_TPU_STORE_NAMESPACE", str, "",
         "Explicit store namespace (else derived from node id)."),
    Flag("disable_native_store", "RAY_TPU_DISABLE_NATIVE_STORE", bool, False,
         "Skip the C++ arena store even if built."),
    Flag("pull_cache_bytes", "RAY_TPU_PULL_CACHE_BYTES", int, 1 << 30,
         "Per-process LRU cache of cross-node pulled objects."),
    # -------------------------------------------------------- data plane
    Flag("transfer_chunk_bytes", "RAY_TPU_TRANSFER_CHUNK_BYTES", int, 4 << 20,
         "Chunk size for cross-node object pulls."),
    Flag("transfer_window", "RAY_TPU_TRANSFER_WINDOW", int, 4,
         "In-flight chunks per pull (windowed transfer)."),
    Flag("transfer_server_reads", "RAY_TPU_TRANSFER_SERVER_READS", int, 8,
         "Concurrent chunk reads served per data server."),
    Flag("transfer_chunk_retries", "RAY_TPU_TRANSFER_CHUNK_RETRIES", int, 4,
         "Per-chunk retry budget inside one pull attempt (rides the "
         "chaos plane: injected drops/delays on the data edge are "
         "absorbed here before multi-source failover kicks in)."),
    Flag("transfer_retry_backoff_s", "RAY_TPU_TRANSFER_RETRY_BACKOFF_S",
         float, 0.05, "Base backoff between chunk retries (doubles per "
         "attempt, capped at 1s)."),
    Flag("object_directory", "RAY_TPU_OBJECT_DIRECTORY", bool, True,
         "Gossip object locations on the cluster_view plane so daemons "
         "and drivers resolve objects peer-to-peer; the head's "
         "locate_object becomes the cold-miss fallback.", negotiated=True),
    Flag("node_pull_manager", "RAY_TPU_NODE_PULL_MANAGER", bool, True,
         "Workers route remote-object pulls through their node daemon's "
         "pull manager so each object crosses the network once per node.",
         negotiated=True),
    Flag("replica_cache_bytes", "RAY_TPU_REPLICA_CACHE_BYTES", int, 1 << 30,
         "Node-daemon LRU cache of pulled object replicas (advertised "
         "in the gossiped object directory as pull sources)."),
    Flag("device_dlpack", "RAY_TPU_DEVICE_DLPACK", bool, True,
         "Rematerialize pulled device-object leaves via DLPack "
         "(zero-copy adoption of the mapped shm view on CPU backends; "
         "falls back to device_put)."),
    Flag("ici_fetch_timeout_s", "RAY_TPU_ICI_FETCH_TIMEOUT_S", float, 60.0,
         "Bound on a gang-ICI device fetch before the consumer surfaces "
         "ObjectLostError (a dead peer poisons the pair collective)."),
    # ----------------------------------------------------------- runtime
    Flag("head_host", "RAY_TPU_HEAD_HOST", str, "127.0.0.1",
         "Head host for spawned workers."),
    Flag("bind_host", "RAY_TPU_BIND_HOST", str, "127.0.0.1",
         "Bind address for every server (head/data/direct/proxy); set "
         "0.0.0.0 to accept off-box connections."),
    Flag("address", "RAY_TPU_ADDRESS", str, "",
         "Default cluster address for init()/CLI."),
    Flag("lease_idle_s", "RAY_TPU_LEASE_IDLE_S", float, 1.0,
         "Idle time before a leased worker returns to the pool."),
    # -------------------------------------------- two-level scheduling
    Flag("view_broadcast_s", "RAY_TPU_VIEW_BROADCAST_S", float, 0.25,
         "Head cadence for pushing the compacted cluster resource view "
         "to node daemons and drivers (reference ray_syncer broadcast)."),
    Flag("gossip_debounce_s", "RAY_TPU_GOSSIP_DEBOUNCE_S", float, 0.05,
         "Node-daemon debounce for resource-view deltas pushed to the "
         "head on local pool changes."),
    Flag("pool_idle_s", "RAY_TPU_POOL_IDLE_S", float, 5.0,
         "Idle time before a node daemon returns a pooled lease worker "
         "(and its resource carve-out) to the head."),
    Flag("node_local_sched", "RAY_TPU_NODE_LOCAL_SCHED", bool, True,
         "Clients route lease requests to node-daemon schedulers via the "
         "cached cluster view; off = every lease goes through the head.",
         negotiated=True),
    Flag("peer_spill_attempts", "RAY_TPU_PEER_SPILL_ATTEMPTS", int, 2,
         "On a local-pool miss a node daemon refers the client to up to "
         "this many peer daemons whose gossiped pools show warm idle "
         "workers (epoch-stamped peer grants; the head becomes the last "
         "resort). 0 disables daemon-to-daemon spillback.",
         negotiated=True),
    Flag("pool_acquire_timeout_s", "RAY_TPU_POOL_ACQUIRE_TIMEOUT_S",
         float, 8.0,
         "Daemon-side bound on the head pool_acquire carve-out RPC; a "
         "paused/hung head must fail over to peer referral or client "
         "spill instead of stalling the grant forever."),
    Flag("lease_park_max", "RAY_TPU_LEASE_PARK_MAX", int, 256,
         "Per-shape bound on cold-path tasks parked in the client's "
         "local dispatch queue while the head is unreachable (drained "
         "through daemon/peer-granted leases; overflow falls back to "
         "the head path)."),
    Flag("view_shards", "RAY_TPU_VIEW_SHARDS", int, 0,
         "Shard the cluster_view broadcast: interest-scoped subscribers "
         "(node daemons register interest='auto') receive only the "
         "node-set shards they route against plus a compact digest for "
         "spillback candidate selection, instead of the full node list "
         "(head-side flag; 0/1 = full-fanout broadcasts)."),
    Flag("view_digest_k", "RAY_TPU_VIEW_DIGEST_K", int, 16,
         "Spillback-candidate rows carried in the sharded-view digest "
         "(top idle-pool nodes cluster-wide)."),
    Flag("view_digest_refresh_s", "RAY_TPU_VIEW_DIGEST_REFRESH_S",
         float, 2.0,
         "Cadence for refreshing a scoped subscriber's digest when none "
         "of its interest shards changed (keeps spillback candidate "
         "idle counts honest without full-fanout broadcasts)."),
    Flag("reconnect_timeout_s", "RAY_TPU_RECONNECT_TIMEOUT_S", float, 30.0,
         "Window for clients to reconnect to a restarted head; 0 = die "
         "on disconnect."),
    Flag("runtime_env_cache_bytes", "RAY_TPU_RUNTIME_ENV_CACHE_BYTES",
         int, 2 << 30, "Head-side cap for cached runtime_env packages."),
    Flag("client_proxy_max_clients", "RAY_TPU_CLIENT_PROXY_MAX_CLIENTS",
         int, 16, "Concurrent remote drivers the client proxy will host; "
         "each costs a full driver process on the head node."),
    Flag("testing_rpc_failure", "RAY_TPU_TESTING_RPC_FAILURE", str, "",
         "Chaos injection: 'method:prob,...' (reference rpc_chaos)."),
    Flag("chaos", "RAY_TPU_CHAOS", str, "",
         "Deterministic fault plan: comma-separated rules "
         "'kind:target[:k=v...]' with kinds drop|delay|dup|partition|kill,"
         " triggers n=/every=/p=, windows after=/for=, plan-wide seed=N "
         "(README 'Failure model'); faults surface as "
         "chaos_injected_total{method,kind}."),
    Flag("node_reconnect_timeout_s", "RAY_TPU_NODE_RECONNECT_TIMEOUT_S",
         float, 60.0,
         "Window for a node daemon to reconnect to a restarted/partitioned"
         " head while serving warm leases from its existing pools and "
         "queueing gossip; 0 = die on head disconnect (pre-epoch "
         "behavior)."),
    # ------------------------------------------------------------- memory
    # ------------------------------------------------------------- health
    Flag("health_check_interval_s", "RAY_TPU_HEALTH_CHECK_INTERVAL_S",
         float, 5.0, "Liveness-probe cadence for workers/node daemons; "
         "0 disables probing (reference gcs_health_check_manager)."),
    Flag("health_check_timeout_s", "RAY_TPU_HEALTH_CHECK_TIMEOUT_S",
         float, 5.0, "Per-probe reply deadline."),
    Flag("health_check_misses", "RAY_TPU_HEALTH_CHECK_MISSES", int, 3,
         "Consecutive missed probes before a hung-but-connected process "
         "is declared dead (its socket is closed, triggering the normal "
         "failure path: actor restart, lease revoke, task retry)."),
    Flag("memory_monitor", "RAY_TPU_MEMORY_MONITOR", bool, True,
         "OOM monitor kills the newest task when node memory crosses "
         "the threshold."),
    Flag("memory_usage_threshold", "RAY_TPU_MEMORY_USAGE_THRESHOLD",
         float, 0.95, "Fraction of node memory that triggers the killer."),
    Flag("memory_monitor_interval_s", "RAY_TPU_MEMORY_MONITOR_INTERVAL_S",
         float, 1.0, "Monitor poll interval."),
    Flag("meminfo_path", "RAY_TPU_MEMINFO_PATH", str, "/proc/meminfo",
         "Meminfo source (tests point this at a fixture)."),
    # ------------------------------------------------------------ logging
    Flag("log_to_driver", "RAY_TPU_LOG_TO_DRIVER", bool, True,
         "Stream worker prints to the submitting driver's terminal."),
    # ------------------------------------------------------ observability
    Flag("tracing", "RAY_TPU_TRACING", bool, False,
         "OpenTelemetry-style span export."),
    Flag("tracing_buffer_spans", "RAY_TPU_TRACING_BUFFER_SPANS", int, 10_000,
         "In-process finished-span buffer cap; overflow drops the oldest "
         "half (reference span-processor queue bound)."),
    Flag("metrics_push_interval_s", "RAY_TPU_METRICS_PUSH_INTERVAL_S",
         float, 2.0, "Worker metrics push cadence."),
    Flag("rpc_metrics", "RAY_TPU_RPC_METRICS", bool, True,
         "Control-plane flight recorder: per-method RPC counters and "
         "latency histograms recorded through the protocol interposer "
         "in every process (head/daemon/driver/worker)."),
    Flag("flight_recorder_events", "RAY_TPU_FLIGHT_RECORDER_EVENTS", int, 512,
         "Per-node-daemon ring buffer of lease-lifecycle/gossip events "
         "piggybacked on resource_view_delta gossip."),
    Flag("flight_recorder_head_events", "RAY_TPU_FLIGHT_RECORDER_HEAD_EVENTS",
         int, 5000, "Head-side merged lease-event buffer (state API "
         "list_lease_events) and driver-side scheduling-phase buffer."),
    Flag("tracing_head_spans", "RAY_TPU_TRACING_HEAD_SPANS", int, 20_000,
         "Head-side buffer of finished spans pushed by every process "
         "(workload flight recorder); timeline(format='chrome') merges "
         "them into one cross-process trace."),
    Flag("workload_watchdog_interval_s", "RAY_TPU_WORKLOAD_WATCHDOG_INTERVAL_S",
         float, 5.0, "Head-side anomaly pass cadence over the merged "
         "workload telemetry (0 disables)."),
    Flag("workload_slow_pull_s", "RAY_TPU_WORKLOAD_SLOW_PULL_S", float, 5.0,
         "Object pulls slower than this flag a slow_pull anomaly."),
    Flag("workload_straggler_factor", "RAY_TPU_WORKLOAD_STRAGGLER_FACTOR",
         float, 2.0, "A train worker whose EWMA step time exceeds this "
         "multiple of its gang's median is flagged a straggler."),
    Flag("serve_p99_slo_s", "RAY_TPU_SERVE_P99_SLO_S", float, 0.0,
         "Route-level p99 latency SLO for the workload watchdog "
         "(0 disables the slo_route anomaly)."),
    Flag("serve_live_signal_refresh_s", "RAY_TPU_SERVE_LIVE_SIGNAL_REFRESH_S",
         float, 1.0, "Serve routers/autoscaler re-pull the merged "
         "gossiped replica-load rows (state.list_serve_stats) at most "
         "this often (0 disables live-signal consumption; routing falls "
         "back to local in-flight counts)."),
    Flag("serve_live_signal_max_age_s", "RAY_TPU_SERVE_LIVE_SIGNAL_MAX_AGE_S",
         float, 5.0, "Gossiped replica-load rows older than this are "
         "ignored by live-signal routing and admission control (local "
         "in-flight counts take over)."),
    Flag("tracing_compiled_sample_n", "RAY_TPU_TRACING_COMPILED_SAMPLE_N",
         int, 16, "Sample 1-in-N compiled-plane submissions for span "
         "capture when tracing is on (carriers ride the ring entries; "
         "0 disables compiled-path tracing entirely). Sampling keeps "
         "the zero-RPC contract and compiled p99 intact."),
    Flag("ring_telemetry_interval_s", "RAY_TPU_RING_TELEMETRY_INTERVAL_S",
         float, 1.0, "Cadence of lock-free shm-ring header snapshots "
         "(occupancy + writer/reader stall attribution) published per "
         "compiled chain / pipeline lane (0 disables ring telemetry)."),
    Flag("workload_hotpath_drift", "RAY_TPU_WORKLOAD_HOTPATH_DRIFT",
         float, 1.5, "hotpath_regression threshold: a hot-path golden "
         "signal (compiled p99, ring stall ratio, fused-step phase "
         "time) exceeding this multiple of its rolling baseline is "
         "flagged by the workload watchdog (0 disables)."),
    # --------------------------------------------------------------- GPU
    Flag("num_gpus", "RAY_TPU_NUM_GPUS", int, -1,
         "Override GPU autodetection (-1 = autodetect)."),
    Flag("pod_type", "RAY_TPU_POD_TYPE", str, "",
         "Node label ray.io/tpu-pod-type (config only on a GPU host)."),
    Flag("slice_name", "RAY_TPU_SLICE_NAME", str, "",
         "Node label ray.io/tpu-slice-name (config only on a GPU host)."),
    Flag("worker_id", "RAY_TPU_WORKER_ID", str, "",
         "Node label ray.io/tpu-worker-id (config only on a GPU host)."),
    Flag("gce_metadata_endpoint", "RAY_TPU_GCE_METADATA_ENDPOINT", str, "",
         "Read by nothing in the port: a GPU host has no TPU metadata "
         "server (kept so the table matches the JAX package's)."),
    # --------------------------------------------------------------- data
    Flag("data_memory_budget_bytes", "RAY_TPU_DATA_MEMORY_BUDGET_BYTES",
         int, 256 << 20,
         "Streaming executor in-flight byte budget (adaptive window)."),
    Flag("data_store_highwater", "RAY_TPU_DATA_STORE_HIGHWATER", float, 0.85,
         "Gossiped object-store pressure (used/capacity, any node) above "
         "which the streaming executor stops admitting NEW pipeline "
         "inputs — stages keep draining, so pressure falls instead of "
         "OOMing the store. 0 disables the signal."),
    Flag("data_input_retries", "RAY_TPU_DATA_INPUT_RETRIES", int, 3,
         "Per-(stage, partition) retries of a pipeline consumer task "
         "whose input block went lost (ObjectLostError result); each "
         "retry rides lineage reconstruction of the lost input."),
    Flag("data_prefetch", "RAY_TPU_DATA_PREFETCH", bool, True,
         "Push-side prefetch: stage a completed block into the consuming "
         "stage's node store before its task dispatches (overlaps the "
         "pull with queue wait; the node PullManager dedups)."),
    Flag("data_eager_release", "RAY_TPU_DATA_EAGER_RELEASE", bool, True,
         "Release consumed intermediate blocks' lineage entries when a "
         "partition's final output is consumed, so a long pipeline's "
         "store footprint stays bounded by the in-flight window."),
    # -------------------------------------------------------------- train
    Flag("torch_backend", "RAY_TPU_TORCH_BACKEND", str, "gloo",
         "torch.distributed backend for TorchTrainer."),
    Flag("torch_timeout_s", "RAY_TPU_TORCH_TIMEOUT_S", float, 120.0,
         "torch.distributed init timeout."),
    # ------------------------------------------------------------ testing
    Flag("testing_ici_drop_send", "RAY_TPU_TESTING_ICI_DROP_SEND", bool,
         False, "Chaos: drop ICI device-object sends (transfer tests)."),
    Flag("head_profile", "RAY_TPU_HEAD_PROFILE", str, "",
         "Write a cProfile of the head event loop to this path on "
         "SIGUSR1/exit."),
    Flag("spill_dir", "RAY_TPU_SPILL_DIR", str, "",
         "Object-spill directory; may be an fsspec URI (s3://, gs://) "
         "for remote spill storage."),
    Flag("usage_stats", "RAY_TPU_USAGE_STATS", bool, False,
         "Periodic usage-stats reporting (JSON lines under the state "
         "dir by default; reference usage_lib — opt-IN here)."),
]

_BY_NAME: Dict[str, Flag] = {f.name: f for f in FLAGS}
_BY_ENV: Dict[str, Flag] = {f.env: f for f in FLAGS}


class Config:
    """Process-wide view: overrides > env > head-negotiated > default."""

    def __init__(self) -> None:
        self._overrides: Dict[str, Any] = {}
        self._head_values: Dict[str, Any] = {}

    def _parse(self, flag: Flag, raw: str) -> Any:
        if flag.type is bool:
            return _b(raw)
        try:
            return flag.type(raw)
        except (TypeError, ValueError):
            return flag.default

    def get(self, name: str) -> Any:
        flag = _BY_NAME[name]
        if name in self._overrides:
            return self._overrides[name]
        if flag.negotiated and name in self._head_values:
            return self._head_values[name]  # head beats local env
        raw = os.environ.get(flag.env)
        if raw is not None and raw != "":
            return self._parse(flag, raw)
        return flag.default

    def source(self, name: str) -> str:
        flag = _BY_NAME[name]
        if name in self._overrides:
            return "override"
        if flag.negotiated and name in self._head_values:
            return "head"
        raw = os.environ.get(flag.env)
        if raw is not None and raw != "":
            return "env"
        return "default"

    def set(self, name: str, value: Any) -> None:
        if name not in _BY_NAME:
            raise KeyError(f"unknown config flag {name!r}")
        self._overrides[name] = value

    # ----------------------------------------------- cluster distribution
    def negotiated_snapshot(self) -> Dict[str, Any]:
        """The head's values for every negotiated flag — shipped to each
        process in the register_worker reply."""
        return {f.name: self.get(f.name) for f in FLAGS if f.negotiated}

    def adopt_head(self, values: Optional[Dict[str, Any]]) -> None:
        """Client side: record the head's negotiated values. get() ranks
        them above local env (never above an explicit set() override),
        and source() reports them as "head" — provenance stays honest."""
        if not values:
            return
        self._head_values.update(values)

    # ------------------------------------------------------ introspection
    def dump(self) -> List[dict]:
        return [{"name": f.name, "env": f.env,
                 "type": f.type.__name__,
                 "value": self.get(f.name), "default": f.default,
                 "source": self.source(f.name),
                 "negotiated": f.negotiated, "doc": f.doc}
                for f in FLAGS]


GLOBAL = Config()


def get(name: str) -> Any:
    return GLOBAL.get(name)


def dump() -> List[dict]:
    return GLOBAL.dump()
