"""ServeController actor: owns app/deployment state, reconciles replicas
(counterpart of `ray_tpu/serve/controller.py`).

Parity with `python/ray/serve/_private/controller.py:91` +
`deployment_state.py` (replica state machine: start/stop/health/rolling
update) + `autoscaling_state.py` (metrics-driven scaling), collapsed into one
reconcile loop. Routers learn replica sets by versioned polling (the
long-poll host role, `_private/long_poll.py`).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.autoscaling import (AutoscalingConfig,
                                       calculate_desired_num_replicas,
                                       desired_from_live_load)
from ray_tpu_torch.serve.replica import ReplicaActor

RECONCILE_INTERVAL_S = 0.25
HEALTH_CHECK_INTERVAL_S = 2.0
# a replica that has never answered a health check gets this long before
# an unresponsive probe is treated as death: model-serving replicas spend
# tens of seconds in __init__ (torch import, CUDA context, engine build)
# with actor calls queued behind it, and killing them mid-build just
# restarts the build forever. A provably-dead actor (ActorDiedError) is
# replaced immediately regardless.
REPLICA_INIT_GRACE_S = 120.0


class DeploymentInfo:
    def __init__(self, name: str, config: dict):
        self.name = name
        self.config = config
        self.replicas: Dict[str, Any] = {}      # tag -> handle
        self.replica_meta: Dict[str, dict] = {} # tag -> {healthy, ongoing}
        self.version = 0
        self.target_replicas = config.get("num_replicas", 1)
        self.autoscaling: Optional[AutoscalingConfig] = None
        if config.get("autoscaling_config"):
            ac = config["autoscaling_config"]
            self.autoscaling = (ac if isinstance(ac, AutoscalingConfig)
                                else AutoscalingConfig(**ac))
            self.target_replicas = self.autoscaling.min_replicas
        self._counter = 0

    def next_tag(self) -> str:
        self._counter += 1
        return f"{self.name}#{self._counter}"


def _initializing(info: DeploymentInfo) -> int:
    """Replicas inside their init grace that have not yet answered a
    health check. The autoscaler never scales below them: while a replica
    builds, every demand signal goes quiet (it publishes no load row, and
    the request that woke it waits in its actor queue, so the routers stop
    pushing their counts after 5 s), and parking it then would restart
    the cold start forever. A GPU replica's init (torch import, CUDA
    context, model build) takes tens of seconds. The JAX package's
    controller lacks this floor and parks such a replica mid-init."""
    now = time.time()
    return sum(1 for m in info.replica_meta.values()
               if not m.get("ready")
               and now - m.get("started", 0) < REPLICA_INIT_GRACE_S)


@ray_tpu_torch.remote
class ServeController:
    def __init__(self):
        self.deployments: Dict[str, DeploymentInfo] = {}
        self.routes: Dict[str, str] = {}        # route prefix -> deployment
        self.multiplexed: Dict[str, Dict[str, list]] = {}  # dep -> tag -> ids
        self._proxy = None
        self._proxy_port: Optional[int] = None
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._last_health = 0.0
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True, name="serve-reconcile")
        self._thread.start()

    # ----------------------------------------------------------------- API
    def deploy(self, name: str, config: dict):
        """Create or update (rolling) a deployment."""
        with self._lock:
            existing = self.deployments.get(name)
            if existing is not None:
                old_replicas = dict(existing.replicas)
                info = DeploymentInfo(name, config)
                info.version = existing.version + 1
                self.deployments[name] = info
                # rolling update: stop old replicas; reconcile starts new ones
                for tag, h in old_replicas.items():
                    self._stop_replica(h)
            else:
                self.deployments[name] = DeploymentInfo(name, config)
        self._reconcile_once()
        return True

    def delete_deployment(self, name: str):
        with self._lock:
            info = self.deployments.pop(name, None)
        if info:
            for h in info.replicas.values():
                self._stop_replica(h)
        return True

    def get_routing_table(self, name: str):
        with self._lock:
            info = self.deployments.get(name)
            if info is None:
                return None
            slo = info.config.get("slo_config")
            if slo is not None and not isinstance(slo, dict):
                slo = slo.to_dict()
            return {"version": info.version,
                    "replicas": {tag: h for tag, h in info.replicas.items()},
                    "models": dict(self.multiplexed.get(name, {})),
                    "slo": slo,
                    # compiled ingress: the proxies stand up a
                    # CompiledServeChain for this deployment and route
                    # warm requests over its rings (serve/compiled_chain)
                    "compiled": bool(info.config.get("compiled")),
                    "chain": info.config.get("chain_config"),
                    # lets the proxy tell a DEGRADED chain (lanes
                    # compiled over fewer replicas than intended, e.g.
                    # mid-replacement) from a settled one and poll fast
                    # until the lanes re-spread
                    "target_replicas": info.target_replicas}

    # ------------------------------------------------------- routes / proxy
    def set_route(self, route_prefix: str, deployment_name: str):
        with self._lock:
            self.routes[route_prefix] = deployment_name
        return True

    def get_routes(self) -> Dict[str, str]:
        with self._lock:
            return dict(self.routes)

    def record_multiplexed_models(self, deployment: str, tag: str, ids: list):
        with self._lock:
            self.multiplexed.setdefault(deployment, {})[tag] = list(ids)
        return True

    def ensure_proxy(self, host: str = "127.0.0.1", port: int = 0) -> int:
        """Start (or return) the HTTP ingress proxy; returns its port."""
        with self._lock:
            if self._proxy_port is not None:
                return self._proxy_port
        from ray_tpu_torch.serve.proxy import ProxyActor

        # handle to ourselves, resolvable from any process
        self_handle = ray_tpu_torch.get_actor("serve-controller")
        proxy = ProxyActor.options(
            name="serve-proxy", get_if_exists=True, max_concurrency=64,
            num_cpus=0).remote(self_handle)
        proxy_port = ray_tpu_torch.get(proxy.start.remote(host, port), timeout=60)
        with self._lock:
            self._proxy = proxy
            self._proxy_port = proxy_port
        return proxy_port

    def list_deployments(self):
        with self._lock:
            return {name: {"target": d.target_replicas,
                           "running": len(d.replicas),
                           "version": d.version}
                    for name, d in self.deployments.items()}

    def record_handle_metrics(self, name: str, ongoing: int):
        """Routers push their in-flight counts (autoscaling input)."""
        with self._lock:
            info = self.deployments.get(name)
            if info is not None:
                info.config.setdefault("_handle_metrics", {})["driver"] = (
                    ongoing, time.time())
        return True

    def shutdown_serve(self):
        self._stop.set()
        with self._lock:
            deployments = list(self.deployments.values())
            self.deployments = {}
            self.routes = {}
            proxy, self._proxy, self._proxy_port = self._proxy, None, None
        if proxy is not None:
            try:
                ray_tpu_torch.get(proxy.stop.remote(), timeout=10)
                ray_tpu_torch.kill(proxy)
            except Exception:
                pass
        for info in deployments:
            for h in info.replicas.values():
                self._stop_replica(h)
        return True

    # ------------------------------------------------------------ reconcile
    def _reconcile_loop(self):
        while not self._stop.wait(RECONCILE_INTERVAL_S):
            try:
                self._reconcile_once()
            except Exception:
                traceback.print_exc()

    def _reconcile_once(self):
        with self._lock:
            infos = list(self.deployments.values())
        for info in infos:
            self._autoscale(info)
            self._scale_to_target(info)
        if time.monotonic() - self._last_health > HEALTH_CHECK_INTERVAL_S:
            self._last_health = time.monotonic()
            for info in infos:
                self._health_check(info)

    def _scale_to_target(self, info: DeploymentInfo):
        with self._lock:
            current = len(info.replicas)
            delta = info.target_replicas - current
            if delta > 0:
                for _ in range(delta):
                    self._start_replica(info)
            elif delta < 0:
                for tag in list(info.replicas)[:(-delta)]:
                    h = info.replicas.pop(tag)
                    info.replica_meta.pop(tag, None)
                    info.version += 1
                    self._stop_replica(h)

    def _start_replica(self, info: DeploymentInfo):
        cfg = info.config
        tag = info.next_tag()
        opts = dict(cfg.get("ray_actor_options") or {})
        opts.setdefault("num_cpus", 0)
        opts["max_concurrency"] = cfg.get("max_ongoing_requests", 8)
        handle = ReplicaActor.options(**opts).remote(
            info.name, tag, cfg["callable"], cfg.get("init_args"),
            cfg.get("init_kwargs"), cfg.get("user_config"),
            visible_devices=cfg.get("visible_devices"))
        info.replicas[tag] = handle
        info.replica_meta[tag] = {"healthy": True, "started": time.time()}
        info.version += 1

    def _stop_replica(self, handle):
        def _drain_and_kill():
            try:
                ray_tpu_torch.get(handle.prepare_for_shutdown.remote(), timeout=10)
            except Exception:
                pass
            try:
                ray_tpu_torch.kill(handle)
            except Exception:
                pass

        threading.Thread(target=_drain_and_kill, daemon=True).start()

    def _health_check(self, info: DeploymentInfo):
        from ray_tpu_torch.core.exceptions import ActorDiedError

        dead = []
        with self._lock:
            replicas = dict(info.replicas)
        for tag, h in replicas.items():
            try:
                status = ray_tpu_torch.get(h.check_health.remote(), timeout=10)
                if not status["healthy"]:
                    dead.append(tag)
                else:
                    with self._lock:
                        info.replica_meta[tag] = {**info.replica_meta.get(tag, {}),
                                                  "ongoing": status["ongoing"],
                                                  "ready": True}
            except Exception as e:
                with self._lock:
                    meta = info.replica_meta.get(tag, {})
                if (not meta.get("ready")
                        and not isinstance(e, ActorDiedError)
                        and time.time() - meta.get("started", 0)
                        < REPLICA_INIT_GRACE_S):
                    # probe timed out but the replica is still in its init
                    # window (probes queue behind a long __init__): give it
                    # the grace period before declaring death
                    continue
                dead.append(tag)
        if dead:
            with self._lock:
                for tag in dead:
                    h = info.replicas.pop(tag, None)
                    info.replica_meta.pop(tag, None)
                    info.version += 1
                    if h is not None:
                        try:
                            ray_tpu_torch.kill(h)
                        except Exception:
                            pass
            # reconcile will start replacements (reference deployment_state
            # replica-died path)

    def _autoscale(self, info: DeploymentInfo):
        if info.autoscaling is None:
            return
        # primary signal: the gossiped live-load rows (queue depth + EWMA
        # latency via state.list_serve_stats) — scale-up reacts at gossip
        # latency instead of the health-check poll cadence. Controller-
        # polled counts stay as the fallback when the signal plane is
        # cold/stale (fresh deployment, head restart, idle).
        desired = None
        rows = self._live_serve_rows().get(info.name, {})
        if rows:
            with self._lock:
                live = [r for tag, r in rows.items() if tag in info.replicas]
                current = max(len(info.replicas), 1)
            desired = desired_from_live_load(info.autoscaling, live, current)
        if desired is not None:
            with self._lock:
                info.target_replicas = max(desired, _initializing(info))
            return
        with self._lock:
            ongoing = sum(m.get("ongoing", 0)
                          for m in info.replica_meta.values())
            hm = info.config.get("_handle_metrics", {})
            for _, (count, ts) in hm.items():
                if time.time() - ts < 5.0:
                    ongoing = max(ongoing, count)
            desired = calculate_desired_num_replicas(
                info.autoscaling, ongoing, max(len(info.replicas), 1))
            info.target_replicas = max(desired, _initializing(info))

    def _live_serve_rows(self) -> dict:
        """{deployment: {tag: load_row}} from the shared live-signal
        cache; {} when the telemetry plane is unreachable."""
        try:
            from ray_tpu_torch.serve import live_signals

            cache = live_signals.get_cache()
            cache.refresh()
            return cache.snapshot()
        except Exception:
            return {}
