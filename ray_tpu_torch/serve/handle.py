"""DeploymentHandle + client-side router (power-of-two-choices); the
counterpart of `ray_tpu/serve/handle.py`.

Parity with `python/ray/serve/handle.py` (DeploymentHandle/DeploymentResponse)
and `_private/router.py:368` + `request_router/pow_2_router.py`: the handle
tracks per-replica in-flight counts locally, samples two replicas and picks
the shorter queue. The queue each choice compares is the LIVE one — the
gossiped replica load rows (queue depth / EWMA latency from
`state.list_serve_stats()`, cached ~1s in serve/live_signals.py) blended
with the local in-flight counts, so a handle sees load other routers and
proxies put on a replica, not just its own.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.core.api import _global_client

ROUTING_TABLE_REFRESH_S = 1.0

import contextlib as _contextlib

_NULL_CM = _contextlib.nullcontext()


class DeploymentResponse:
    """Future-like wrapper over the result ObjectRef."""

    def __init__(self, ref):
        self._ref = ref

    def result(self, timeout: Optional[float] = None):
        return ray_tpu_torch.get(self._ref, timeout=timeout)

    @property
    def ref(self):
        return self._ref


class DeploymentHandle:
    def __init__(self, deployment_name: str, controller,
                 method_name: str = "__call__",
                 multiplexed_model_id: Optional[str] = None,
                 prefix_hint: Optional[list] = None):
        self.deployment_name = deployment_name
        self._controller = controller
        self._method_name = method_name
        self._model_id = multiplexed_model_id
        # prefix-affinity routing: the prompt's chain hashes (hex, prefix
        # order) — the pick prefers the replica whose gossiped row
        # advertises the deepest resident match (disagg decode->prefill)
        self._prefix_hint = list(prefix_hint) if prefix_hint else None
        self._table: Dict[str, Any] = {}
        self._models: Dict[str, list] = {}
        self._table_version = -1
        self._table_ts = 0.0
        self._inflight: Dict[str, int] = {}
        self._lock = threading.Lock()

    def __reduce__(self):
        # handles travel into replicas as init args (deployment
        # composition); reconstruct against the receiving process's
        # controller — locks/tables are process-local state
        return (_rebuild_handle, (self.deployment_name, self._method_name,
                                  self._model_id))

    # --------------------------------------------------------------- remote
    def options(self, method_name: Optional[str] = None,
                multiplexed_model_id: Optional[str] = None,
                prefix_hint: Optional[list] = None) -> "DeploymentHandle":
        h = DeploymentHandle(self.deployment_name, self._controller,
                             method_name or self._method_name,
                             multiplexed_model_id or self._model_id,
                             prefix_hint or self._prefix_hint)
        h._table, h._table_version = self._table, self._table_version
        h._table_ts, h._inflight = self._table_ts, self._inflight
        h._models = self._models
        h._lock = self._lock
        return h

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._submit(self._method_name, args, kwargs)

    def _submit(self, method: str, args, kwargs) -> DeploymentResponse:
        from ray_tpu_torch.util import tracing

        replica_tag, handle = self._pick_replica()
        if self._model_id:
            kwargs = {**kwargs, "_multiplexed_model_id": self._model_id}
        with self._lock:
            self._inflight[replica_tag] = self._inflight.get(replica_tag, 0) + 1
        # submission span (only when the caller traces): the replica-side
        # execute span parents to it, so handle routing decisions are
        # visible inside the request's trace
        span_cm = (tracing.start_span(
            f"serve.handle.{self.deployment_name}",
            attributes={"ray_tpu.op": "serve_handle",
                        "replica": replica_tag, "method": method})
            if tracing.is_recording() else _NULL_CM)
        with span_cm:
            ref = handle.handle_request.remote(method, args, kwargs)

        def _done():
            with self._lock:
                self._inflight[replica_tag] = max(
                    0, self._inflight.get(replica_tag, 1) - 1)

        _global_client().add_done_callback(ref, _done)
        self._maybe_push_metrics()
        return DeploymentResponse(ref)

    # --------------------------------------------------------------- router
    def _refresh_table(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._table_ts < ROUTING_TABLE_REFRESH_S:
            return
        table = ray_tpu_torch.get(self._controller.get_routing_table.remote(
            self.deployment_name), timeout=30)
        if table is None:
            raise KeyError(f"deployment {self.deployment_name!r} not found")
        with self._lock:
            self._table = table["replicas"]
            self._models = table.get("models", {})
            self._table_version = table["version"]
            self._table_ts = now
            self._inflight = {t: self._inflight.get(t, 0) for t in self._table}

    def _pick_replica(self):
        self._refresh_table()
        deadline = time.monotonic() + 30
        while not self._table:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for deployment {self.deployment_name!r}")
            time.sleep(0.1)
            self._refresh_table(force=True)
        from ray_tpu_torch.serve import live_signals

        # TTL-cached head fetch OUTSIDE the lock (it can be a round trip)
        live = live_signals.get_cache()
        try:
            live.refresh()
        except Exception:
            pass
        now = time.time()
        max_age = live_signals._flag("serve_live_signal_max_age_s", 5.0)

        with self._lock:
            tags = list(self._table)
            if self._model_id:
                # prefer replicas that already have the model loaded
                warm = [t for t in tags
                        if self._model_id in self._models.get(t, [])]
                if warm:
                    tags = warm

            def score_of(t):
                return live_signals.replica_score(
                    self._inflight.get(t, 0),
                    live.row(self.deployment_name, t), now, max_age)

            if self._prefix_hint:
                # prefix-affinity first: the replica advertising the
                # deepest resident match skips recomputing the prefix.
                # Only CURRENT route-table tags are candidates, so the
                # stale row of a departed replica can't draw traffic.
                tag = live_signals.pick_prefix_affinity(
                    tags, self._prefix_hint,
                    lambda t: live.row(self.deployment_name, t),
                    score_of, now, max_age)
                if tag is not None:
                    return tag, self._table[tag]
            # power of two choices on LIVE queue depth (gossiped rows
            # blended with local in-flight; EWMA latency breaks ties)
            tag = live_signals.pick_pow2(
                tags, score_of,
                lambda t: live_signals.ewma_of(
                    live.row(self.deployment_name, t)))
            return tag, self._table[tag]

    def _maybe_push_metrics(self):
        with self._lock:
            total = sum(self._inflight.values())
        try:
            self._controller.record_handle_metrics.remote(
                self.deployment_name, total)
        except Exception:
            pass


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return self._handle._submit(self._method, args, kwargs)


def _rebuild_handle(deployment_name: str, method_name: str,
                    model_id):
    from ray_tpu_torch import serve as _serve

    h = _serve.get_deployment_handle(deployment_name)
    if method_name != "__call__" or model_id:
        h = h.options(method_name=method_name,
                      multiplexed_model_id=model_id)
    return h
