"""Replica actor: wraps the user's deployment callable (counterpart of
`ray_tpu/serve/replica.py`).

Parity with `python/ray/serve/_private/replica.py`: runs user __init__ once,
serves requests with an ongoing-request gauge, health checks, reconfigure
with user_config, graceful drain. GPU pinning: a deployment that names
`visible_devices` pins each of its replicas to those GPUs through
CUDA_VISIBLE_DEVICES before anything in the replica touches CUDA, as the
JAX package's `visible_chips` pins TPU chips (reference `tpu.py:283-323`
set_current_process_visible_accelerator_ids). The list is per deployment;
the core assigns no device ids. This module imports no torch: only the
user's callable does.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class ReplicaActor:
    def __init__(self, deployment_name: str, replica_tag: str,
                 cls_or_fn, init_args, init_kwargs, user_config,
                 visible_devices: Optional[list] = None):
        if visible_devices:
            from ray_tpu_torch.core.resources import set_visible_devices

            set_visible_devices(visible_devices)
        self.deployment_name = deployment_name
        self.replica_tag = replica_tag
        self._ongoing = 0
        self._ongoing_lock = threading.Lock()
        self._total = 0
        self._executing = 0
        self._latency_samples = 0
        self._ewma_latency_s = 0.0
        self._healthy = True
        self._draining = False
        self._metrics = None
        if isinstance(cls_or_fn, type):
            self.callable = cls_or_fn(*(init_args or ()), **(init_kwargs or {}))
        else:
            self.callable = cls_or_fn
        if user_config is not None:
            self._apply_user_config(user_config)

    def _apply_user_config(self, user_config):
        reconfigure = getattr(self.callable, "reconfigure", None)
        if reconfigure is not None:
            reconfigure(user_config)

    # ------------------------------------------------------------- requests
    def handle_request(self, method: str, args: tuple, kwargs: dict):
        if self._draining:
            raise RuntimeError(f"replica {self.replica_tag} is draining")
        model_id = kwargs.pop("_multiplexed_model_id", None)
        with self._ongoing_lock:
            self._ongoing += 1
            self._total += 1
        # publish on ADMIT as well as completion: live-signal routing and
        # admission control read the gossiped queue depth, which must
        # rise while a burst is still executing, not after it drains
        self._publish_load(self._ewma_latency_s)
        t0 = time.perf_counter()
        try:
            from ray_tpu_torch.serve import multiplex
            from ray_tpu_torch.util import tracing

            if model_id is not None:
                multiplex._set_request_model_id(model_id)
            multiplex._replica_reporter.set(self._report_models)
            target = (self.callable if method == "__call__"
                      and not isinstance(self.callable, type)
                      and callable(self.callable)
                      else None)
            if target is None or method != "__call__":
                target = getattr(self.callable, method)
            # child of the actor-call execute span (which carried the
            # proxy's root context across the process boundary)
            with tracing.start_span(
                    "serve.replica",
                    attributes={"ray_tpu.op": "serve_replica",
                                "deployment": self.deployment_name,
                                "replica": self.replica_tag,
                                "method": method}):
                with self._ongoing_lock:
                    self._executing += 1
                try:
                    return target(*args, **kwargs)
                finally:
                    with self._ongoing_lock:
                        self._executing -= 1
        finally:
            dur = time.perf_counter() - t0
            with self._ongoing_lock:
                self._ongoing -= 1
                # EWMA over the last ~10 requests: the live-load signal
                # routers and the head watchdog read. Seeded on the first
                # completed SAMPLE (a cold burst of N concurrent firsts
                # must not seed at ~dur/N via an admissions count)
                self._latency_samples += 1
                self._ewma_latency_s = (
                    dur if self._latency_samples == 1
                    else 0.9 * self._ewma_latency_s + 0.1 * dur)
            self._publish_load(dur)

    def _publish_load(self, last_latency_s: float) -> None:
        """Queue depth / in-flight / EWMA latency, published two ways on
        the SAME existing telemetry channel (the per-process metrics
        push — zero new RPCs): gauges for `/metrics` and a workload row
        the head merges into `state.list_serve_stats()` and
        `GET /api/workloads`."""
        try:
            from ray_tpu_torch.util import metrics as m

            if self._metrics is None:
                tags = ("deployment", "replica")
                self._metrics = {
                    "queue": m.Gauge(
                        "serve_replica_queue_depth",
                        "Requests admitted to the replica and not yet "
                        "finished (executing + waiting)", tag_keys=tags),
                    "inflight": m.Gauge(
                        "serve_replica_inflight",
                        "Requests currently inside user code on the "
                        "replica", tag_keys=tags),
                }
            tags = {"deployment": self.deployment_name,
                    "replica": self.replica_tag}
            self._metrics["queue"].set(self._ongoing, tags=tags)
            self._metrics["inflight"].set(self._executing, tags=tags)
            row = {
                "deployment": self.deployment_name,
                "queue_depth": self._ongoing,
                "inflight": self._executing,
                "ewma_latency_s": round(self._ewma_latency_s, 6),
                "last_latency_s": round(last_latency_s, 6),
                "total": self._total,
            }
            # deployment-specific routing hints (e.g. a prefill replica's
            # resident-prefix hashes) ride the same gossiped row: zero
            # new channels, and routers see them exactly as fresh as the
            # load signal itself
            extra = getattr(self.callable, "live_signal_extra", None)
            if extra is not None:
                try:
                    row.update(extra() or {})
                except Exception:
                    pass
            m.publish_workload("serve_replica", self.replica_tag, row)
        except Exception:
            pass

    # -------------------------------------------------------- compiled chain
    def handle_chain(self, batch: list) -> list:
        """Compiled-chain entry (serve/compiled_chain.py): one ring entry
        carries a LIST of request values. Per-item failures come back as
        error markers — one bad request must not fail its batch
        neighbours, and an infra failure (draining replica) marks every
        item failover-eligible instead of raising out of the exec loop
        (which would wedge the chain until the driver's read times out).
        A callable exposing `batch_call` (LLMEngine servers) gets the
        whole entry at once so continuous batching applies across it."""
        from ray_tpu_torch.serve.compiled_chain import (CHAIN_ERR, infra_error,
                                                  unwrap_traced)

        if self._draining:
            return [infra_error(f"replica {self.replica_tag} is draining")
                    for _ in batch]
        # sampled requests arrive in their trace envelope: peel the W3C
        # carrier per item so the callable only ever sees plain values;
        # outputs re-wrap below with THIS stage's span context so the
        # next stage (and the final chain.deliver) parent into the same
        # trace — the compiled path's submit→stage→stage chain
        carriers = []
        peeled = []
        for v in batch:
            c, inner = unwrap_traced(v)
            carriers.append(c)
            peeled.append(inner)
        batch = peeled
        n = len(batch)
        with self._ongoing_lock:
            self._ongoing += n
            self._total += n
            self._executing += n
        t0 = time.perf_counter()
        try:
            # error markers from an UPSTREAM stage pass through untouched
            # — feeding one into this stage's callable would either
            # swallow an infra failure or re-wrap it as a user error,
            # breaking the failover contract on multi-stage chains
            from ray_tpu_torch.serve.compiled_chain import is_chain_error

            live = [(i, v) for i, v in enumerate(batch)
                    if not is_chain_error(v)]
            out = list(batch)
            bc = getattr(self.callable, "batch_call", None)
            if bc is not None:
                try:
                    results = bc([v for _i, v in live])
                    if not isinstance(results, list) \
                            or len(results) != len(live):
                        # a short/odd return must not silently leave
                        # request values in the output positions (they
                        # would be delivered to callers as results)
                        raise RuntimeError(
                            f"batch_call returned "
                            f"{len(results) if isinstance(results, list) else type(results)} "
                            f"for {len(live)} inputs")
                except Exception:
                    results = [infra_error(traceback.format_exc())
                               for _ in live]
                for (i, _v), r in zip(live, results):
                    out[i] = r
            else:
                for i, v in live:
                    try:
                        # __init__ already resolved self.callable to an
                        # instance or function; a non-callable raises
                        # into the per-item error marker
                        out[i] = self.callable(v)
                    except Exception as e:  # user error: this item only
                        out[i] = {CHAIN_ERR: repr(e), "infra": False}
            if any(c is not None for c in carriers):
                try:
                    from ray_tpu_torch.serve.compiled_chain import TracedValue
                    from ray_tpu_torch.util import tracing

                    stage_dur = time.perf_counter() - t0
                    wall_end = time.time()
                    for i, c in enumerate(carriers):
                        # error markers pass through UNwrapped: the chain
                        # client's failover check must see them directly
                        if c is None or is_chain_error(out[i]):
                            continue
                        with tracing.start_span(
                                f"chain.stage.{self.deployment_name}",
                                carrier=c,
                                attributes={"ray_tpu.op": "chain_stage",
                                            "replica": self.replica_tag,
                                            "batch": n}) as sp:
                            if sp is not None:
                                # backdate to cover the whole stage exec
                                sp.start_ts = wall_end - stage_dur
                                out[i] = TracedValue(
                                    {"traceparent": sp.traceparent()},
                                    out[i])
                except Exception:
                    pass
            return out
        finally:
            dur = time.perf_counter() - t0
            with self._ongoing_lock:
                self._ongoing -= n
                self._executing -= n
                self._latency_samples += 1
                per = dur / max(1, n)
                self._ewma_latency_s = (
                    per if self._latency_samples == 1
                    else 0.9 * self._ewma_latency_s + 0.1 * per)
            # rate-limited: the compiled hot path must not turn load
            # publishing into per-entry overhead; the gossiped row stays
            # fresh at the metrics-push cadence
            now = time.monotonic()
            if now - getattr(self, "_chain_pub_ts", 0.0) > 1.0:
                self._chain_pub_ts = now
                self._publish_load(dur)

    def _report_models(self, model_ids):
        """Push the loaded-model set so routers prefer warm replicas."""
        try:
            ctrl = ray_tpu_torch.get_actor("serve-controller")
            ctrl.record_multiplexed_models.remote(
                self.deployment_name, self.replica_tag, list(model_ids))
        except Exception:
            pass

    def loaded_model_ids(self):
        from ray_tpu_torch.serve.multiplex import loaded_model_ids_of

        return loaded_model_ids_of(self.callable)

    # -------------------------------------------------------------- control
    def reconfigure(self, user_config):
        self._apply_user_config(user_config)
        return True

    def check_health(self):
        user_check = getattr(self.callable, "check_health", None)
        if user_check is not None:
            try:
                user_check()
            except Exception:
                self._healthy = False
                return {"healthy": False, "detail": traceback.format_exc()}
        return {"healthy": True, "ongoing": self._ongoing,
                "total": self._total}

    def queue_len(self):
        return self._ongoing

    def prepare_for_shutdown(self, drain_timeout_s: float = 5.0):
        self._draining = True
        deadline = time.monotonic() + drain_timeout_s
        while self._ongoing > 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        shutdown = getattr(self.callable, "__del__", None)
        return self._ongoing == 0
