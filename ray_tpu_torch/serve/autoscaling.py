"""Serve autoscaling policy (counterpart of `ray_tpu/serve/autoscaling.py`).

Parity with `python/ray/serve/autoscaling_policy.py:13
_calculate_desired_num_replicas` + AutoscalingConfig fields
(`serve/config.py:186` target_ongoing_requests, min/max_replicas,
upscale/downscale smoothing).

`desired_from_live_load` is the serving-plane upgrade: the controller
feeds the calculation from the GOSSIPED replica load rows (queue depth +
EWMA latency via `state.list_serve_stats()`) rather than its own
health-check-polled counts, so scale-up reacts at gossip latency. It
returns None when there's no fresh signal and the caller falls back to
the polled path.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 8
    target_ongoing_requests: float = 2.0
    upscale_smoothing_factor: float = 1.0
    downscale_smoothing_factor: float = 1.0
    look_back_period_s: float = 2.0
    # live-signal knobs: a fresh gossiped row is one younger than
    # signal_staleness_s; target_latency_s > 0 additionally scales up
    # when per-replica EWMA latency exceeds the target (0 disables)
    signal_staleness_s: float = 10.0
    target_latency_s: float = 0.0


def calculate_desired_num_replicas(config: AutoscalingConfig,
                                   total_ongoing_requests: float,
                                   current_num_replicas: int) -> int:
    if current_num_replicas == 0:
        # Scale-to-zero: a parked deployment (explicit min_replicas=0)
        # stays at zero until demand shows up — the proxy pushes its
        # queue depth as ongoing requests, which wakes exactly one
        # replica; the normal error-ratio path grows it from there.
        # min_replicas>=1 keeps the historical always-on floor.
        if total_ongoing_requests > 0:
            return max(config.min_replicas, 1)
        return max(config.min_replicas, 0)
    per_replica = total_ongoing_requests / current_num_replicas
    error_ratio = per_replica / max(config.target_ongoing_requests, 1e-9)
    if error_ratio > 1:
        smoothed = 1 + (error_ratio - 1) * config.upscale_smoothing_factor
        desired = math.ceil(current_num_replicas * smoothed)
    else:
        smoothed = 1 - (1 - error_ratio) * config.downscale_smoothing_factor
        desired = math.floor(current_num_replicas * smoothed)
        desired = max(desired, 1) if total_ongoing_requests > 0 else desired
    return int(min(max(desired, config.min_replicas), config.max_replicas))


def desired_from_live_load(config: AutoscalingConfig, rows: List[dict],
                           current_num_replicas: int,
                           now: Optional[float] = None) -> Optional[int]:
    """Desired replica count from gossiped live-load rows for ONE
    deployment ({"queue_depth", "ewma_latency_s", "ts", ...} per
    replica). Queue depth drives the ongoing-requests error ratio;
    `target_latency_s` adds a proportional scale-up floor when a
    replica's PROJECTED QUEUEING WAIT (service EWMA x queued requests)
    exceeds the target (capped at 4x per pass so one bad sample can't
    explode the fleet). The boost deliberately uses projected wait, not
    raw service time: a handler whose base latency exceeds the target
    would otherwise ratchet the fleet to max_replicas and pin it there —
    more replicas can shorten queues, never the service time itself.
    Returns None when no row is fresh — rows only refresh as requests
    flow, so an idle deployment deliberately falls back to the
    controller-polled (low) counts and scales down."""
    now = time.time() if now is None else now
    fresh = [r for r in rows
             if now - (r.get("ts") or 0.0) <= config.signal_staleness_s]
    if not fresh:
        return None
    total_queue = float(sum(r.get("queue_depth") or 0 for r in fresh))
    desired = calculate_desired_num_replicas(config, total_queue,
                                             current_num_replicas)
    if config.target_latency_s > 0:
        worst = max((r.get("ewma_latency_s") or 0.0)
                    * float(r.get("queue_depth") or 0) for r in fresh)
        if worst > config.target_latency_s:
            boost = math.ceil(current_num_replicas
                              * min(worst / config.target_latency_s, 4.0))
            desired = max(desired, boost)
    return int(min(max(desired, config.min_replicas), config.max_replicas))
