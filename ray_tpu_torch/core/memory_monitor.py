"""Memory monitor + OOM worker-killing policy.

Parity: `src/ray/common/memory_monitor.{h,cc}` + the raylet's
`worker_killing_policy_retriable_fifo.cc` — when node memory crosses the
usage threshold, kill the worker whose task is retriable and most recently
started (LIFO over retriables: the youngest work loses, maximizing saved
progress), falling back to the youngest non-retriable. The killed task
re-queues through the normal worker-death retry path.
"""

from __future__ import annotations

import os
import time
from typing import Callable, List, Optional

from ray_tpu_torch.core import config


def system_memory_fraction() -> float:
    """Fraction of system memory in use, from /proc/meminfo (cgroup-unaware
    fallback; containers with limits can point RAY_TPU_MEMINFO_PATH at a
    synthetic file or use the env override hook in tests)."""
    path = config.get("meminfo_path")
    total = avail = None
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1])
                elif line.startswith("MemAvailable:"):
                    avail = int(line.split()[1])
                if total is not None and avail is not None:
                    break
    except OSError:
        return 0.0
    if not total or avail is None:
        # missing MemAvailable must fail SAFE (0.0): treating it as 100%
        # usage would kill one worker per poll interval forever
        return 0.0
    return 1.0 - avail / total


def pick_victim(workers: List[dict]) -> Optional[dict]:
    """Choose which worker to kill. `workers`: dicts with keys
    worker_id, task_start_ts, retriable (bool), is_driver, has_actor.
    Drivers and actors are never chosen (reference: only task workers)."""
    candidates = [w for w in workers
                  if not w["is_driver"] and not w["has_actor"]
                  and w.get("task_start_ts") is not None]
    if not candidates:
        return None
    retriable = [w for w in candidates if w["retriable"]]
    pool = retriable or candidates
    return max(pool, key=lambda w: w["task_start_ts"])


class MemoryMonitor:
    """Runs inside the head's event loop; polls usage, kills one victim per
    breach interval (kill → wait → resample, avoiding kill storms)."""

    def __init__(self, head, *, threshold: float = None,
                 interval_s: float = None,
                 usage_fn: Callable[[], float] = system_memory_fraction):
        self.head = head
        self.threshold = threshold if threshold is not None else float(
            config.get("memory_usage_threshold"))
        self.interval_s = interval_s if interval_s is not None else float(
            config.get("memory_monitor_interval_s"))
        self.usage_fn = usage_fn
        self.num_kills = 0

    def check_once(self) -> Optional[bytes]:
        """One poll: returns the killed worker id (or None)."""
        usage = self.usage_fn()
        if usage < self.threshold:
            return None
        # The usage sample is this (head) node's /proc/meminfo: only workers
        # co-resident on the sampled node are valid victims — killing a
        # remote worker frees nothing here and starves real OOM detection
        # on worker nodes (reference runs the monitor per-raylet).
        views = []
        for w in self.head.workers.values():
            if w.node_id != self.head.node_id:
                continue
            rec = getattr(w, "current_record", None)
            views.append({
                "worker_id": w.worker_id,
                "is_driver": w.is_driver,
                "has_actor": w.actor_id is not None,
                "task_start_ts": getattr(rec, "dispatch_ts", None)
                if rec is not None else None,
                "retriable": (rec is not None and rec.retries_left > 0),
                "_worker": w,
            })
        victim = pick_victim(views)
        if victim is None:
            return None
        w = victim["_worker"]
        self.head._task_event(
            w.running_task or b"", "", "FAILED",
            worker=w, error=f"killed by memory monitor (usage "
                            f"{usage:.0%} >= {self.threshold:.0%})")
        self.head._terminate_worker(w)
        self.num_kills += 1
        return w.worker_id.binary()

    async def run(self) -> None:
        import asyncio

        while not self.head._shutdown:
            await asyncio.sleep(self.interval_s)
            try:
                self.check_once()
            except Exception:
                pass
