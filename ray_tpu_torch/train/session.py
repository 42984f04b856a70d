"""Per-worker training session: rank info + report(metrics, checkpoint)
(counterpart of `ray_tpu/train/session.py`, on the port's `util.metrics`
and `util.tracing`; it imports no torch).

Parity with `ray.train.report` / `ray.train.get_context`
(`python/ray/train/v2/_internal/execution/context.py` semantics): the train
function runs in a thread inside the TrainWorker actor; `report` enqueues
(metrics, checkpoint) for the controller to poll, mirroring the reference's
ReportCallbackHandler path (SURVEY §3.4).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint

_step_metrics = None


def _get_step_metrics():
    global _step_metrics
    if _step_metrics is None:
        from ray_tpu_torch.util import metrics as m

        _step_metrics = m.Histogram(
            "train_step_seconds",
            "Wall time between consecutive train.report calls (one "
            "training step) per worker", tag_keys=("run", "rank"))
    return _step_metrics


class TrainContext:
    def __init__(self, rank: int, world_size: int, local_rank: int = 0,
                 node_rank: int = 0,
                 resume_checkpoint: Optional[Checkpoint] = None,
                 dataset_shards: Optional[dict] = None, generation: int = 0,
                 run_name: Optional[str] = None):
        self.rank = rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.resume_checkpoint = resume_checkpoint
        self.dataset_shards = dataset_shards or {}
        # which (re)start of the run this gang belongs to — elastic loops
        # use it to scope collective-group names per membership change
        self.generation = generation
        self.run_name = run_name or "train"
        self.reports: List[Dict[str, Any]] = []
        self.lock = threading.Lock()
        self.stop_requested = False
        # step telemetry: the window between consecutive report() calls
        self._step_wall_t0 = time.time()
        self._step_idx = 0
        self._ewma_step_s = 0.0

    # -- user-facing API ---------------------------------------------------
    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.resume_checkpoint

    def get_generation(self) -> int:
        return self.generation

    def should_stop(self) -> bool:
        """True once the controller has requested a graceful stop (elastic
        resize at the next checkpoint boundary). Loops that checkpoint on
        their own cadence can consult this to checkpoint NOW instead of
        waiting for `report` to raise."""
        return self.stop_requested


_ctx = threading.local()


def _set_context(ctx: Optional[TrainContext]) -> None:
    _ctx.value = ctx


def get_context() -> TrainContext:
    ctx = getattr(_ctx, "value", None)
    if ctx is None:
        raise RuntimeError("not inside a train worker (no TrainContext)")
    return ctx


def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    """Report metrics (all ranks) and optionally a checkpoint (rank 0 by
    convention) to the controller. Also the step boundary for the
    workload flight recorder: the window since the previous report
    becomes a `train.step` span (joining the run's trace when the driver
    traces) and feeds `train_step_seconds` plus the gossiped live-load
    row the head's straggler watchdog reads."""
    ctx = get_context()
    now = time.time()
    step_s = max(now - ctx._step_wall_t0, 0.0)
    with ctx.lock:
        ctx.reports.append({
            "metrics": dict(metrics),
            "checkpoint_path": checkpoint.path if checkpoint else None,
        })
    if ctx._step_idx:
        # the window before the FIRST report is setup (imports, data
        # loading, compile) — seeding the EWMA with it would report a
        # wildly slow worker and false-flag stragglers for ~30 steps
        _record_step(ctx, step_s, now)
    ctx._step_wall_t0 = now
    ctx._step_idx += 1
    if ctx.stop_requested:
        raise StopIteration("training stop requested by controller")


def _record_step(ctx: TrainContext, step_s: float, now: float) -> None:
    """Step telemetry is best-effort — it must never fail a run."""
    try:
        from ray_tpu_torch.util import metrics as m
        from ray_tpu_torch.util import tracing

        ctx._ewma_step_s = (0.8 * ctx._ewma_step_s + 0.2 * step_s
                            if ctx._ewma_step_s > 0 else step_s)
        if tracing.is_recording():
            with tracing.start_span(
                    "train.step",
                    attributes={"ray_tpu.op": "train_step",
                                "run": ctx.run_name, "rank": ctx.rank,
                                "step": ctx._step_idx}) as sp:
                if sp is not None:
                    sp.start_ts = now - step_s
        _get_step_metrics().observe(
            step_s, tags={"run": ctx.run_name, "rank": str(ctx.rank)})
        m.publish_workload(
            "train_worker", f"{ctx.run_name}:rank{ctx.rank}", {
                "run": ctx.run_name, "rank": ctx.rank,
                "world_size": ctx.world_size,
                "generation": ctx.generation,
                "step": ctx._step_idx,
                "last_step_s": round(step_s, 6),
                "ewma_step_s": round(ctx._ewma_step_s, 6),
                "steps_per_s": round(1.0 / ctx._ewma_step_s, 4)
                if ctx._ewma_step_s > 0 else None,
            })
    except Exception:
        pass


def get_dataset_shard(name: str = "train"):
    """This worker's streaming shard of a dataset passed to the trainer
    (reference `ray.train.get_dataset_shard`)."""
    ctx = get_context()
    shard = ctx.dataset_shards.get(name)
    if shard is None:
        raise KeyError(f"no dataset shard named {name!r}")
    return shard
