"""TrainController: the state machine driving a training run (counterpart
of `ray_tpu/train/controller.py`; it imports no torch).

Parity with `python/ray/train/v2/_internal/execution/controller/
controller.py:93` (states Initializing/Scheduling/Running/Restarting/Errored/
Finished; poll loop; whole-group restart per FailurePolicy). Runs as an actor
spawned by the trainer (reference spawns a detached controller,
data_parallel_trainer.py:207).

Elastic fault tolerance (ROADMAP item 5): the controller subscribes to the
head's death-event plane (actor_state / node_state pubsub — the push side
of the flight-recorder lease-event stream), so a daemon or worker kill
interrupts the run in event time instead of at the next poll timeout. The
dead gang is fenced by the cluster epoch + a per-start generation, the next
group is sized to the SURVIVING capacity (min_workers..num_workers), the
run resumes from the latest checkpoint (resharded to the new world size by
`train/spmd.py restore_state_sharded`), and a capacity watcher grows the
group back to num_workers at the next checkpoint boundary once the lost
capacity returns.

A TPU slice (`ScalingConfig.topology`, which the JAX package reserves
through `util.accelerators.reserve_tpu_slice`) is refused with
NotImplementedError until that module is ported (ROADMAP item 21).
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (ElasticConfig, FailureConfig,
                                        RunConfig, ScalingConfig)
from ray_tpu_torch.train.worker_group import WorkerGroup

POLL_INTERVAL_S = 0.2


def _pipeline_cpus(datasets: Dict[str, Any]) -> tuple:
    """The CPUs the datasets' pipelines need beside the gang, from their
    plans: (a slot for the task stages, the actor-pool stages' CPUs a
    worker). Each worker streams every dataset itself (`DatasetShard`
    keeps the global batches whole). A task stage's tasks ask the
    runtime's task default, one at a time suffices to make progress, and
    all the pipelines queue on one slot; an actor-pool stage holds
    `concurrency` actors for the pipeline's life, each with the actor
    default, which is 0 CPUs."""
    from ray_tpu_torch.core.api import (DEFAULT_ACTOR_OPTIONS,
                                        DEFAULT_TASK_OPTIONS)

    slot = per_worker = 0.0
    for ds in datasets.values():
        segments = getattr(ds, "_segments", None)
        if segments is None:
            continue
        for kind, seg in segments():
            if kind == "tasks":
                slot = max(slot, DEFAULT_TASK_OPTIONS["num_cpus"])
            else:
                per_worker += (seg.concurrency
                               * DEFAULT_ACTOR_OPTIONS["num_cpus"])
    return slot, per_worker


class TrainControllerLogic:
    """The controller loop, actor-hostable (see TrainControllerActor)."""

    def __init__(self, train_fn: Callable, train_config: Any,
                 scaling_config: ScalingConfig, run_config: RunConfig,
                 backend=None, resume_from: Optional[str] = None,
                 datasets: Optional[dict] = None):
        self.train_fn = train_fn
        self.train_config = train_config
        self.scaling = scaling_config
        self.run_config = run_config
        self.backend = backend
        # trainer datasets: re-sharded per generation (ingest.py), so an
        # elastic resize re-splits the stream over the surviving gang
        self.datasets = datasets or {}
        self.state = "INITIALIZING"
        self.failure_config = run_config.failure_config or FailureConfig()
        self.elastic: ElasticConfig = scaling_config.elastic_config()
        self.ckpt_manager = CheckpointManager(
            run_config.resolved_storage_path(),
            run_config.checkpoint_config)
        self.resume_from = resume_from
        self.latest_metrics: Dict[int, dict] = {}
        self.failures = 0
        self.resizes = 0
        self.fenced_restarts = 0
        self.generation = 0
        self._run_name = run_config.name or "train_run"
        # death watch state (armed per worker group)
        self._group_death = threading.Event()
        self._death_cause: Optional[str] = None
        self._watch: List[tuple] = []
        self._group_epoch: Optional[int] = None
        self._stop_for_resize = False
        self._resize_target: Optional[int] = None
        # per group: each rank's reports so far, and the checkpoints that
        # wait for every rank to report their step (`_drain`)
        self._reported: List[int] = []
        self._pending: Dict[int, tuple] = {}

    # -------------------------------------------------------- event surface
    def _client(self):
        from ray_tpu_torch.core.api import _global_client, is_initialized

        if not is_initialized():
            return None
        try:
            return _global_client()
        except Exception:
            return None

    def _emit_event(self, phase: str, t0: Optional[float] = None,
                    t1: Optional[float] = None, **detail) -> None:
        """Record a controller lifecycle phase in the head's merged
        flight-recorder stream (rendered by `ray_tpu_torch.timeline()`
        alongside the reconcile windows). Best-effort: telemetry never
        fails a run."""
        client = self._client()
        if client is None:
            return
        try:
            client.head_request("train_event", run=self._run_name,
                                phase=phase, t0=t0, t1=t1,
                                detail=detail or None)
        except Exception:
            pass

    def _arm_death_watch(self, group: WorkerGroup) -> None:
        """Subscribe to actor/node death events for this gang's members.
        A match fails the group immediately — the poll loop's Event wait
        wakes in event time, not after a poll RPC times out against a
        dead peer."""
        self._group_death.clear()
        self._death_cause = None
        client = self._client()
        if client is None:
            return
        from ray_tpu_torch.core.ids import ActorID, NodeID

        actor_ids = set(group.actor_ids)
        node_ids = set(group.node_ids)

        def on_actor(msg):
            try:
                if msg.get("state") != "DEAD":
                    return
                aid = ActorID(msg["actor_id"]).hex()
                if aid in actor_ids:
                    self._death_cause = (
                        f"train worker actor {aid[:12]} died"
                        f" ({msg.get('cause') or 'no cause reported'})")
                    self._group_death.set()
            except Exception:
                pass

        def on_node(msg):
            try:
                if msg.get("state") != "DEAD":
                    return
                nid = msg["node_id"]
                nid = (NodeID(nid).hex()
                       if isinstance(nid, (bytes, bytearray)) else str(nid))
                if nid in node_ids:
                    self._death_cause = (
                        f"node {nid[:12]} hosting train worker(s) died")
                    self._group_death.set()
            except Exception:
                pass

        client.subscribe_channel("actor_state", on_actor)
        client.subscribe_channel("node_state", on_node)
        self._watch = [("actor_state", on_actor), ("node_state", on_node)]

    def _disarm_death_watch(self) -> None:
        client = self._client()
        if client is not None:
            for channel, cb in self._watch:
                try:
                    client.unsubscribe_channel(channel, cb)
                except Exception:
                    pass
        self._watch = []

    # ----------------------------------------------------------- scheduling
    def _capacity_fit(self, extra: int = 0,
                      unknown: Optional[int] = None) -> int:
        """How many workers the cluster can hold right now (capped at
        num_workers). `extra` counts workers whose resources are already
        claimed by a running group of ours (they free on restart).

        `unknown` is returned when capacity cannot be read (no client /
        head unreachable). Callers must pick the SAFE direction: the
        scheduler path defaults to optimistic (try the full ask and let
        group.start surface the real failure) — the capacity watcher
        must pass the current size instead, or a head blip would tear
        down a healthy shrunken gang for a phantom regrow.

        A run fed by datasets keeps its pipelines' CPUs out of the count
        (`_pipeline_cpus`): a gang that took them would starve the
        pipelines and hang (a 2 -> 1 shrink onto a surviving node of 2
        CPUs would count both)."""
        if unknown is None:
            unknown = self.scaling.num_workers
        client = self._client()
        if client is None:
            return unknown
        try:
            info = client.head_request("cluster_info")
            avail = dict(info.get("available_resources", {}))
        except Exception:
            return unknown
        per = self.scaling.worker_resources()
        if self.datasets:
            slot, per_worker = _pipeline_cpus(self.datasets)
            avail["CPU"] = avail.get("CPU", 0) - slot
            per["CPU"] = per.get("CPU", 0) + per_worker
        fit = self.scaling.num_workers
        for r, v in per.items():
            if v > 0:
                fit = min(fit, int(avail.get(r, 0) // v))
        return min(fit + extra, self.scaling.num_workers)

    def _elastic_size(self) -> int:
        """Elastic resize decision (reference scaling_policy): fit the
        group to what the cluster can actually hold right now, within
        [min_workers, num_workers]. Waits (bounded by the elastic
        policy's schedule_wait_s) for min_workers' worth of resources
        before giving up to the normal failure path.

        A restart triggered by the capacity watcher aims for the
        watcher's observed target, not just min_workers: the previous
        gang's resources release asynchronously after shutdown, and
        grabbing the first min_workers-sized window would restart SMALL
        again — an endless stop/restart churn instead of one regrow."""
        want = self.scaling.num_workers
        lo = self.scaling.min_workers
        if not lo or lo >= want:
            return want
        goal = max(self._resize_target or 0, lo)
        deadline = time.time() + self.elastic.schedule_wait_s
        while True:
            fit = self._capacity_fit()
            if fit >= goal:
                self._resize_target = None
                return min(max(fit, lo), want)
            if time.time() > deadline:
                self._resize_target = None
                # give up on the goal; take anything satisfying the range
                return min(max(fit, lo), want)
            time.sleep(0.2)

    def _build_group(self) -> WorkerGroup:
        if self.scaling.topology:
            raise NotImplementedError(
                f"ScalingConfig.topology={self.scaling.topology!r} asks for "
                f"a TPU slice; reserving one (util.accelerators."
                f"reserve_tpu_slice) is not ported yet (ROADMAP item 21)")
        scaling = self.scaling
        size = self._elastic_size()
        if size != scaling.num_workers:
            import dataclasses as _dc

            scaling = _dc.replace(scaling, num_workers=size)
            self.state = "RESIZING"
        self.current_world_size = size
        return WorkerGroup(scaling, generation=self.generation,
                           run_name=self._run_name)

    def _resume_checkpoint(self) -> Optional[Checkpoint]:
        # the run's OWN latest checkpoint wins over the user-supplied
        # resume_from: after the first intra-run checkpoint, an elastic
        # restart/resize must continue from where the run got to, not
        # rewind to where it started
        latest = self.ckpt_manager.latest_checkpoint()
        if latest is not None:
            return latest
        if self.resume_from:
            return Checkpoint(self.resume_from)
        return None

    # ------------------------------------------------------------ main loop
    def run(self) -> dict:
        """Blocking run; returns a plain-dict Result."""
        try:
            return self._run_loop()
        finally:
            self._disarm_death_watch()

    def _run_loop(self) -> dict:
        error: Optional[str] = None
        while True:
            self.state = "SCHEDULING"
            t_sched = time.time()
            group = self._build_group()
            client = self._client()
            self._group_epoch = (client.cluster_epoch
                                 if client is not None else None)
            resume = self._resume_checkpoint()
            try:
                group.start(self.train_fn, self.train_config,
                            resume_checkpoint=resume,
                            backend=self.backend, datasets=self.datasets)
            except RayTpuError:
                # a worker died mid-start (e.g. host failure racing the gang
                # launch): retryable, same as a failure observed while polling
                self._last_error = traceback.format_exc()
                group.shutdown()
                outcome = "failed"
            except Exception:
                error = traceback.format_exc()
                self.state = "ERRORED"
                group.shutdown()
                break
            else:
                self._arm_death_watch(group)
                self._emit_event(
                    "group_start", t0=t_sched, t1=time.time(),
                    world=self.current_world_size, generation=self.generation,
                    resumed_from=resume.path if resume else None)
                self.state = "RUNNING"
                try:
                    outcome = self._poll_until_done(group)
                finally:
                    self._disarm_death_watch()
                group.shutdown()
            if outcome == "finished":
                self.state = "FINISHED"
                break
            if outcome == "resized":
                # graceful stop at a checkpoint boundary so the next
                # generation starts bigger — not a failure
                self.resizes += 1
                self.generation += 1
                self._emit_event("resize", world_from=self.current_world_size)
                self.state = "RESIZING"
                continue
            # a failure or fence aborts any in-flight resize: its capacity
            # target may have died with the group
            self._resize_target = None
            if outcome == "fenced":
                # the cluster epoch advanced under the group (head
                # restart / reconciliation): its grants are stale. This
                # is environmental — budgeted separately from training
                # failures.
                self.fenced_restarts += 1
                self.generation += 1
                self._emit_event("fenced", epoch=self._group_epoch)
                if self.fenced_restarts > self.elastic.max_fenced_restarts:
                    error = (self._last_error
                             or "fenced-restart budget exhausted")
                    self.state = "ERRORED"
                    break
                self.state = "RESTARTING"
                continue
            # worker failure: whole-group restart (reference FailurePolicy
            # RETRY semantics, failure_handling/default.py)
            self._emit_event("death_detected", cause=self._last_error,
                             world=self.current_world_size)
            self.failures += 1
            self.generation += 1
            if self.failures > self.failure_config.max_failures:
                error = self._last_error or "train worker group failed"
                self.state = "ERRORED"
                break
            self.state = "RESTARTING"
        best = self.ckpt_manager.best_checkpoint()
        return {
            "state": self.state,
            "metrics": self.latest_metrics.get(0, {}),
            "all_rank_metrics": self.latest_metrics,
            "checkpoint_path": best.path if best else None,
            "storage_path": self.ckpt_manager.storage_path,
            "error": error,
            "restarts": self.failures,
            "resizes": self.resizes,
            "fenced_restarts": self.fenced_restarts,
            "final_world_size": getattr(self, "current_world_size", None),
        }

    _last_error: Optional[str] = None

    def _drain(self, statuses: List[dict], group: WorkerGroup
               ) -> Optional[str]:
        """Fold poll statuses into run state; returns an error string on
        worker failure.

        A checkpoint enters the run's storage only once every rank of the
        group has reported the step it came with (each rank's k-th report
        of a group is step k; the reference joins the workers' k-th
        reports into one result likewise). Committed at rank 0's report
        alone, a step a peer never finished would be resumed past, and
        the peer's share of its batch skipped. A clean finish commits
        what is left (`_commit`); a failure drops it.

        Fencing note: checkpoints enter the run's storage ONLY here —
        the controller registers what it drains from the group it is
        polling, and it never polls a fenced gang again, so a zombie
        member's checkpoints die in its tempdir. The generation tag on
        each status keeps that invariant explicit (and guards any future
        caller that polls across generations); with the current
        one-group-at-a-time polling it cannot actually mismatch."""
        error = None
        for rank, st in enumerate(statuses):
            if st.get("generation", group.generation) != group.generation:
                continue
            for rep in st["reports"]:
                self.latest_metrics[rank] = rep["metrics"]
                if rep["checkpoint_path"]:
                    self._pending[self._reported[rank]] = (
                        Checkpoint(rep["checkpoint_path"]), rep["metrics"])
                self._reported[rank] += 1
            if st["error"] and error is None:
                error = st["error"]
        self._commit(min(self._reported, default=0))
        return error

    def _new_group_reports(self, n: int) -> None:
        """Count each of the n ranks' reports from 0, with no checkpoint
        waiting on a rank."""
        self._reported = [0] * n
        self._pending = {}

    def _commit(self, upto: Optional[int]) -> None:
        """Register the waiting checkpoints of the steps below `upto`
        (every one when None), oldest first."""
        for step in sorted(self._pending):
            if upto is None or step < upto:
                ckpt, metrics = self._pending.pop(step)
                self.ckpt_manager.register(ckpt, metrics)

    def _poll_until_done(self, group: WorkerGroup) -> str:
        client = self._client()
        last_capacity_check = time.monotonic()
        stop_requested_at: Optional[float] = None
        self._stop_for_resize = False
        self._new_group_reports(len(group.workers))
        while True:
            # fast path: a death event already fired — fail without
            # waiting for a poll RPC against a dead peer to time out
            if self._group_death.is_set():
                try:
                    self._drain(group.poll(), group)
                except Exception:
                    pass
                self._last_error = self._death_cause or "worker death event"
                # a gang already stopping for a resize dies as PART of the
                # stop (ranks leave the collective at different reports;
                # a straggler's failed allreduce must not burn the
                # failure budget) — the restart was decided either way
                return "resized" if self._stop_for_resize else "failed"
            if (client is not None and self._group_epoch is not None
                    and client.cluster_epoch != self._group_epoch):
                self._last_error = (
                    f"cluster epoch advanced ({self._group_epoch} -> "
                    f"{client.cluster_epoch}); worker group fenced")
                return "fenced"
            try:
                statuses = group.poll()
            except RayTpuError:
                self._last_error = (self._death_cause
                                    or "worker died (actor unreachable)")
                return "resized" if self._stop_for_resize else "failed"
            err = self._drain(statuses, group)
            if err is not None:
                self._last_error = err
                # a worker erroring mid-resize-stop (e.g. its peer left
                # the collective first) is part of the stop, not a
                # training failure
                return "resized" if self._stop_for_resize else "failed"
            if all(st["done"] for st in statuses):
                if self._stop_for_resize:
                    return "resized"
                self._commit(None)
                return "finished"
            now = time.monotonic()
            if self._stop_for_resize:
                if now - stop_requested_at > self.elastic.resize_grace_s:
                    # a worker is ignoring the stop request; resize anyway
                    # from the latest registered checkpoint
                    return "resized"
            elif (self.scaling.is_elastic and self.elastic.regrow
                    and self.current_world_size < self.scaling.num_workers
                    and now - last_capacity_check
                    >= self.elastic.scale_up_check_interval_s):
                # capacity watcher: running shrunken — when the cluster can
                # hold a bigger gang again, stop gracefully at the next
                # checkpoint boundary and restart at the larger size
                last_capacity_check = now
                fit = self._capacity_fit(extra=self.current_world_size,
                                         unknown=self.current_world_size)
                if fit > self.current_world_size:
                    self._stop_for_resize = True
                    self._resize_target = fit
                    stop_requested_at = now
                    self._emit_event("resize_request",
                                     world_from=self.current_world_size,
                                     world_to=fit)
                    group.request_stop_all()
            self._group_death.wait(POLL_INTERVAL_S)


@ray_tpu_torch.remote
class TrainControllerActor:
    """Actor wrapper so the run survives the driver's call stack (reference
    detached TrainController)."""

    def run(self, train_fn, train_config, scaling_config, run_config,
            backend=None, resume_from=None, datasets=None):
        logic = TrainControllerLogic(train_fn, train_config, scaling_config,
                                     run_config, backend=backend,
                                     resume_from=resume_from,
                                     datasets=datasets)
        return logic.run()
