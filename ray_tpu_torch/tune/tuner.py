"""Tuner + trial controller.

Parity (core subset) with `python/ray/tune/tuner.py` +
`execution/tune_controller.py`: an event loop managing trial actors (the
TrainWorker actor is reused as the trial host — same report/poll/stop
surface), searchers generating variants, schedulers deciding early stops and
PBT exploits, per-trial checkpoint tracking, ResultGrid output.

Counterpart of `ray_tpu/tune/tuner.py`. Where the JAX package starts the
trials a round admits one after another, each waiting for the last's
actor to answer, this one launches them all and then awaits each: GPU
trials' cold starts (a process, torch, the trainable's imports) overlap.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.worker_group import TrainWorker
from ray_tpu_torch.tune import schedulers as sched_lib
from ray_tpu_torch.tune.search import BasicVariantGenerator
from ray_tpu_torch.tune.searcher import Searcher

POLL_S = 0.1


@dataclasses.dataclass
class TuneConfig:
    metric: str = "loss"
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: int = 8
    scheduler: Optional[Any] = None
    seed: Optional[int] = None
    # a Searcher makes trial generation sequential-adaptive: each new
    # trial's config is suggested from live results of finished ones
    # (reference TuneConfig.search_alg)
    search_alg: Optional[Any] = None


@dataclasses.dataclass
class TrialResult:
    trial_id: str
    config: Dict[str, Any]
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    error: Optional[str]
    history: List[Dict[str, Any]]


class ResultGrid:
    def __init__(self, results: List[TrialResult], metric: str, mode: str):
        self.results = results
        self._metric = metric
        self._mode = mode

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        scored = [r for r in self.results
                  if r.error is None and metric in (r.metrics or {})]
        if not scored:
            raise ValueError("no successful trials with the target metric")
        key = lambda r: r.metrics[metric]
        return (min if mode == "min" else max)(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([
            {"trial_id": r.trial_id, **r.config, **(r.metrics or {}),
             "error": bool(r.error)} for r in self.results])

    def __len__(self):
        return len(self.results)


class _Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.id = trial_id
        self.config = config
        self.actor = None
        self.state = "PENDING"
        self.iteration = 0
        self.last_metrics: Dict[str, Any] = {}
        self.history: List[Dict[str, Any]] = []
        self.error: Optional[str] = None
        self.checkpoint_path: Optional[str] = None
        self.resume_path: Optional[str] = None


def with_resources(trainable: Callable, resources: Dict[str, float]):
    trainable._tune_resources = dict(resources)
    return trainable


class Tuner:
    def __init__(self, trainable: Callable, *, param_space: Dict[str, Any],
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self.trainable = trainable
        self.param_space = param_space
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig(name=f"tune-{uuid.uuid4().hex[:6]}")

    # ------------------------------------------------------------------ fit
    def fit(self) -> ResultGrid:
        from ray_tpu_torch.core.api import _auto_init

        _auto_init()
        storage = self.run_config.resolved_storage_path()
        os.makedirs(storage, exist_ok=True)
        scheduler = self.tune_config.scheduler or sched_lib.FIFOScheduler()
        searcher = self.tune_config.search_alg
        if searcher is not None:
            from ray_tpu_torch.tune.search import GridSearch

            grid_keys = [k for k, v in self.param_space.items()
                         if isinstance(v, GridSearch)]
            if grid_keys:
                # a searcher samples; it cannot honor exhaustive-grid
                # semantics — failing loudly beats silently skipping
                # grid values (reference raises the same way)
                raise ValueError(
                    f"grid_search params {grid_keys} cannot be combined "
                    f"with a search_alg; use tune.choice() instead")
            searcher.set_search_properties(self.tune_config.metric,
                                           self.tune_config.mode,
                                           self.param_space)
            trials: List[_Trial] = []
            pending: List[_Trial] = []
        else:
            gen = BasicVariantGenerator(self.param_space,
                                        self.tune_config.num_samples,
                                        seed=self.tune_config.seed)
            trials = [_Trial(f"trial_{i:04d}", cfg)
                      for i, cfg in enumerate(gen.variants())]
            pending = list(trials)
        running: List[_Trial] = []
        resources = getattr(self.trainable, "_tune_resources", {"CPU": 1})

        def _searcher_complete(t: "_Trial") -> None:
            if searcher is None:
                return
            try:
                searcher.on_trial_complete(
                    t.id, metrics=t.last_metrics or None,
                    error=t.state == "ERRORED")
            except Exception:
                pass

        def _start_failed(t: "_Trial", e: Exception) -> None:
            # per-trial failure: mark this trial errored, keep tuning
            t.state = "ERRORED"
            t.error = f"trial failed to start: {e!r}"
            self._stop_actor(t)
            _searcher_complete(t)

        searcher_finished = searcher is None
        while (pending or running
               or (not searcher_finished
                   and len(trials) < self.tune_config.num_samples)):
            # adaptive generation: ask the searcher for the next config
            # only when a slot opens, so suggestions see fresh completions
            while (not searcher_finished
                   and len(trials) < self.tune_config.num_samples
                   and len(running) + len(pending)
                   < self.tune_config.max_concurrent_trials):
                tid = f"trial_{len(trials):04d}"
                try:
                    cfg = searcher.suggest(tid)
                except Exception as e:
                    # a broken searcher must not abort fit() mid-run and
                    # orphan the live trial actors
                    print(f"[ray_tpu_torch.tune] searcher.suggest failed, "
                          f"stopping generation: {e!r}")
                    searcher_finished = True
                    break
                if cfg is None:
                    break  # searcher is not ready; retry next tick
                if cfg is Searcher.FINISHED or cfg == Searcher.FINISHED:
                    searcher_finished = True  # space exhausted for good
                    break
                t = _Trial(tid, cfg)
                trials.append(t)
                pending.append(t)
            # every trial a slot takes is launched before any is awaited:
            # their actors' processes start together (one wave), not one
            # cold start after another
            launched = []
            while pending and (len(running) + len(launched)
                               < self.tune_config.max_concurrent_trials):
                t = pending.pop(0)
                try:
                    launched.append((t, self._launch_trial(t, resources)))
                except Exception as e:
                    _start_failed(t, e)
            for t, started in launched:
                try:
                    self._await_trial(t, started)
                except Exception as e:
                    _start_failed(t, e)
                    continue
                running.append(t)
            time.sleep(POLL_S)
            for t in list(running):
                try:
                    st = ray_tpu_torch.get(t.actor.poll.remote(), timeout=30)
                except Exception:
                    t.state = "ERRORED"
                    t.error = "trial actor died"
                    running.remove(t)
                    self._stop_actor(t)
                    _searcher_complete(t)
                    continue
                decision = sched_lib.CONTINUE
                for rep in st["reports"]:
                    t.iteration += 1
                    metrics = dict(rep["metrics"])
                    metrics.setdefault("training_iteration", t.iteration)
                    t.last_metrics = metrics
                    t.history.append(metrics)
                    if rep["checkpoint_path"]:
                        t.checkpoint_path = rep["checkpoint_path"]
                    if searcher is not None:
                        try:
                            searcher.on_trial_result(t.id, metrics)
                        except Exception:
                            pass
                    # schedulers see the live config too (PB2's GP models
                    # config -> score improvement); user metrics stay clean.
                    # Once a batch produced a decision, trailing reports
                    # are NOT fed onward: the trial is about to stop or
                    # restart, and PB2's exploit cleanup must not be
                    # undone by stale same-batch reports.
                    if decision == sched_lib.CONTINUE:
                        d = scheduler.on_result(
                            t.id, {**metrics, "config": t.config})
                        if d != sched_lib.CONTINUE:
                            decision = d
                if st["error"]:
                    t.state = "ERRORED"
                    t.error = st["error"]
                    running.remove(t)
                    self._stop_actor(t)
                    _searcher_complete(t)
                elif st["done"]:
                    t.state = "COMPLETED"
                    running.remove(t)
                    self._stop_actor(t)
                    _searcher_complete(t)
                elif decision == sched_lib.STOP:
                    t.state = "STOPPED"
                    running.remove(t)
                    self._stop_actor(t)
                    _searcher_complete(t)
                elif isinstance(decision, tuple) and decision[0] == "EXPLOIT":
                    _, donor_id, mutate = decision
                    donor = next(d for d in trials if d.id == donor_id)
                    try:
                        self._exploit(t, donor, mutate)
                    except Exception as e:
                        t.state = "ERRORED"
                        t.error = f"exploit restart failed: {e!r}"
                        running.remove(t)
                        self._stop_actor(t)
                        _searcher_complete(t)
        results = [TrialResult(
            trial_id=t.id, config=t.config, metrics=t.last_metrics,
            checkpoint=Checkpoint(t.checkpoint_path) if t.checkpoint_path else None,
            error=t.error, history=t.history) for t in trials]
        return ResultGrid(results, self.tune_config.metric,
                          self.tune_config.mode)

    # -------------------------------------------------------------- helpers
    def _launch_trial(self, t: _Trial, resources: Dict[str, float]):
        """Create the trial's actor and ask it to start; returns the
        answer's ref, for _await_trial."""
        t.actor = TrainWorker.options(
            resources=resources, num_cpus=resources.get("CPU", 0),
            name=f"{self.run_config.name}-{t.id}-"
                 f"{uuid.uuid4().hex[:4]}").remote()
        return t.actor.setup_and_start.remote(
            self.trainable, t.config, 0, 1, 0, 0, t.resume_path, {})

    def _await_trial(self, t: _Trial, started) -> None:
        ray_tpu_torch.get(started, timeout=120)
        t.state = "RUNNING"

    def _start_trial(self, t: _Trial, resources: Dict[str, float]) -> None:
        self._await_trial(t, self._launch_trial(t, resources))

    def _stop_actor(self, t: _Trial) -> None:
        if t.actor is not None:
            try:
                ray_tpu_torch.kill(t.actor)
            except Exception:
                pass
            t.actor = None

    def _exploit(self, t: _Trial, donor: "_Trial", mutate) -> None:
        """PBT: restart `t` from donor's checkpoint with mutated config."""
        self._stop_actor(t)
        t.config = mutate(donor.config)
        t.resume_path = donor.checkpoint_path
        resources = getattr(self.trainable, "_tune_resources", {"CPU": 1})
        self._start_trial(t, resources)
