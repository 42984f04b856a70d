"""Tune in the port (`ray_tpu_torch.tune`) against the JAX package's.

- Parity, bit for bit (both are Python and numpy): the variant generator,
  the schedulers' decisions (ASHA, the median rule, PBT and PB2, PBT's and
  PB2's mutated configs included) fed one stream of results, and the
  seeded searchers' suggestions (random, BayesOpt, BOHB) fed the same
  completions.
- Mirrors of `tests/test_tune.py` on the port's runtime: the grid, ASHA,
  PBT's exploit, the searcher seam, the gated hyperopt import, FINISHED
  and grid-with-searcher, PB2, BayesOpt, BOHB. The reference's ASHA test
  sleeps to let the scheduler see results; its mirror paces each trial on
  the scheduler's own judgement instead (`AckScheduler`) and asserts the
  decisions.
- Fractions of a GPU: on a node advertising one GPU, two leases of 0.5
  are granted at once and a third waits; two 0.5-GPU trials run at once.

Trainables run in trial processes from `tests/_torch_tune_loops.py`
(no JAX). Needs no card.
"""

import os
import random
import time

import numpy as np
import pytest

import _torch_tune_loops as loops
import ray_tpu_torch
from ray_tpu import tune as jtune
from ray_tpu.tune import schedulers as jsched
from ray_tpu_torch import tune
from ray_tpu_torch.train import RunConfig
from ray_tpu_torch.tune import (ASHAScheduler, PopulationBasedTraining,
                                TuneConfig, Tuner, with_resources)
from ray_tpu_torch.tune import schedulers as psched
from ray_tpu_torch.tune.search import BasicVariantGenerator


@pytest.fixture(scope="module")
def cluster():
    # one GPU advertised for the fractional leases; nothing here asks a
    # trial for a device
    info = ray_tpu_torch.init(num_cpus=8, num_gpus=1, max_workers=16)
    yield info
    ray_tpu_torch.shutdown()


def _space(t):
    return {"a": t.grid_search([1, 2, 3]), "lr": t.loguniform(1e-5, 1e-1),
            "u": t.uniform(-1.0, 1.0), "n": t.randint(1, 9),
            "act": t.choice(["relu", "gelu", "tanh"]), "c": "fixed"}


# ------------------------------------------------------------- parity
def test_variants_match_jax():
    want = list(jtune.BasicVariantGenerator(_space(jtune), num_samples=3,
                                            seed=7).variants())
    got = list(BasicVariantGenerator(_space(tune), num_samples=3,
                                     seed=7).variants())
    assert got == want and len(got) == 9


def _stream(n_trials=6, steps=12, seed=0):
    """(trial_id, result) pairs in a shuffled arrival order, each trial's
    steps in order."""
    rng = np.random.default_rng(seed)
    quality = rng.uniform(0, 5, n_trials)
    per = {f"t{i}": [{"training_iteration": s,
                      "loss": float(quality[i] + 10.0 / s
                                    + 0.1 * rng.standard_normal()),
                      "score": float(-quality[i] + 0.3 * s
                                     + 0.1 * rng.standard_normal()),
                      "config": {"lr": float(quality[i] / 5)}}
                     for s in range(1, steps + 1)]
           for i in range(n_trials)}
    order = [t for t in per for _ in range(steps)]
    rng.shuffle(order)
    cursor = {t: 0 for t in per}
    for t in order:
        yield t, per[t][cursor[t]]
        cursor[t] += 1


def _decisions(sched, stream):
    out = []
    for tid, res in stream:
        d = sched.on_result(tid, dict(res))
        if isinstance(d, tuple):
            # the exploit's donor, and the config its mutation draws
            d = (d[0], d[1], d[2]({"lr": 0.3, "keep": 1}))
        out.append(d)
    return out


SCHEDULERS = {
    "asha": lambda m: m.ASHAScheduler(metric="loss", mode="min", max_t=10,
                                      grace_period=1, reduction_factor=2),
    "median": lambda m: m.MedianStoppingRule(metric="loss", mode="min",
                                             grace_period=2),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 0.2, 0.4], "keep": lambda: 5},
        seed=3),
    "pb2": lambda m: m.PB2(metric="score", mode="max",
                           perturbation_interval=2,
                           hyperparam_bounds={"lr": (0.0, 1.0)}, seed=3),
}


@pytest.mark.parametrize("kind", list(SCHEDULERS))
def test_scheduler_decisions_match_jax(kind):
    want = _decisions(SCHEDULERS[kind](jsched), _stream())
    got = _decisions(SCHEDULERS[kind](psched), _stream())
    assert got == want
    # the stream exercises the decisions, not just CONTINUE
    assert any(d != "CONTINUE" for d in got)


def _searchers(t, kind):
    return {"random": lambda: t.RandomSearcher(seed=5),
            "bayesopt": lambda: t.BayesOptSearch(n_initial_points=3, seed=5,
                                                 n_candidates=64),
            "bohb": lambda: t.BOHBSearch(min_points_in_model=3, seed=5,
                                         n_candidates=32)}[kind]()


@pytest.mark.parametrize("kind", ["random", "bayesopt", "bohb"])
def test_searcher_suggestions_match_jax(kind):
    def run(t):
        s = _searchers(t, kind)
        space = {"x": t.uniform(0.0, 5.0), "lr": t.loguniform(1e-4, 1e-1),
                 "n": t.randint(1, 9), "act": t.choice(["a", "b"]), "c": 1}
        s.set_search_properties("score", "min", space)
        out = []
        for i in range(10):
            cfg = s.suggest(f"t{i}")
            out.append(cfg)
            s.on_trial_complete(f"t{i}", {"score": (cfg["x"] - 3) ** 2
                                          + cfg["n"] * 0.01}, error=False)
        return out

    assert run(tune) == run(jtune)


# ------------------------------------------------ mirrors of test_tune.py
def test_variant_generator():
    gen = BasicVariantGenerator(
        {"a": tune.grid_search([1, 2, 3]), "b": tune.choice([10]),
         "c": "fixed"},
        num_samples=2, seed=0)
    variants = list(gen.variants())
    assert len(variants) == 6
    assert {v["a"] for v in variants} == {1, 2, 3}
    assert all(v["b"] == 10 and v["c"] == "fixed" for v in variants)


def test_tuner_grid(cluster, tmp_path):
    tuner = Tuner(
        loops.objective,
        param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
        tune_config=TuneConfig(metric="score", mode="min", num_samples=1),
        run_config=RunConfig(name="grid", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 5
    best = grid.get_best_result()
    assert best.config["x"] == 3
    assert best.metrics["score"] == pytest.approx(0.0, abs=0.2)
    try:
        import pandas  # noqa: F401
    except ImportError:
        return
    assert len(grid.get_dataframe()) == 5


class AckScheduler:
    """A scheduler that records its inner scheduler's decisions and, once
    it has judged a report, writes the file the trial waits on."""

    def __init__(self, inner, ack_dir):
        self.inner, self.ack_dir, self.log = inner, ack_dir, []

    def on_result(self, trial_id, result):
        d = self.inner.on_result(trial_id, result)
        q, t = result["config"]["quality"], result["training_iteration"]
        self.log.append((q, t, d))
        open(os.path.join(self.ack_dir, f"{q}_{t}"), "w").close()
        return d


def test_asha_stops_bad_trials(cluster, tmp_path):
    sched = AckScheduler(ASHAScheduler(metric="loss", mode="min", max_t=16,
                                       grace_period=2, reduction_factor=2),
                         str(tmp_path))
    tuner = Tuner(
        loops.paced_objective,
        param_space={"quality": tune.grid_search([0.0, 0.5, 50.0, 80.0]),
                     "ack_dir": str(tmp_path)},
        tune_config=TuneConfig(metric="loss", mode="min", scheduler=sched),
        run_config=RunConfig(name="asha", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.config["quality"] in (0.0, 0.5)
    # a bad trial was stopped at a rung, and ran no further
    stops = {q: t for q, t, d in sched.log if d == psched.STOP}
    bad = [r for r in grid.results if r.config["quality"] >= 50.0]
    assert any(stops.get(r.config["quality"], 16) < 16 for r in bad), stops
    for r in bad:
        if stops.get(r.config["quality"], 16) < 16:
            assert len(r.history) == stops[r.config["quality"]] < 16
            assert r.error is None


def test_pbt_exploits(cluster, tmp_path):
    tuner = Tuner(
        loops.pbt_objective,
        param_space={"lr": tune.grid_search([0.001, 0.002, 0.5, 1.0])},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=PopulationBasedTraining(
                metric="score", mode="max", perturbation_interval=3,
                hyperparam_mutations={"lr": tune.loguniform(0.001, 1.0)},
                seed=0)),
        run_config=RunConfig(name="pbt", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    best = grid.get_best_result()
    assert best.metrics["score"] >= 50  # high-lr configs dominate


def test_random_searcher_seam(cluster, tmp_path):
    calls = {"suggest": 0, "complete": 0}

    class Probe(tune.RandomSearcher):
        def suggest(self, trial_id):
            calls["suggest"] += 1
            return super().suggest(trial_id)

        def on_trial_complete(self, trial_id, metrics=None, error=False):
            calls["complete"] += 1
            assert metrics is None or "score" in metrics

    tuner = Tuner(
        loops.objective,
        param_space={"x": tune.uniform(0.0, 5.0)},
        tune_config=TuneConfig(metric="score", mode="min", num_samples=6,
                               search_alg=Probe(seed=7)),
        run_config=RunConfig(name="searcher", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 6
    assert calls["suggest"] == 6
    assert calls["complete"] == 6
    assert 0.0 <= grid.get_best_result().config["x"] <= 5.0


def test_hyperopt_searcher_or_gated_import(cluster, tmp_path):
    try:
        import hyperopt  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="hyperopt"):
            tune.HyperOptSearch()
        return
    tuner = Tuner(
        loops.objective,
        param_space={"x": tune.uniform(0.0, 5.0)},
        tune_config=TuneConfig(metric="score", mode="min", num_samples=5,
                               search_alg=tune.HyperOptSearch(
                                   n_initial_points=3, seed=1)),
        run_config=RunConfig(name="hyperopt", storage_path=str(tmp_path)),
    )
    assert len(tuner.fit()) == 5


def test_searcher_finished_and_grid_rejected(cluster, tmp_path):
    class TwoOnly(tune.RandomSearcher):
        def __init__(self):
            super().__init__(seed=0)
            self.n = 0

        def suggest(self, trial_id):
            self.n += 1
            if self.n > 2:
                return tune.Searcher.FINISHED
            return super().suggest(trial_id)

    tuner = Tuner(
        loops.objective,
        param_space={"x": tune.uniform(0.0, 5.0)},
        tune_config=TuneConfig(metric="score", mode="min", num_samples=10,
                               search_alg=TwoOnly()),
        run_config=RunConfig(name="finite", storage_path=str(tmp_path)),
    )
    assert len(tuner.fit()) == 2   # must RETURN (num_samples never reached)

    with pytest.raises(ValueError, match="grid_search"):
        Tuner(
            loops.objective,
            param_space={"x": tune.grid_search([1, 2])},
            tune_config=TuneConfig(metric="score", mode="min",
                                   search_alg=tune.RandomSearcher(seed=0)),
            run_config=RunConfig(name="bad", storage_path=str(tmp_path)),
        ).fit()


def test_pb2_exploits_with_gp(cluster, tmp_path):
    sched = tune.PB2(metric="score", mode="max", perturbation_interval=2,
                     hyperparam_bounds={"lr": (0.0, 1.0)}, seed=0)
    tuner = Tuner(
        loops.pb2_objective,
        param_space={"lr": tune.uniform(0.0, 1.0)},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=4,
                               max_concurrent_trials=4, scheduler=sched),
        run_config=RunConfig(name="pb2", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 4
    best = grid.get_best_result()
    assert 0.0 <= best.config["lr"] <= 1.0   # bounds respected
    assert best.metrics["score"] > 0.6
    assert len(sched._obs_y) >= 4


def test_bayesopt_searcher_converges(cluster, tmp_path):
    tuner = Tuner(
        loops.objective,
        param_space={"x": tune.uniform(0.0, 5.0)},
        tune_config=TuneConfig(metric="score", mode="min", num_samples=14,
                               search_alg=tune.BayesOptSearch(
                                   n_initial_points=4, seed=3)),
        run_config=RunConfig(name="bayesopt", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 14
    best = grid.get_best_result().config["x"]
    assert abs(best - 3.0) < 0.8, f"GP-EI did not converge: best x={best}"


def test_bayesopt_unit_math():
    s = tune.BayesOptSearch(n_initial_points=2, seed=0)
    s.set_search_properties("score", "max", {
        "lr": tune.loguniform(1e-5, 1e-1),
        "layers": tune.randint(1, 9),
        "act": tune.choice(["relu", "gelu"]),
        "fixed": 42})
    for i in range(6):
        cfg = s.suggest(f"t{i}")
        assert 1e-5 <= cfg["lr"] <= 1e-1
        assert 1 <= cfg["layers"] <= 8
        assert cfg["act"] in ("relu", "gelu")
        assert cfg["fixed"] == 42
        s.on_trial_complete(f"t{i}", {"score": -i}, error=False)
    assert len(s._X) == 6


def test_bohb_searcher_with_asha(cluster, tmp_path):
    sched = AckScheduler(ASHAScheduler(metric="loss", mode="min",
                                       grace_period=2, max_t=8),
                         str(tmp_path))
    tuner = Tuner(
        loops.paced_objective,
        param_space={"quality": tune.uniform(0.0, 5.0),
                     "ack_dir": str(tmp_path)},
        tune_config=TuneConfig(
            metric="loss", mode="min", num_samples=10,
            search_alg=tune.BOHBSearch(min_points_in_model=3, seed=5),
            scheduler=sched),
        run_config=RunConfig(name="bohb", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert len(grid) == 10
    best = grid.get_best_result().config["quality"]
    assert best < 2.2, f"BOHB did not concentrate low: quality={best}"


def test_bohb_model_phase_samples_from_good_region():
    s = tune.BOHBSearch(min_points_in_model=4, random_fraction=0.0, seed=1)
    s.set_search_properties("score", "max", {"x": tune.uniform(0.0, 1.0)})
    for i, (x, sc) in enumerate([(0.1, 0.0), (0.2, 0.1), (0.8, 10.0),
                                 (0.82, 11.0), (0.78, 9.0)]):
        tid = f"s{i}"
        s._open[tid] = np.asarray([x])
        s.on_trial_complete(tid, {"score": sc}, error=False)
    xs = [s.suggest(f"m{i}")["x"] for i in range(8)]
    near_good = sum(1 for x in xs if 0.6 <= x <= 1.0)
    assert near_good >= 6, f"model-phase samples not concentrated: {xs}"


# ------------------------------------------------- fractions of a GPU
def test_two_half_gpu_leases_on_one_gpu(cluster):
    """The ledger grants two {"GPU": 0.5} actors at once on a node of one
    GPU and keeps a third waiting until one of them is gone (Ray's
    fractional resources)."""
    @ray_tpu_torch.remote
    class Holder:
        def pid(self):
            return os.getpid()

    half = {"CPU": 1, "GPU": 0.5}
    a = Holder.options(resources=half, num_cpus=1).remote()
    b = Holder.options(resources=half, num_cpus=1).remote()
    try:
        pa, pb = ray_tpu_torch.get([a.pid.remote(), b.pid.remote()],
                                   timeout=60)
        assert pa != pb
        c = Holder.options(resources=half, num_cpus=1).remote()
        ref = c.pid.remote()
        ready, _ = ray_tpu_torch.wait([ref], timeout=3)
        assert not ready, "a third half-GPU lease was granted on one GPU"
        ray_tpu_torch.kill(a)
        assert ray_tpu_torch.get(ref, timeout=60) not in (pa, pb)
    finally:
        for h in (a, b, c):
            try:
                ray_tpu_torch.kill(h)
            except Exception:
                pass


def test_two_half_gpu_trials_run_at_once(cluster, tmp_path):
    """Each of two 0.5-GPU trials waits for the other's start file before
    it reports: the sweep ends with both trials done only if both held
    their half of the GPU at once."""
    tuner = Tuner(
        with_resources(loops.meet_objective, {"CPU": 1, "GPU": 0.5}),
        param_space={"me": tune.grid_search(["a", "b"]),
                     "dir": str(tmp_path)},
        tune_config=TuneConfig(metric="met", mode="max",
                               max_concurrent_trials=2),
        run_config=RunConfig(name="halves", storage_path=str(tmp_path)),
    )
    grid = tuner.fit()
    assert [r.error for r in grid.results] == [None, None]
    assert [r.metrics["met"] for r in grid.results] == [1, 1]
    assert len({r.metrics["pid"] for r in grid.results}) == 2
