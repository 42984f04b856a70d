"""Trial schedulers: FIFO, ASHA, median stopping, PBT.

Parity (core subset) with `python/ray/tune/schedulers/`: ASHA
(`async_hyperband.py` rung-based promotion), MedianStoppingRule, and
PopulationBasedTraining (exploit top quantile + mutate, restart from donor
checkpoint).

Counterpart of `ray_tpu/tune/schedulers.py`.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, trial_id: str) -> None:
        pass


class ASHAScheduler(FIFOScheduler):
    """Async successive halving: at rungs grace_period * rf^k, stop trials
    outside the top 1/reduction_factor of results seen at that rung."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self.rung_results: Dict[int, List[float]] = defaultdict(list)
        # rungs each trial has already been judged at (milestone crossing is
        # evaluated once per rung per trial, like the reference ASHA)
        self._judged: Dict[str, set] = defaultdict(set)

    def _better(self, a: float) -> float:
        return a if self.mode == "min" else -a

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        t = result.get(self.time_attr)
        score = result.get(self.metric)
        if t is None or score is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        # judge at the largest rung <= t not yet seen for this trial; exact
        # equality would silently no-op for time_attrs that skip rung values
        for rung in reversed(self.rungs):
            if t >= rung and rung not in self._judged[trial_id]:
                self._judged[trial_id].add(rung)
                recorded = self.rung_results[rung]
                recorded.append(self._better(float(score)))
                k = max(1, len(recorded) // self.rf)
                cutoff = sorted(recorded)[k - 1]
                if self._better(float(score)) > cutoff:
                    return STOP
                break
        return CONTINUE


class MedianStoppingRule(FIFOScheduler):
    """Stop a trial whose best result so far is worse than the median of
    other trials' running averages at the same step."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 grace_period: int = 1,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.time_attr = time_attr
        self.history: Dict[str, List[float]] = defaultdict(list)

    def on_result(self, trial_id: str, result: Dict[str, Any]) -> str:
        score = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if score is None:
            return CONTINUE
        sign = 1.0 if self.mode == "min" else -1.0
        self.history[trial_id].append(sign * float(score))
        if t < self.grace or len(self.history) < 3:
            return CONTINUE
        my_avg = sum(self.history[trial_id]) / len(self.history[trial_id])
        others = [sum(v) / len(v) for k, v in self.history.items()
                  if k != trial_id]
        others.sort()
        median = others[len(others) // 2]
        return STOP if my_avg > median else CONTINUE


class PopulationBasedTraining(FIFOScheduler):
    """PBT (reference schedulers/pbt.py): every perturbation_interval
    results, bottom-quantile trials adopt a top-quantile trial's config
    (mutated) and checkpoint. The controller executes the decision
    ("EXPLOIT", donor_trial_id, new_config)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 2,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: Optional[int] = None,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self.rng = random.Random(seed)
        self.latest: Dict[str, float] = {}
        self.counts: Dict[str, int] = defaultdict(int)

    def on_result(self, trial_id: str, result: Dict[str, Any]):
        import math

        score = result.get(self.metric)
        if score is None or not math.isfinite(float(score)):
            # a diverged trial's nan would give it an arbitrary rank —
            # possibly top-quantile, exploiting healthy trials onto it
            return CONTINUE
        sign = -1.0 if self.mode == "min" else 1.0
        self.latest[trial_id] = sign * float(score)
        self.counts[trial_id] += 1
        if self.counts[trial_id] % self.interval or len(self.latest) < 4:
            return CONTINUE
        ranked = sorted(self.latest, key=self.latest.get, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        if trial_id in ranked[-k:]:
            donor = self.rng.choice(ranked[:k])
            if donor != trial_id:
                return ("EXPLOIT", donor, self._mutate)
        return CONTINUE

    def _mutate(self, donor_config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain

        cfg = dict(donor_config)
        for key, spec in self.mutations.items():
            if isinstance(spec, list):
                cfg[key] = self.rng.choice(spec)
            elif isinstance(spec, Domain):
                cfg[key] = spec.sample(self.rng)
            elif callable(spec):
                cfg[key] = spec()
            elif key in cfg and isinstance(cfg[key], (int, float)):
                cfg[key] = cfg[key] * self.rng.choice([0.8, 1.2])
        return cfg


class PB2(PopulationBasedTraining):
    """PB2: PBT whose exploit step picks new hyperparameters with a
    GP-bandit (UCB) over observed (config -> score improvement) data,
    instead of random perturbation. Parity: `python/ray/tune/schedulers/
    pb2.py` (Parker-Holder et al., NeurIPS 2020) — re-implemented on a
    small numpy Gaussian process (RBF kernel), no GPy dependency.

    `hyperparam_bounds` maps each tuned key to (low, high); values are
    optimized in normalized [0,1]^d space. Categorical keys stay with
    PBT-style resampling via `hyperparam_mutations`.
    """

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 2,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: Optional[int] = None,
                 time_attr: str = "training_iteration", ucb_kappa: float = 2.0):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations=hyperparam_mutations,
                         quantile_fraction=quantile_fraction, seed=seed,
                         time_attr=time_attr)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in (hyperparam_bounds or {}).items()}
        self.kappa = ucb_kappa
        # observations: (normalized config vector, score delta since the
        # trial's previous window) — what the GP models
        self._obs_x: list = []
        self._obs_y: list = []
        self._prev_score: Dict[str, float] = {}
        self._trial_cfg: Dict[str, Dict[str, Any]] = {}

    # the controller tells us each trial's live config via on_result's
    # carried config when available; fall back to donor config at exploit
    def record_config(self, trial_id: str, config: Dict[str, Any]) -> None:
        self._trial_cfg[trial_id] = dict(config)

    def _normalize(self, cfg: Dict[str, Any]):
        import numpy as _np

        return _np.asarray([
            ((float(cfg.get(k, lo)) - lo) / (hi - lo) if hi > lo else 0.0)
            for k, (lo, hi) in sorted(self.bounds.items())], dtype=float)

    def on_result(self, trial_id: str, result: Dict[str, Any]):
        cfg = result.get("config")
        if isinstance(cfg, dict):
            self.record_config(trial_id, cfg)
        score = result.get(self.metric)
        if score is not None and trial_id in self._trial_cfg and self.bounds:
            sign = -1.0 if self.mode == "min" else 1.0
            s = sign * float(score)
            import math

            prev = self._prev_score.get(trial_id)
            if prev is not None and math.isfinite(s - prev):
                # one diverged trial's nan would poison every UCB pick
                self._obs_x.append(self._normalize(self._trial_cfg[trial_id]))
                self._obs_y.append(s - prev)
                if len(self._obs_y) > 256:   # GP only reads the tail
                    del self._obs_x[:-128], self._obs_y[:-128]
            if math.isfinite(s):
                self._prev_score[trial_id] = s
        decision = super().on_result(trial_id, result)
        if isinstance(decision, tuple) and decision[0] == "EXPLOIT":
            # the exploited trial restarts from the DONOR's checkpoint:
            # its next score jump is inherited, not earned by the freshly
            # GP-picked config — never feed it to the GP as improvement
            self._prev_score.pop(trial_id, None)
            self._trial_cfg.pop(trial_id, None)
        return decision

    # ------------------------------------------------------------- GP-UCB
    def _gp_ucb_pick(self):
        """Maximize UCB of predicted score-improvement over [0,1]^d via
        random candidate search (d is small for hyperparams)."""
        import numpy as _np

        d = len(self.bounds)
        rng = _np.random.default_rng(self.rng.randrange(1 << 30))
        cands = rng.random((256, d))
        if len(self._obs_y) < 3:
            return cands[0]
        X = _np.stack(self._obs_x[-64:])
        y = _np.asarray(self._obs_y[-64:], dtype=float)
        y_std = y.std() or 1.0
        y = (y - y.mean()) / y_std
        ls, noise = 0.3, 1e-3

        def k(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return _np.exp(-d2 / (2 * ls * ls))

        K = k(X, X) + noise * _np.eye(len(X))
        Kinv = _np.linalg.inv(K)
        Ks = k(cands, X)
        mu = Ks @ Kinv @ y
        var = _np.clip(1.0 - (Ks @ Kinv * Ks).sum(-1), 1e-9, None)
        ucb = mu + self.kappa * _np.sqrt(var)
        return cands[int(_np.argmax(ucb))]

    def _mutate(self, donor_config: Dict[str, Any]) -> Dict[str, Any]:
        # categorical keys resample PBT-style (hyperparam_mutations);
        # continuous bounded keys come from the GP-UCB pick
        cfg = super()._mutate(donor_config) if self.mutations \
            else dict(donor_config)
        if not self.bounds:
            return cfg
        z = self._gp_ucb_pick()
        for i, (key, (lo, hi)) in enumerate(sorted(self.bounds.items())):
            cfg[key] = lo + float(z[i]) * (hi - lo)
        return cfg
