"""BOHB searcher: KDE-model-based suggestions (TPE-style density ratio).

Behavioral parity with `python/ray/tune/search/bohb/bohb_search.py`
(TuneBOHB, which wraps hpbandster's ConfigSpace + KDE model): completed
trials split at a quantile into good/bad sets; new configs are sampled
around good points and ranked by the good/bad kernel-density ratio
l(x)/g(x) — the BOHB paper's model. Pair with ASHAScheduler /
HyperbandForBOHB-style early stopping via TuneConfig.scheduler (the
bracket machinery already lives in tune/schedulers.py). Implemented in
numpy; no hpbandster/ConfigSpace dependency.

Counterpart of `ray_tpu/tune/bohb_search.py`.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.bayesopt_search import _Dim
from ray_tpu_torch.tune.search import Domain, GridSearch
from ray_tpu_torch.tune.searcher import Searcher


class BOHBSearch(Searcher):
    def __init__(self, min_points_in_model: int = 6,
                 top_n_fraction: float = 0.3, bandwidth: float = 0.12,
                 n_candidates: int = 64, random_fraction: float = 0.2,
                 seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed)
        self.min_points = min_points_in_model
        self.top_frac = top_n_fraction
        self.bw = bandwidth
        self.n_candidates = n_candidates
        self.random_fraction = random_fraction
        self._dims: List[_Dim] = []
        self._constants: Dict[str, Any] = {}
        self._X: List[np.ndarray] = []
        self._y: List[float] = []
        self._open: Dict[str, np.ndarray] = {}

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        self._dims = []
        self._constants = {}
        for k, v in param_space.items():
            if isinstance(v, (Domain, GridSearch)):
                self._dims.append(_Dim(k, v))
            else:
                self._constants[k] = v

    def _kde(self, points: np.ndarray, x: np.ndarray) -> np.ndarray:
        """Gaussian KDE density of candidates `x` under `points`."""
        d2 = ((x[:, None, :] - points[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.bw ** 2)).mean(1) + 1e-12

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        d = len(self._dims)
        if d == 0:
            return dict(self._constants)
        if (len(self._X) < self.min_points
                or self._rng.random() < self.random_fraction):
            # BOHB keeps a random fraction for exploration even with a
            # full model (paper §3; reference random_fraction)
            u = self._rng.random(d)
        else:
            X = np.stack(self._X)
            y = np.asarray(self._y)
            n_good = max(1, int(self.top_frac * len(y)))
            order = np.argsort(-y)      # maximize internally
            good, bad = X[order[:n_good]], X[order[n_good:]]
            if len(bad) == 0:
                bad = X
            # sample candidates AROUND good points (hpbandster samples
            # from the good KDE), rank by density ratio
            seeds = good[self._rng.integers(len(good), size=self.n_candidates)]
            cand = np.clip(
                seeds + self._rng.normal(0, self.bw, seeds.shape), 0, 1)
            ratio = self._kde(good, cand) / self._kde(bad, cand)
            u = cand[int(np.argmax(ratio))]
        self._open[trial_id] = u
        cfg = {dim.key: dim.from_unit(float(u[i]))
               for i, dim in enumerate(self._dims)}
        cfg.update(self._constants)
        return cfg

    def on_trial_complete(self, trial_id, metrics=None, error=False):
        u = self._open.pop(trial_id, None)
        if u is None or error or not metrics or self.metric not in metrics:
            return
        score = float(metrics[self.metric])
        if self.mode == "min":
            score = -score
        self._X.append(u)
        self._y.append(score)
