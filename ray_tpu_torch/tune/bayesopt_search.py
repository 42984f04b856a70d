"""Gaussian-process Bayesian optimization searcher (self-contained).

Behavioral parity with `python/ray/tune/search/bayesopt/bayesopt_search.py`
(which wraps the `bayesian-optimization` package): a GP surrogate with an
RBF kernel over the unit-cube-normalized search space, expected-improvement
acquisition maximized over random candidates. Implemented in numpy — no
external dependency (same approach as the r4 PB2 GP-bandit).

Counterpart of `ray_tpu/tune/bayesopt_search.py`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.tune.search import (Choice, Domain, GridSearch, LogUniform,
                                       RandInt, Uniform)
from ray_tpu_torch.tune.searcher import Searcher


class _Dim:
    """One normalized dimension: maps config value <-> [0, 1]."""

    def __init__(self, key: str, dom: Any):
        self.key = key
        self.dom = dom
        self.categories: Optional[List[Any]] = None
        if isinstance(dom, (Choice, GridSearch)):
            self.categories = list(dom.categories if isinstance(dom, Choice)
                                   else dom.values)

    def to_unit(self, v: Any) -> float:
        d = self.dom
        if self.categories is not None:
            return self.categories.index(v) / max(len(self.categories) - 1, 1)
        if isinstance(d, LogUniform):
            return ((math.log(v) - math.log(d.low))
                    / (math.log(d.high) - math.log(d.low)))
        if isinstance(d, (Uniform, RandInt)):
            return (v - d.low) / max(d.high - d.low, 1e-12)
        return 0.0

    def from_unit(self, u: float) -> Any:
        d = self.dom
        u = min(max(u, 0.0), 1.0)
        if self.categories is not None:
            idx = int(round(u * (len(self.categories) - 1)))
            return self.categories[idx]
        if isinstance(d, LogUniform):
            return math.exp(math.log(d.low)
                            + u * (math.log(d.high) - math.log(d.low)))
        if isinstance(d, RandInt):
            return int(d.low + u * (d.high - 1 - d.low) + 0.5)
        return d.low + u * (d.high - d.low)


class BayesOptSearch(Searcher):
    def __init__(self, n_initial_points: int = 5, kappa_seed: Optional[int] = None,
                 seed: Optional[int] = None, n_candidates: int = 512,
                 length_scale: float = 0.25, noise: float = 1e-4):
        self._rng = np.random.default_rng(
            seed if seed is not None else kappa_seed)
        self.n_initial = n_initial_points
        self.n_candidates = n_candidates
        self.ls = length_scale
        self.noise = noise
        self._dims: List[_Dim] = []
        self._constants: Dict[str, Any] = {}
        self._X: List[np.ndarray] = []     # observed unit points
        self._y: List[float] = []          # observed scores (maximize)
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

    # ---------------------------------------------------------------- GP
    def _kernel(self, A: np.ndarray, B: np.ndarray) -> np.ndarray:
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self.ls ** 2))

    def _ei(self, cand: np.ndarray) -> np.ndarray:
        """Expected improvement of candidates over the incumbent."""
        X = np.stack(self._X)
        y = np.asarray(self._y)
        ymean, ystd = y.mean(), max(y.std(), 1e-9)
        yn = (y - ymean) / ystd
        K = self._kernel(X, X) + self.noise * np.eye(len(X))
        Ks = self._kernel(cand, X)
        try:
            L = np.linalg.cholesky(K)
            alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
            v = np.linalg.solve(L, Ks.T)
            mu = Ks @ alpha
            var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        except np.linalg.LinAlgError:
            return self._rng.random(len(cand))
        sigma = np.sqrt(var)
        best = yn.max()
        z = (mu - best) / sigma
        # standard normal pdf/cdf
        pdf = np.exp(-0.5 * z ** 2) / math.sqrt(2 * math.pi)
        cdf = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
        return (mu - best) * cdf + sigma * pdf

    # ---------------------------------------------------------- ask/tell
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        d = len(self._dims)
        if d == 0:
            return dict(self._constants)
        if len(self._X) < self.n_initial:
            u = self._rng.random(d)
        else:
            cand = self._rng.random((self.n_candidates, d))
            u = cand[int(np.argmax(self._ei(cand)))]
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
