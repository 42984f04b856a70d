"""Optuna searcher adapter (optional dependency).

Parity target: `python/ray/tune/search/optuna/optuna_search.py` — an
ask/tell bridge: each suggest() is `study.ask()` with distributions
derived from the tune search space; completions are `study.tell()`.
Optuna is NOT bundled: constructing OptunaSearch without it installed
raises ImportError with install guidance (reference behavior).

Counterpart of `ray_tpu/tune/optuna_search.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search import (Choice, Domain, GridSearch, LogUniform,
                                       RandInt, Uniform)
from ray_tpu_torch.tune.searcher import Searcher


class OptunaSearch(Searcher):
    def __init__(self, sampler: Any = None, seed: Optional[int] = None):
        try:
            import optuna
        except ImportError as e:  # pragma: no cover - depends on env
            raise ImportError(
                "OptunaSearch requires `optuna` (pip install optuna)"
            ) from e
        self._optuna = optuna
        if sampler is None:
            sampler = optuna.samplers.TPESampler(seed=seed)
        self._sampler = sampler
        self._study = None
        self._trials: Dict[str, Any] = {}

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        direction = "minimize" if mode == "min" else "maximize"
        self._study = self._optuna.create_study(direction=direction,
                                                sampler=self._sampler)

    def _suggest_param(self, ot, key: str, dom: Any):
        if isinstance(dom, Uniform):
            return ot.suggest_float(key, dom.low, dom.high)
        if isinstance(dom, LogUniform):
            return ot.suggest_float(key, dom.low, dom.high, log=True)
        if isinstance(dom, RandInt):
            return ot.suggest_int(key, dom.low, dom.high - 1)
        if isinstance(dom, (Choice, GridSearch)):
            vals = dom.categories if isinstance(dom, Choice) else dom.values
            idx = ot.suggest_categorical(f"{key}__idx",
                                         list(range(len(vals))))
            return vals[idx]
        return dom  # constant

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        ot = self._study.ask()
        self._trials[trial_id] = ot
        cfg = {}
        for k, v in self.param_space.items():
            cfg[k] = (self._suggest_param(ot, k, v)
                      if isinstance(v, (Domain, GridSearch)) else v)
        return cfg

    def on_trial_complete(self, trial_id, metrics=None, error=False):
        ot = self._trials.pop(trial_id, None)
        if ot is None:
            return
        state = self._optuna.trial.TrialState.COMPLETE
        value = None
        if error or not metrics or self.metric not in metrics:
            state = self._optuna.trial.TrialState.FAIL
        else:
            value = float(metrics[self.metric])
        self._study.tell(ot, value, state=state)
