"""HyperOpt (TPE) searcher adapter (optional dependency).

Parity target: `python/ray/tune/search/hyperopt/hyperopt_search.py` —
an ask/tell bridge over hyperopt's Trials machinery: each suggest()
inserts a new TPE-proposed trial document, completions are written back
as hyperopt results. hyperopt is NOT bundled: constructing
HyperOptSearch without it raises ImportError with install guidance
(reference behavior).

Counterpart of `ray_tpu/tune/hyperopt_search.py`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search import (Choice, Domain, GridSearch, LogUniform,
                                       RandInt, Uniform)
from ray_tpu_torch.tune.searcher import Searcher


class HyperOptSearch(Searcher):
    def __init__(self, n_initial_points: int = 20,
                 seed: Optional[int] = None, gamma: float = 0.25):
        try:
            import hyperopt as hpo
        except ImportError as e:  # pragma: no cover - depends on env
            raise ImportError(
                "HyperOptSearch requires `hyperopt` "
                "(pip install hyperopt)") from e
        import numpy as np

        self._hpo = hpo
        self._algo = lambda *args: hpo.tpe.suggest(
            *args, n_startup_jobs=n_initial_points, gamma=gamma)
        self._rstate = np.random.default_rng(seed)
        self._trials = None           # hyperopt.Trials
        self._domain = None           # hyperopt.Domain over the space
        self._open: Dict[str, int] = {}   # our trial_id -> hyperopt tid

    # ------------------------------------------------------------ space
    def _to_hp_space(self, param_space: Dict[str, Any]) -> dict:
        hp = self._hpo.hp
        space = {}
        self._constants = {}
        for k, v in param_space.items():
            if isinstance(v, Uniform):
                space[k] = hp.uniform(k, v.low, v.high)
            elif isinstance(v, LogUniform):
                import math

                space[k] = hp.loguniform(k, math.log(v.low),
                                         math.log(v.high))
            elif isinstance(v, RandInt):
                space[k] = hp.randint(k, v.low, v.high)
            elif isinstance(v, (Choice, GridSearch)):
                vals = v.categories if isinstance(v, Choice) else v.values
                space[k] = hp.choice(k, list(vals))
            else:
                self._constants[k] = v
        return space

    def set_search_properties(self, metric, mode, param_space):
        super().set_search_properties(metric, mode, param_space)
        space = self._to_hp_space(param_space)
        self._trials = self._hpo.Trials()
        self._domain = self._hpo.Domain(lambda spc: spc, space)

    # ---------------------------------------------------------- ask/tell
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        h = self._hpo
        new_ids = self._trials.new_trial_ids(1)
        self._trials.refresh()
        seed = int(self._rstate.integers(2 ** 31 - 1))
        new_trials = self._algo(new_ids, self._domain, self._trials, seed)
        self._trials.insert_trial_docs(new_trials)
        self._trials.refresh()
        tid = new_trials[0]["tid"]
        self._open[trial_id] = tid
        vals = {k: v[0] for k, v in
                new_trials[0]["misc"]["vals"].items() if v}
        cfg = h.space_eval(self._domain.expr, vals)
        out = dict(self._constants)
        out.update(cfg)
        return out

    def _tell(self, trial_id: str, loss: Optional[float],
              ok: bool) -> None:
        h = self._hpo
        tid = self._open.pop(trial_id, None)
        if tid is None or self._trials is None:
            return
        for t in self._trials._dynamic_trials:
            if t["tid"] == tid:
                t["state"] = h.JOB_STATE_DONE if ok else h.JOB_STATE_ERROR
                if ok:
                    t["result"] = {"loss": loss, "status": h.STATUS_OK}
                else:
                    t["result"] = {"status": h.STATUS_FAIL}
                break
        self._trials.refresh()

    def on_trial_complete(self, trial_id, metrics=None, error=False):
        if error or metrics is None or self.metric not in metrics:
            self._tell(trial_id, None, ok=False)
            return
        value = float(metrics[self.metric])
        loss = value if self.mode == "min" else -value
        self._tell(trial_id, loss, ok=True)
