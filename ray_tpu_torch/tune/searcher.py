"""Searcher seam: pluggable suggestion algorithms for the Tuner.

Parity target: the reference's `Searcher` interface
(`python/ray/tune/search/searcher.py` — suggest/on_trial_complete) and its
external integrations (`tune/search/optuna/optuna_search.py` etc.). The
built-in `BasicVariantGenerator` stays the default; a `Searcher` set on
`TuneConfig.search_alg` turns trial generation sequential-adaptive: each
new trial's config is suggested from the live results of finished ones.

Counterpart of `ray_tpu/tune/searcher.py`.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search import Choice, Domain, GridSearch


class Searcher:
    """Suggestion algorithm interface (reference searcher.py)."""

    # sentinel return from suggest(): the search space is exhausted and no
    # further trials will ever be suggested (reference Searcher.FINISHED)
    FINISHED = "FINISHED"

    def set_search_properties(self, metric: str, mode: str,
                              param_space: Dict[str, Any]) -> None:
        self.metric = metric
        self.mode = mode
        self.param_space = param_space

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config to try; None = no suggestion RIGHT NOW (retry
        later); Searcher.FINISHED = permanently done."""
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          metrics: Optional[Dict[str, Any]] = None,
                          error: bool = False) -> None:
        """Final result (or failure) of a suggested trial."""

    def on_trial_result(self, trial_id: str,
                        metrics: Dict[str, Any]) -> None:
        """Intermediate result (optional for pruners)."""


class RandomSearcher(Searcher):
    """Domain-sampling searcher — the simplest concrete Searcher; also the
    CI stand-in proving the seam without external deps."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        cfg = {}
        for k, v in self.param_space.items():
            if isinstance(v, GridSearch):
                cfg[k] = self._rng.choice(v.values)
            elif isinstance(v, Domain):
                cfg[k] = v.sample(self._rng)
            else:
                cfg[k] = v
        return cfg
