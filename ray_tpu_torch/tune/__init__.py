"""ray_tpu_torch.tune: hyperparameter optimization (reference:
python/ray/tune/, SURVEY §2.7). `tune.report` shares the train session (a
trial IS a 1-worker train run, matching the reference's Trainable/Train
unification in v2).

Counterpart of `ray_tpu.tune`. Neither it nor any module of it imports
torch: a trial's trainable does, in the trial's own process.
"""

from ray_tpu_torch.train.session import get_context, report  # noqa: F401
from ray_tpu_torch.tune.schedulers import (ASHAScheduler, FIFOScheduler,
                                           MedianStoppingRule, PB2,
                                           PopulationBasedTraining)
from ray_tpu_torch.tune.search import (BasicVariantGenerator, choice,
                                       grid_search, loguniform, randint,
                                       uniform)
from ray_tpu_torch.tune.searcher import RandomSearcher, Searcher
from ray_tpu_torch.tune.optuna_search import OptunaSearch
from ray_tpu_torch.tune.hyperopt_search import HyperOptSearch
from ray_tpu_torch.tune.bayesopt_search import BayesOptSearch
from ray_tpu_torch.tune.bohb_search import BOHBSearch
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig,
                                      Tuner, with_resources)


def get_checkpoint():
    return get_context().get_checkpoint()


__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "TrialResult", "with_resources",
    "report", "get_checkpoint", "get_context",
    "choice", "uniform", "loguniform", "randint", "grid_search",
    "BasicVariantGenerator", "FIFOScheduler", "ASHAScheduler",
    "MedianStoppingRule", "PopulationBasedTraining", "PB2",
    "Searcher", "RandomSearcher", "OptunaSearch", "HyperOptSearch",
    "BayesOptSearch", "BOHBSearch",
]
