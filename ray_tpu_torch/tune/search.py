"""Search spaces + suggestion generators.

Parity (core subset) with `python/ray/tune/search/`: sample-space primitives
(uniform/loguniform/randint/choice/grid_search) and BasicVariantGenerator
(grid cross-product × random sampling); concurrency is capped by
`TuneConfig.max_concurrent_trials`.

Counterpart of `ray_tpu/tune/search.py`.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import random
from typing import Any, Dict, Iterator, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclasses.dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclasses.dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclasses.dataclass
class Choice(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclasses.dataclass
class GridSearch:
    values: List[Any]


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(categories: List[Any]) -> Choice:
    return Choice(list(categories))


def grid_search(values: List[Any]) -> GridSearch:
    return GridSearch(list(values))


class BasicVariantGenerator:
    """Grid axes form a cross product; Domain axes are sampled per variant
    (reference search/basic_variant.py)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self.param_space = param_space
        self.num_samples = num_samples
        self.rng = random.Random(seed)

    def variants(self) -> Iterator[Dict[str, Any]]:
        grid_keys = [k for k, v in self.param_space.items()
                     if isinstance(v, GridSearch)]
        grid_values = [self.param_space[k].values for k in grid_keys]
        grids = list(itertools.product(*grid_values)) or [()]
        for _ in range(self.num_samples):
            for combo in grids:
                cfg = {}
                for k, v in self.param_space.items():
                    if isinstance(v, GridSearch):
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self.rng)
                    else:
                        cfg[k] = v
                yield cfg
