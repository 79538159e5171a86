"""Search spaces + variant generation (reference parity: tune/search/ —
sample.py domains, basic_variant.py BasicVariantGenerator).

Port of `ray_tpu/tune/search.py`, numpy only and unchanged: the same
`seed` gives the same variants, bit for bit."""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


class Domain:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError


@dataclasses.dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return float(rng.uniform(self.low, self.high))


@dataclasses.dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return float(math.exp(rng.uniform(math.log(self.low), math.log(self.high))))


@dataclasses.dataclass
class RandInt(Domain):
    low: int
    high: int  # exclusive

    def sample(self, rng):
        return int(rng.integers(self.low, self.high))


@dataclasses.dataclass
class Choice(Domain):
    options: Sequence[Any]

    def sample(self, rng):
        return self.options[int(rng.integers(0, len(self.options)))]


@dataclasses.dataclass
class GridSearch:
    """Marker: expanded as a cross-product, not sampled."""

    values: Sequence[Any]


# public constructors (ray.tune.uniform etc.)
def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(options: Sequence[Any]) -> Choice:
    return Choice(list(options))


def grid_search(values: Sequence[Any]) -> GridSearch:
    return GridSearch(list(values))


def generate_variants(
    param_space: Dict[str, Any], num_samples: int, seed: int = 0
) -> Iterator[Dict[str, Any]]:
    """Cross-product of grid axes × num_samples draws of random domains.
    Plain values pass through. Accepts both the constructor form
    (tune.grid_search([...])) and the reference's literal dict form
    ({"grid_search": [...]})."""
    param_space = {
        k: (
            GridSearch(list(v["grid_search"]))
            if isinstance(v, dict) and set(v) == {"grid_search"}
            else v
        )
        for k, v in param_space.items()
    }
    grid_keys = [k for k, v in param_space.items() if isinstance(v, GridSearch)]
    grid_values = [param_space[k].values for k in grid_keys]
    rng = np.random.default_rng(seed)

    grids = list(itertools.product(*grid_values)) if grid_keys else [()]
    for _ in range(num_samples):
        for combo in grids:
            config: Dict[str, Any] = {}
            for k, v in param_space.items():
                if isinstance(v, GridSearch):
                    config[k] = combo[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    config[k] = v.sample(rng)
                else:
                    config[k] = v
            yield config
