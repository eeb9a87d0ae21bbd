"""Search-space primitives and samplers (reference surface: ray
``python/ray/tune/search/`` — grid/random variant generation)."""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Sequence


class _Domain:
    def sample(self, rng: random.Random):
        raise NotImplementedError


class grid_search:  # noqa: N801 - matches the reference's API casing
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)


class choice(_Domain):  # noqa: N801
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample(self, rng):
        return rng.choice(self.values)


class uniform(_Domain):  # noqa: N801
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


class loguniform(_Domain):  # noqa: N801
    def __init__(self, low: float, high: float):
        self.low, self.high = low, high

    def sample(self, rng):
        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


class randint(_Domain):  # noqa: N801
    def __init__(self, low: int, high: int):
        self.low, self.high = low, high

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


def generate_variants(
    param_space: Dict[str, Any], num_samples: int, seed=None
) -> List[Dict[str, Any]]:
    """Cross-product over grid_search entries × num_samples draws of random
    domains (the reference's variant-generator semantics)."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, grid_search)]

    def expand_grids(base: Dict[str, Any], keys: List[str]):
        if not keys:
            yield dict(base)
            return
        k, rest = keys[0], keys[1:]
        for v in param_space[k].values:
            base[k] = v
            yield from expand_grids(base, rest)

    out = []
    for _ in range(max(1, num_samples)):
        for grid_combo in expand_grids({}, grid_keys):
            config = {}
            for k, v in param_space.items():
                if isinstance(v, grid_search):
                    config[k] = grid_combo[k]
                elif isinstance(v, _Domain):
                    config[k] = v.sample(rng)
                else:
                    config[k] = v
            out.append(config)
    return out
