"""Regularized evolution [Real et al. 2019-style; the paper cites
evolutionary strategies as a suitable HPO method]."""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.space import Assignment, Space
from repro_torch.core.suggest.base import Observation, Optimizer, register


@register("evolution")
class RegularizedEvolution(Optimizer):
    def __init__(self, space: Space, seed: int = 0, population: int = 16,
                 tournament: int = 4, mutate_scale: float = 0.15,
                 device=None):
        super().__init__(space, seed)
        self.population_size = population
        self.tournament = tournament
        self.mutate_scale = mutate_scale
        self._population: List[Observation] = []   # FIFO of recent survivors

    def ask(self, n: int = 1) -> List[Assignment]:
        out = []
        for _ in range(n):
            if len(self._population) < self.population_size:
                out.append(self.space.sample(self.rng, 1)[0])
                continue
            idx = self.rng.choice(len(self._population),
                                  size=min(self.tournament,
                                           len(self._population)),
                                  replace=False)
            parent = max((self._population[i] for i in idx),
                         key=lambda o: o.value)
            out.append(self._mutate(parent.assignment))
        return out

    def _mutate(self, a: Assignment) -> Assignment:
        u = self.space.to_unit(a)
        i = self.rng.integers(len(u))
        p = self.space.params[i]
        if p.kind == "categorical":
            u[i] = self.rng.uniform()
        else:
            u[i] = np.clip(u[i] + self.rng.normal(0, self.mutate_scale), 0, 1)
        return self.space.from_unit(u)

    def _update(self, observations: Sequence[Observation]) -> None:
        for o in observations:
            if o.failed or o.value is None:
                continue
            self._population.append(o)
            if len(self._population) > self.population_size:
                self._population.pop(0)            # age-based removal
