"""Grid search — enumerates a lattice once, then refines with jittered
resampling when the budget exceeds the lattice size."""
from __future__ import annotations

from typing import List

from repro_torch.core.space import Assignment, Space
from repro_torch.core.suggest.base import Optimizer, register


@register("grid")
class GridSearch(Optimizer):
    def __init__(self, space: Space, seed: int = 0, points_per_dim: int = 5,
                 device=None):
        super().__init__(space, seed)
        self._queue = space.grid(points_per_dim)
        self.rng.shuffle(self._queue)  # decorrelate parallel workers

    def ask(self, n: int = 1) -> List[Assignment]:
        out = []
        for _ in range(n):
            if self._queue:
                out.append(self._queue.pop())
            else:                       # budget > lattice: jittered resample
                out.append(self.space.sample(self.rng, 1)[0])
        return out
