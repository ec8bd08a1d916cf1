"""Sobol quasi-random search — better space filling than iid random under
parallel asking (no two workers get clustered points)."""
from __future__ import annotations

from typing import List

from scipy.stats import qmc

from repro_torch.core.space import Assignment, Space
from repro_torch.core.suggest.base import Optimizer, register


@register("sobol")
class SobolSearch(Optimizer):
    def __init__(self, space: Space, seed: int = 0, device=None):
        super().__init__(space, seed)
        self._engine = qmc.Sobol(d=len(space), scramble=True, seed=seed)
        self._buf: List = []

    def ask(self, n: int = 1) -> List[Assignment]:
        while len(self._buf) < n:   # draw power-of-2 blocks (Sobol balance)
            self._buf.extend(list(self._engine.random(
                max(8, 1 << (n - 1).bit_length()))))
        u, self._buf = self._buf[:n], self._buf[n:]
        return [self.space.from_unit(row) for row in u]
