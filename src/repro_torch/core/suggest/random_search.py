"""Random search [Bergstra & Bengio 2012] — the paper's baseline strategy."""
from __future__ import annotations

from typing import List

from repro_torch.core.space import Assignment, Space
from repro_torch.core.suggest.base import Optimizer, register


@register("random")
class RandomSearch(Optimizer):
    def ask(self, n: int = 1) -> List[Assignment]:
        return self.space.sample(self.rng, n)
