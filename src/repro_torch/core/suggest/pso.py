"""Particle swarm optimization [Blum & Li 2008, cited by the paper].

Asynchronous-friendly: each ask() serves the next particle in round-robin;
tell() matches results back to particles via the assignment echo in
metadata, so parallel workers can evaluate different particles at once.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from repro_torch.core.space import Assignment, Space
from repro_torch.core.suggest.base import Observation, Optimizer, register


@register("pso")
class ParticleSwarm(Optimizer):
    def __init__(self, space: Space, seed: int = 0, particles: int = 8,
                 inertia: float = 0.7, c_personal: float = 1.4,
                 c_global: float = 1.4, device=None):
        super().__init__(space, seed)
        d = len(space)
        self.n = particles
        self.w, self.cp, self.cg = inertia, c_personal, c_global
        self.x = self.rng.uniform(size=(particles, d))
        self.v = self.rng.uniform(-0.1, 0.1, size=(particles, d))
        self.pbest = np.full(particles, -np.inf)
        self.pbest_x = self.x.copy()
        self.gbest = -np.inf
        self.gbest_x = self.x[0].copy()
        self._next = 0

    def ask(self, n: int = 1) -> List[Assignment]:
        out = []
        for _ in range(n):
            i = self._next % self.n
            self._next += 1
            a = self.space.from_unit(self.x[i])
            a["__particle__"] = i      # echo key (stripped by scheduler)
            out.append(a)
        return out

    def _update(self, observations: Sequence[Observation]) -> None:
        for o in observations:
            i = o.metadata.get("__particle__")
            if i is None or o.failed or o.value is None:
                continue
            i = int(i) % self.n
            if o.value > self.pbest[i]:
                self.pbest[i] = o.value
                self.pbest_x[i] = self.space.to_unit(
                    {k: v for k, v in o.assignment.items()
                     if not k.startswith("__")})
            if o.value > self.gbest:
                self.gbest = o.value
                self.gbest_x = self.pbest_x[i].copy()
            r1, r2 = self.rng.uniform(size=2)
            self.v[i] = (self.w * self.v[i]
                         + self.cp * r1 * (self.pbest_x[i] - self.x[i])
                         + self.cg * r2 * (self.gbest_x - self.x[i]))
            self.x[i] = np.clip(self.x[i] + self.v[i], 0.0, 1.0)
