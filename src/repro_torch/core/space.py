"""Hyperparameter search spaces.

A ``Space`` is an ordered set of parameters (double / int / categorical,
optionally log-scaled) with a bijective codec to the unit cube — every
optimizer in ``core/suggest`` works in [0,1]^d and lets the space handle
types, bounds, and scaling (this mirrors how SigOpt's API separates the
experiment definition from the optimizer).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

Assignment = Dict[str, Any]


def strip_internal(a: Assignment) -> Assignment:
    """Drop optimizer-internal ``__``-prefixed echo keys (constant-liar
    tokens, particle ids, ...) — the user-facing view of an assignment."""
    return {k: v for k, v in a.items() if not k.startswith("__")}


@dataclass(frozen=True)
class Param:
    name: str
    kind: str                                  # double | int | categorical
    low: float = 0.0
    high: float = 1.0
    log: bool = False
    choices: Tuple[Any, ...] = ()

    def __post_init__(self):
        if self.kind in ("double", "int"):
            if not self.high > self.low:
                raise ValueError(f"{self.name}: high must exceed low")
            if self.log and self.low <= 0:
                raise ValueError(f"{self.name}: log scale needs low > 0")
        elif self.kind == "categorical":
            if not self.choices:
                raise ValueError(f"{self.name}: categorical needs choices")
        else:
            raise ValueError(f"{self.name}: unknown kind {self.kind}")

    # --- unit-cube codec ---------------------------------------------------
    def to_unit(self, value) -> float:
        if self.kind == "categorical":
            return (self.choices.index(value) + 0.5) / len(self.choices)
        lo, hi = self.low, self.high
        if self.log:
            return (math.log(value) - math.log(lo)) / (math.log(hi) - math.log(lo))
        return (float(value) - lo) / (hi - lo)

    def from_unit(self, u: float):
        u = min(max(float(u), 0.0), 1.0)
        if self.kind == "categorical":
            idx = min(int(u * len(self.choices)), len(self.choices) - 1)
            return self.choices[idx]
        lo, hi = self.low, self.high
        if self.log:
            v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
        else:
            v = lo + u * (hi - lo)
        if self.kind == "int":
            return int(round(min(max(v, lo), hi)))
        return float(min(max(v, lo), hi))   # clamp exp/log float error

    def validate(self, value) -> bool:
        if self.kind == "categorical":
            return value in self.choices
        ok = self.low <= value <= self.high
        return ok and (self.kind != "int" or float(value).is_integer())


class Space:
    def __init__(self, params: Sequence[Param]):
        if len({p.name for p in params}) != len(params):
            raise ValueError("duplicate parameter names")
        self.params: Tuple[Param, ...] = tuple(params)

    # --- constructors -------------------------------------------------------
    @classmethod
    def from_config(cls, items: Sequence[Dict[str, Any]]) -> "Space":
        """Build from YAML/JSON dicts: {name, type, bounds|choices, log}."""
        ps = []
        for it in items:
            kind = it.get("type", "double")
            if kind == "categorical":
                ps.append(Param(it["name"], kind,
                                choices=tuple(it["choices"])))
            else:
                lo, hi = it.get("bounds", (it.get("min"), it.get("max")))
                ps.append(Param(it["name"], kind, low=float(lo), high=float(hi),
                                log=bool(it.get("log", False))))
        return cls(ps)

    # --- basics --------------------------------------------------------------
    def __len__(self):
        return len(self.params)

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.params]

    def validate(self, a: Assignment) -> bool:
        return (set(a) == set(self.names)
                and all(p.validate(a[p.name]) for p in self.params))

    # --- codecs ---------------------------------------------------------------
    def to_unit(self, a: Assignment) -> np.ndarray:
        return np.array([p.to_unit(a[p.name]) for p in self.params])

    def from_unit(self, u: np.ndarray) -> Assignment:
        return {p.name: p.from_unit(u[i]) for i, p in enumerate(self.params)}

    # --- sampling ---------------------------------------------------------------
    def sample(self, rng: np.random.Generator, n: int = 1) -> List[Assignment]:
        u = rng.uniform(size=(n, len(self.params)))
        return [self.from_unit(row) for row in u]

    def grid(self, points_per_dim: int) -> List[Assignment]:
        axes = []
        for p in self.params:
            if p.kind == "categorical":
                axes.append([p.to_unit(c) for c in p.choices])
            else:
                axes.append(list((np.arange(points_per_dim) + 0.5)
                                 / points_per_dim))
        mesh = np.meshgrid(*axes, indexing="ij")
        flat = np.stack([m.ravel() for m in mesh], axis=-1)
        return [self.from_unit(row) for row in flat]

    def to_config(self) -> List[Dict[str, Any]]:
        out = []
        for p in self.params:
            if p.kind == "categorical":
                out.append({"name": p.name, "type": p.kind,
                            "choices": list(p.choices)})
            else:
                out.append({"name": p.name, "type": p.kind,
                            "bounds": [p.low, p.high], "log": p.log})
        return out
