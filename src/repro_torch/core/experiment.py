"""Experiment definitions — the unit the CLI verbs operate on (paper §3.5).

An ``ExperimentConfig`` is what the user's experiment YAML deserializes into:
the search space, metric/goal, observation budget, parallel bandwidth
(paper: "how many of those evaluations may be run in parallel"), resource
requirements per trial (paper §3.5.1: "number of GPUs needed per model"),
and the optimizer choice.  A ``TrialSpec`` is the hermetic work unit — the
stand-in for the paper's Docker container.
"""
from __future__ import annotations

import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from repro_torch.core.space import Space

STATUS_PENDING = "pending"
STATUS_RUNNING = "running"
STATUS_COMPLETE = "complete"
STATUS_FAILED = "failed"
STATUS_DELETED = "deleted"


@dataclass
class Resources:
    """Per-trial resource request (paper §3.5.1)."""
    pool: str = "cpu"          # which cluster pool (heterogeneous, §2.3)
    chips: int = 1             # slice size within the pool

    def to_json(self):
        return {"pool": self.pool, "chips": self.chips}

    @classmethod
    def from_json(cls, d):
        return cls(d.get("pool", "cpu"), int(d.get("chips", 1)))


@dataclass
class ExperimentConfig:
    name: str
    space: Space
    metric: str = "objective"
    goal: str = "max"                      # max | min
    budget: int = 20                       # observation budget
    parallel: int = 4                      # parallel bandwidth
    optimizer: str = "gp"
    optimizer_options: Dict[str, Any] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    executor: str = "host"                 # host | slice | vmap
    max_retries: int = 1
    straggler_factor: float = 0.0          # 0 disables speculation
    early_stop: Optional[Dict[str, Any]] = None   # StoppingPolicy options
    report_every: int = 1                  # min step delta between service
                                           # reports (rung crossings always
                                           # go through — see Scheduler)
    prefetch: Optional[int] = None         # suggestion-pipeline queue depth
                                           # (None = auto: pump on for
                                           # model-based optimizers only;
                                           # 0 = fully synchronous)
    staleness: int = 8                     # K: prefetched suggestions are
                                           # invalidated after K new
                                           # observations
    entrypoint: Optional[str] = None       # "module:function" for CLI runs
    seed: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {
            "name": self.name, "space": self.space.to_config(),
            "metric": self.metric, "goal": self.goal, "budget": self.budget,
            "parallel": self.parallel, "optimizer": self.optimizer,
            "optimizer_options": self.optimizer_options,
            "resources": self.resources.to_json(), "executor": self.executor,
            "max_retries": self.max_retries,
            "straggler_factor": self.straggler_factor,
            "early_stop": self.early_stop,
            "report_every": self.report_every,
            "prefetch": self.prefetch,
            "staleness": self.staleness,
            "entrypoint": self.entrypoint,
            "seed": self.seed,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ExperimentConfig":
        return cls(
            name=d["name"], space=Space.from_config(d["space"]),
            metric=d.get("metric", "objective"), goal=d.get("goal", "max"),
            budget=int(d.get("budget", 20)),
            parallel=int(d.get("parallel", 4)),
            optimizer=d.get("optimizer", "gp"),
            optimizer_options=d.get("optimizer_options", {}),
            resources=Resources.from_json(d.get("resources", {})),
            executor=d.get("executor", "host"),
            max_retries=int(d.get("max_retries", 1)),
            straggler_factor=float(d.get("straggler_factor", 0.0)),
            early_stop=d.get("early_stop"),
            report_every=int(d.get("report_every", 1)),
            prefetch=(None if d.get("prefetch") is None
                      else int(d["prefetch"])),
            staleness=int(d.get("staleness", 8)),
            entrypoint=d.get("entrypoint"), seed=int(d.get("seed", 0)))


def new_experiment_id() -> str:
    return time.strftime("%Y%m%d-%H%M%S-") + uuid.uuid4().hex[:6]


@dataclass
class TrialSpec:
    """Hermetic trial: pure fn(assignment, ctx) -> float (the
    Docker-in-Docker limitation becomes 'trial fns must be self-contained')."""
    trial_id: str
    assignment: Dict[str, Any]
    attempt: int = 0
    speculative: bool = False
    suggestion_id: str = ""    # pending-suggestion handle at the service
    pauses: int = 0            # times the service paused this trial
    paused_obs: int = -1       # experiment-wide observation count at the
                               # last pause (-1 = never paused); the
                               # scheduler resumes a paused trial only
                               # after this grows (new rung information)
