"""Optimizer interface (ask/tell) + registry.

Conventions:
* maximization (the experiment config's goal='min' negates values upstream);
* failed observations carry value=None and are fed back to optimizers so
  they can avoid re-suggesting broken regions (paper §2.5: HPO surfaces
  model bugs as failed observations);
* ask() may be called concurrently with outstanding suggestions (parallel
  bandwidth) — optimizers must not block on pending results.
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.space import Assignment, Space


@dataclass
class Observation:
    assignment: Assignment
    value: Optional[float]                 # None => failed
    stddev: float = 0.0
    failed: bool = False
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"assignment": self.assignment, "value": self.value,
                "stddev": self.stddev, "failed": self.failed,
                "metadata": self.metadata}

    @classmethod
    def from_json(cls, d) -> "Observation":
        return cls(d["assignment"], d.get("value"), d.get("stddev", 0.0),
                   d.get("failed", False), d.get("metadata", {}))


class Optimizer(abc.ABC):
    #: True when ``ask`` costs enough (model fit / compile) that the
    #: suggestion service should run its prefetch pump for this optimizer.
    expensive_ask: bool = False
    #: True when ``ask`` accepts ``speculative=True`` — a cheaper,
    #: approximate proposal path (e.g. the GP's sparse subset-of-data
    #: posterior) the service may use to refill its prefetch queue when
    #: the exact path is saturated.  Synchronous asks and coalesced
    #: misses always use the exact path.
    speculative_ask: bool = False

    def sparse_eligible(self) -> bool:
        """True when ``ask(n, speculative=True)`` would actually use the
        approximate path *right now* (enough history, fitted model, …).
        The service checks this before labeling refills as sparse, so
        its sparse-traffic counters never count exact suggestions."""
        return False

    def __init__(self, space: Space, seed: int = 0, device=None):
        # ``device`` is where a model-based optimizer keeps its tensors;
        # the numpy-only optimizers accept it and ignore it
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.history: List[Observation] = []

    @abc.abstractmethod
    def ask(self, n: int = 1) -> List[Assignment]:
        ...

    def tell(self, observations: Sequence[Observation]) -> None:
        self.history.extend(observations)
        self._update(observations)

    def _update(self, observations: Sequence[Observation]) -> None:
        pass

    def forget(self, assignment: Assignment) -> None:
        """A previously-asked suggestion will never be observed (released
        back to the budget / experiment stopped): optimizers may drop any
        per-suggestion bookkeeping (e.g. constant-liar lies)."""

    def prewarm(self, max_history: int, batch: int = 8) -> int:
        """Move one-time setup cost (kernel builds and first-touch setup
        of the ask path) off the request path, sized for up to ``max_history`` observations and
        ``ask(batch)``-shaped requests.  Called by the suggestion
        service's prefetch pump at experiment creation and again as the
        history approaches the next shape bucket.  Returns the number of
        shape buckets newly warmed (0 = nothing to do)."""
        return 0

    def maintain(self) -> bool:
        """Perform deferred model maintenance (e.g. a pending
        hyperparameter refit) — the slow work a ``defer_fits`` optimizer
        keeps off the ``ask`` path.  Called by the suggestion service's
        pump when no request is waiting on the optimizer.  Returns True
        when work was done (callers may loop)."""
        return False

    def maintenance_due(self) -> bool:
        """True when deferred maintenance is owed — the cheap check the
        suggestion service makes before queueing a ``maintain`` job on
        the shared fit executor (see ``repro_torch.api.pipeline.FitExecutor``).
        Must not touch model state."""
        return False

    #: True when ``fit_spec`` returns batchable descriptors the shared
    #: fit executor may co-batch across experiments (one lane-batched dispatch
    #: per (runner, bucket, steps) group).  Optimizers
    #: without the split keep the plain two-phase ``fit_job`` path.
    batchable_fits: bool = False

    def fit_spec(self):
        """Snapshot the owed maintenance as a batchable fit descriptor
        (``repro_torch.core.suggest.bayesopt.FitSpec``-shaped: bucket, steps,
        arrays, a lane ``runner``, and an ``install(params, dt)``
        callback applied under the optimizer lock), or None.  Only
        meaningful when ``batchable_fits`` is True."""
        return None

    def fit_job(self):
        """Snapshot the owed maintenance as a two-phase job for the
        shared fit executor: ``fit_job()`` is called under the service's
        optimizer lock and returns None (nothing owed) or a ``run``
        callable; ``run()`` executes WITHOUT the lock (pure compute over
        copied state) and returns an ``install`` callable the executor
        applies under the lock.  The default wraps ``maintain`` so
        optimizers without a lock-free split still work — their compute
        just runs inside the install phase."""
        if not self.maintenance_due():
            return None

        def run():
            return lambda: self.maintain()
        return run

    def refit_schedule(self) -> Optional[Dict[str, Any]]:
        """Optional readout of the optimizer's live refit schedule
        (adaptive step budgets, fit/arrival latencies, deferred-fit
        debt).  Surfaced by the service in ``StatusResponse`` pump
        stats; None when the optimizer has nothing to report."""
        return None

    # ------------------------------------------------------------ helpers
    @property
    def successes(self) -> List[Observation]:
        return [o for o in self.history if not o.failed and o.value is not None]

    def best(self) -> Optional[Observation]:
        succ = self.successes
        return max(succ, key=lambda o: o.value) if succ else None

    # checkpoint/restore of optimizer state (experiment-level fault
    # tolerance: the suggestion service resumes from the observation log)
    def state(self) -> Dict[str, Any]:
        return {"history": [o.to_json() for o in self.history]}

    def restore(self, state: Dict[str, Any]) -> None:
        """Idempotent replay of a checkpointed observation log: only the
        tail beyond what this optimizer has already absorbed is fed to
        ``tell``, so a checkpoint restore followed by a resume replay (or
        two restores of the same log) never double-counts observations."""
        obs = [Observation.from_json(d) for d in state.get("history", [])]
        new = obs[len(self.history):]
        if new:
            self.tell(new)


class StoppingPolicy(abc.ABC):
    """Server-side early-stopping policy over trial metric streams.

    Owned by the suggestion service (not the scheduler): all workers of an
    experiment report into ONE policy instance, so pruning decisions are
    consistent across schedulers and survive restarts via ``state()`` /
    ``restore()`` (JSON-serializable rung snapshot) plus replay of the
    append-only metric log.

    ``report`` answers one of the protocol decisions: ``"continue"``,
    ``"stop"`` (final), or ``"pause"`` (release resources, keep the
    suggestion pending, resume from checkpoint on promotion).  ``version``
    must increase on every state mutation — the service uses it to decide
    when to re-persist the rung snapshot.
    """

    version: int = 0

    @abc.abstractmethod
    def report(self, trial_id: str, step: int, value: float) -> str:
        """Evaluate one progress report -> 'continue' | 'stop' | 'pause'."""

    def next_rung(self, trial_id: str) -> Optional[int]:
        """Smallest step at which this trial's next report matters (None =
        every report is equally (un)interesting)."""
        return None

    @abc.abstractmethod
    def state(self) -> Dict[str, Any]:
        """JSON-serializable snapshot (round-trips through ``restore``)."""

    @abc.abstractmethod
    def restore(self, state: Dict[str, Any]) -> None:
        """Wholesale-replace internal state from a ``state()`` snapshot."""


_REGISTRY: Dict[str, Any] = {}
_STOPPING_REGISTRY: Dict[str, Any] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def register_stopping(name: str):
    def deco(cls):
        _STOPPING_REGISTRY[name] = cls
        return cls
    return deco


def make_optimizer(name: str, space: Space, seed: int = 0, device=None,
                   **options) -> Optimizer:
    # import for side-effect registration
    from repro_torch.core.suggest import (bayesopt, evolution, grid, pso,  # noqa
                                    random_search, sobol)
    if name not in _REGISTRY:
        raise KeyError(f"unknown optimizer {name!r}; have {list(_REGISTRY)}")
    return _REGISTRY[name](space, seed=seed, device=device, **options)


def make_stopping_policy(options: Dict[str, Any],
                         goal: str = "max") -> StoppingPolicy:
    """Build the experiment's early-stopping policy from its config dict
    (``ExperimentConfig.early_stop``).  ``policy`` selects the registered
    implementation (default ``asha``); the rest are constructor options."""
    from repro_torch.core.suggest import asha  # noqa: side-effect registration
    opts = dict(options or {})
    name = opts.pop("policy", "asha")
    if name not in _STOPPING_REGISTRY:
        raise KeyError(f"unknown stopping policy {name!r}; "
                       f"have {list(_STOPPING_REGISTRY)}")
    return _STOPPING_REGISTRY[name](goal=goal, **opts)
