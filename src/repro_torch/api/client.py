"""``SuggestionClient`` — the transport-agnostic boundary between trial
execution (scheduler/workers) and the suggestion service (optimizer +
system-of-record store).

Everything above this line (``Scheduler``, ``Orchestrator``, worker loops)
talks only in protocol messages; everything below it (``LocalClient``
in-process, ``HTTPClient`` over the wire) is interchangeable.  This is the
paper's §3.5 split: the suggestion service owns optimizer state and the
observation log, workers just loop suggest -> evaluate -> observe.
"""
from __future__ import annotations

import abc
from typing import TYPE_CHECKING, Optional

from repro_torch.api.protocol import (BestResponse, CreateExperiment,
                                CreateResponse, Decision, ObserveRequest,
                                ObserveResponse, ReportRequest,
                                StatusResponse, SuggestBatch)

if TYPE_CHECKING:   # keep this module import-light: no core at runtime
    from repro_torch.core.suggest.base import Observation


class SuggestionClient(abc.ABC):
    """v1 suggest/observe protocol.  All methods are thread-safe; any of
    them may raise :class:`repro_torch.api.protocol.ApiError`."""

    @abc.abstractmethod
    def create_experiment(self, req: CreateExperiment) -> CreateResponse:
        """Create a new experiment, or resume the one named by
        ``req.exp_id`` (replaying its observation log into a fresh
        optimizer exactly once)."""

    @abc.abstractmethod
    def suggest(self, exp_id: str, count: int = 1) -> SuggestBatch:
        """Hand out up to ``count`` new pending suggestions.  Never
        exceeds ``budget - observations - pending``; never returns the
        same pending assignment twice."""

    @abc.abstractmethod
    def observe(self, req: ObserveRequest) -> ObserveResponse:
        """Report one suggestion's outcome.  First observe wins; later
        observes of the same suggestion_id come back ``duplicate=True``."""

    @abc.abstractmethod
    def report(self, req: ReportRequest) -> Decision:
        """Stream one intermediate (step, value) progress point.  The
        service persists it to the trial's metric log and answers with the
        experiment-wide early-stopping decision (continue/stop/pause) —
        ONE shared rung table for all workers of the experiment."""

    @abc.abstractmethod
    def release(self, exp_id: str, suggestion_id: str) -> bool:
        """Return an unevaluated pending suggestion to the budget."""

    def requeue(self, exp_id: str, suggestion_id: str,
                assignment: Optional[dict] = None) -> bool:
        """Park a pending suggestion for re-serving (dead-worker
        recovery): it keeps its id and constant-liar lie, and the next
        ``suggest`` hands it out exactly once.  With ``assignment`` this
        is the rebalance *transfer* form — install a previous owner's
        pending under its original id.  Backends without fleet support
        decline."""
        return False

    def drain(self, exp_id: str):
        """Quiesce one experiment ahead of an ownership handover and
        return its parked pending suggestions
        (:class:`repro_torch.api.protocol.DrainResponse`).  Backends without
        fleet support decline."""
        from repro_torch.api.protocol import DrainResponse
        return DrainResponse(drained=False)

    @abc.abstractmethod
    def status(self, exp_id: str) -> StatusResponse:
        ...

    @abc.abstractmethod
    def stop(self, exp_id: str, state: str = "stopped") -> StatusResponse:
        """Terminate the experiment and reclaim pending suggestions."""

    @abc.abstractmethod
    def best_response(self, exp_id: str) -> BestResponse:
        ...

    # ------------------------------------------------------- conveniences
    def best(self, exp_id: str) -> Optional["Observation"]:
        from repro_torch.core.suggest.base import Observation
        resp = self.best_response(exp_id)
        return Observation.from_json(resp.best) if resp.best else None

    def close(self) -> None:
        """Release transport resources (no-op for in-process clients)."""
