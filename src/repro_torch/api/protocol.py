"""Versioned suggestion-service wire protocol (v1).

The paper's workers drive a *suggestion service* through a narrow
suggest/observe loop (Orchestrate §2.1, §3.5).  This module is the typed
contract for that loop: every operation has a request and a response
dataclass with a stable JSON form, so the same messages flow through the
in-process ``LocalClient`` and the HTTP backend unchanged.

Operations (see API.md for the HTTP mapping):
  create   CreateExperiment  -> CreateResponse
  suggest  SuggestRequest    -> SuggestBatch
  observe  ObserveRequest    -> ObserveResponse
  report   ReportRequest     -> Decision
  release  ReleaseRequest    -> ReleaseResponse
  status   StatusRequest     -> StatusResponse
  stop     StopRequest       -> StatusResponse
  best     BestRequest       -> BestResponse

Pending-suggestion semantics: every assignment handed out by ``suggest``
carries a unique ``suggestion_id`` and stays *pending* until it is either
observed (exactly once — later observes are flagged duplicates) or
released.  The service never hands out more than
``budget - observations - pending`` new suggestions, so concurrent
workers can't oversubscribe the budget or receive the same pending
assignment twice.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

PROTOCOL_VERSION = "v1"

# ------------------------------------------------------------------ errors
E_BAD_REQUEST = "bad_request"                # 400
E_UNKNOWN_EXPERIMENT = "unknown_experiment"  # 404
E_UNKNOWN_SUGGESTION = "unknown_suggestion"  # 404
E_EXPERIMENT_EXISTS = "experiment_exists"    # 409
E_INTERNAL = "internal"                      # 500
E_FLEET_BUSY = "fleet_busy"                  # 503: every shard saturated
E_WRONG_SHARD = "wrong_shard"                # 421: routed past a map change
E_FENCED = "fenced"                          # 409: write carried a stale epoch

_HTTP_STATUS = {E_BAD_REQUEST: 400, E_UNKNOWN_EXPERIMENT: 404,
                E_UNKNOWN_SUGGESTION: 404, E_EXPERIMENT_EXISTS: 409,
                E_INTERNAL: 500, E_FLEET_BUSY: 503, E_WRONG_SHARD: 421,
                E_FENCED: 409}


# ------------------------------------------------------------------ epochs
# An ownership epoch is a ``[term, seq]`` pair compared lexicographically:
# ``term`` is the fleet manager's leadership term (bumped on every
# takeover, so a deposed manager's grants always lose) and ``seq`` is the
# manager's monotonically bumped grant counter (derived from the ShardMap
# version stream, so within one term a later handover always wins).  A
# standalone service runs at term 0.  See API.md §Fleet / Fencing.
EPOCH_ZERO = (0, 0)


def epoch_tuple(v) -> tuple:
    """Normalize a wire/storage epoch (2-list, tuple or None) to a
    comparable ``(term, seq)`` tuple of ints."""
    if v is None:
        return EPOCH_ZERO
    try:
        term, seq = v
        return (int(term), int(seq))
    except (TypeError, ValueError):
        raise ApiError(E_BAD_REQUEST, f"malformed epoch {v!r}")


class ApiError(Exception):
    """Service-level failure with a stable error code (API.md §Errors)."""

    def __init__(self, code: str, message: str):
        super().__init__(f"{code}: {message}")
        self.code = code
        self.message = message

    @property
    def http_status(self) -> int:
        return _HTTP_STATUS.get(self.code, 500)

    def to_json(self) -> Dict[str, Any]:
        return {"error": {"code": self.code, "message": self.message}}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ApiError":
        e = d.get("error", d)
        return cls(e.get("code", E_INTERNAL), e.get("message", ""))


# ----------------------------------------------------------------- messages
@dataclass
class CreateExperiment:
    """Create (or resume, when ``exp_id`` names an existing experiment).

    ``config`` may be empty *only* together with an ``exp_id``: the
    service then resumes the experiment from its stored config — the
    fleet failover path (a new owner shard adopts an experiment it has
    never seen, out of the shared system-of-record store).

    ``epoch`` is the manager-granted ownership epoch (``[term, seq]``,
    see module epoch helpers).  When present the adopting shard *claims*
    the experiment's fence record at that epoch, fencing every older
    incarnation; when absent the shard adopts at the stored epoch
    (standalone / same-map resume)."""
    config: Dict[str, Any]                  # ExperimentConfig.to_json()
    exp_id: Optional[str] = None
    epoch: Optional[List[int]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"version": PROTOCOL_VERSION, "config": self.config,
                "exp_id": self.exp_id,
                "epoch": list(self.epoch) if self.epoch else None}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "CreateExperiment":
        if not d.get("config") and not d.get("exp_id"):
            raise ApiError(E_BAD_REQUEST, "create requires 'config'")
        epoch = d.get("epoch")
        if epoch is not None:
            epoch = list(epoch_tuple(epoch))
        return cls(config=d.get("config") or {}, exp_id=d.get("exp_id"),
                   epoch=epoch)


@dataclass
class CreateResponse:
    exp_id: str
    resumed: bool = False
    observations: int = 0                   # already in the log on resume

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "resumed": self.resumed,
                "observations": self.observations}

    @classmethod
    def from_json(cls, d) -> "CreateResponse":
        return cls(d["exp_id"], d.get("resumed", False),
                   d.get("observations", 0))


@dataclass
class Suggestion:
    """One pending assignment; observe/release it by ``suggestion_id``."""
    suggestion_id: str
    assignment: Dict[str, Any]

    def to_json(self) -> Dict[str, Any]:
        return {"suggestion_id": self.suggestion_id,
                "assignment": self.assignment}

    @classmethod
    def from_json(cls, d) -> "Suggestion":
        return cls(d["suggestion_id"], d["assignment"])


@dataclass
class SuggestRequest:
    exp_id: str
    count: int = 1

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "count": self.count}

    @classmethod
    def from_json(cls, d) -> "SuggestRequest":
        count = int(d.get("count", 1))
        if count < 0:
            raise ApiError(E_BAD_REQUEST, f"count must be >= 0, got {count}")
        return cls(d.get("exp_id", ""), count)


@dataclass
class SuggestBatch:
    """May hold fewer than ``count`` suggestions: the service caps at
    ``budget - observations - pending`` (and returns none once stopped)."""
    suggestions: List[Suggestion] = field(default_factory=list)
    remaining: int = 0                      # budget headroom after this batch

    def __len__(self) -> int:
        return len(self.suggestions)

    def to_json(self) -> Dict[str, Any]:
        return {"suggestions": [s.to_json() for s in self.suggestions],
                "remaining": self.remaining}

    @classmethod
    def from_json(cls, d) -> "SuggestBatch":
        return cls([Suggestion.from_json(s) for s in d.get("suggestions", [])],
                   d.get("remaining", 0))


@dataclass
class ObserveRequest:
    """Report the outcome of one suggestion.  ``value`` is goal-normalized
    (maximize); ``failed=True`` with value None records a crash as data."""
    exp_id: str
    suggestion_id: str
    assignment: Dict[str, Any]
    value: Optional[float] = None
    stddev: float = 0.0
    failed: bool = False
    trial_id: str = ""
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "suggestion_id": self.suggestion_id,
                "assignment": self.assignment, "value": self.value,
                "stddev": self.stddev, "failed": self.failed,
                "trial_id": self.trial_id, "metadata": self.metadata}

    @classmethod
    def from_json(cls, d) -> "ObserveRequest":
        if "suggestion_id" not in d or "assignment" not in d:
            raise ApiError(E_BAD_REQUEST,
                           "observe requires 'suggestion_id' + 'assignment'")
        return cls(d.get("exp_id", ""), d["suggestion_id"], d["assignment"],
                   d.get("value"), d.get("stddev", 0.0),
                   d.get("failed", False), d.get("trial_id", ""),
                   d.get("metadata", {}))


@dataclass
class ObserveResponse:
    accepted: bool
    duplicate: bool = False                 # suggestion was already observed
    observations: int = 0                   # experiment-wide total

    def to_json(self) -> Dict[str, Any]:
        return {"accepted": self.accepted, "duplicate": self.duplicate,
                "observations": self.observations}

    @classmethod
    def from_json(cls, d) -> "ObserveResponse":
        return cls(d.get("accepted", False), d.get("duplicate", False),
                   d.get("observations", 0))


# ----------------------------------------------------------- trial events
DECISION_CONTINUE = "continue"
DECISION_STOP = "stop"
DECISION_PAUSE = "pause"


@dataclass
class ReportRequest:
    """Intermediate trial progress: one (step, value) point of the metric
    stream.  ``value`` is the *raw* metric — the service applies the
    experiment goal when it evaluates early-stopping rungs.  The service
    appends every report to the trial's ``metrics.jsonl`` and answers with
    a :class:`Decision`."""
    exp_id: str
    trial_id: str
    step: int
    value: float
    suggestion_id: str = ""                 # ties the stream to a pending
    metadata: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "trial_id": self.trial_id,
                "step": self.step, "value": self.value,
                "suggestion_id": self.suggestion_id,
                "metadata": self.metadata}

    @classmethod
    def from_json(cls, d) -> "ReportRequest":
        if "step" not in d or "value" not in d:
            raise ApiError(E_BAD_REQUEST,
                           "report requires 'step' + 'value'")
        if not d.get("trial_id") and not d.get("suggestion_id"):
            raise ApiError(E_BAD_REQUEST,
                           "report requires 'trial_id' or 'suggestion_id'")
        try:
            step, value = int(d["step"]), float(d["value"])
        except (TypeError, ValueError):
            raise ApiError(E_BAD_REQUEST,
                           f"report step/value must be numeric, got "
                           f"{d['step']!r}/{d['value']!r}")
        return cls(d.get("exp_id", ""), d.get("trial_id", ""),
                   step, value,
                   d.get("suggestion_id", ""), d.get("metadata", {}))


@dataclass
class Decision:
    """Service verdict on a progress report.

    decision   continue | stop | pause.  ``stop`` is final (the trial is
               outside the top 1/eta at a rung it crossed); ``pause``
               releases the trial's resources but keeps its suggestion
               pending so it can be resumed from checkpoint when the rung
               population shifts in its favor (promotion).
    next_rung  smallest step at which the service needs the *next* report
               from this trial (None = no early stopping configured).
               Workers use it to throttle reports without ever skipping a
               rung boundary.
    seq        service-assigned position in the experiment-wide metric
               stream (monotone; the rung-snapshot high-water mark).
    """
    decision: str = DECISION_CONTINUE
    next_rung: Optional[int] = None
    seq: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"decision": self.decision, "next_rung": self.next_rung,
                "seq": self.seq}

    @classmethod
    def from_json(cls, d) -> "Decision":
        return cls(d.get("decision", DECISION_CONTINUE), d.get("next_rung"),
                   d.get("seq", 0))


@dataclass
class ReleaseRequest:
    """Return an unevaluated suggestion to the budget (worker shutdown)."""
    exp_id: str
    suggestion_id: str

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "suggestion_id": self.suggestion_id}

    @classmethod
    def from_json(cls, d) -> "ReleaseRequest":
        if "suggestion_id" not in d:
            raise ApiError(E_BAD_REQUEST, "release requires 'suggestion_id'")
        return cls(d.get("exp_id", ""), d["suggestion_id"])


@dataclass
class ReleaseResponse:
    released: bool

    def to_json(self) -> Dict[str, Any]:
        return {"released": self.released}

    @classmethod
    def from_json(cls, d) -> "ReleaseResponse":
        return cls(d.get("released", False))


@dataclass
class StatusRequest:
    exp_id: str

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id}

    @classmethod
    def from_json(cls, d) -> "StatusRequest":
        return cls(d.get("exp_id", ""))


@dataclass
class StatusResponse:
    """``prefetched``/``pump`` describe the suggestion pipeline (additive
    v1 fields, API.md §Suggestion pipeline): ``prefetched`` is the number
    of pre-computed suggestions currently warm in the prefetch queue, and
    ``pump`` carries the pump's counters (hits, misses, coalesced,
    invalidated, prefilled, sparse_prefilled, prewarmed, alive, depth —
    plus, for live experiments, the optimizer's ``refit`` schedule and
    the shared fit executor's ``executor`` counters, API.md §Posterior
    approximation & refit scheduling) or ``None`` for a non-live
    experiment.

    ``epoch`` is the serving shard's ownership epoch for the experiment
    (``[term, seq]``, additive v1 field); ``transport`` carries the
    *client-side* HTTP retry/backoff counters (filled in by
    ``HTTPClient.status``, never sent by the service — additive v1
    field, API.md §Errors / Retries)."""
    exp_id: str
    state: str = "pending"
    name: str = ""
    budget: int = 0
    observations: int = 0
    failures: int = 0
    pending: int = 0
    best: Optional[Dict[str, Any]] = None   # Observation.to_json()
    prefetched: int = 0
    pump: Optional[Dict[str, Any]] = None
    epoch: Optional[List[int]] = None
    transport: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "state": self.state, "name": self.name,
                "budget": self.budget, "observations": self.observations,
                "failures": self.failures, "pending": self.pending,
                "best": self.best, "prefetched": self.prefetched,
                "pump": self.pump,
                "epoch": list(self.epoch) if self.epoch else None}

    @classmethod
    def from_json(cls, d) -> "StatusResponse":
        epoch = d.get("epoch")
        return cls(d.get("exp_id", ""), d.get("state", "pending"),
                   d.get("name", ""), d.get("budget", 0),
                   d.get("observations", 0), d.get("failures", 0),
                   d.get("pending", 0), d.get("best"),
                   d.get("prefetched", 0), d.get("pump"),
                   list(epoch_tuple(epoch)) if epoch else None)


@dataclass
class StopRequest:
    """Terminate the experiment; pending suggestions are reclaimed."""
    exp_id: str
    state: str = "stopped"                  # stopped | deleted

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "state": self.state}

    @classmethod
    def from_json(cls, d) -> "StopRequest":
        return cls(d.get("exp_id", ""), d.get("state", "stopped"))


@dataclass
class BestRequest:
    exp_id: str

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id}

    @classmethod
    def from_json(cls, d) -> "BestRequest":
        return cls(d.get("exp_id", ""))


@dataclass
class BestResponse:
    best: Optional[Dict[str, Any]] = None   # Observation.to_json()

    def to_json(self) -> Dict[str, Any]:
        return {"best": self.best}

    @classmethod
    def from_json(cls, d) -> "BestResponse":
        return cls(d.get("best"))


# --------------------------------------------------------------- batching
# Multiplexed transport plane (additive v1, API.md §Transport batching):
# a BatchRequest carries an *ordered* list of typed data-plane ops
# (observe / report / release / requeue) and is applied per experiment in
# op order, so one wire round trip replaces N.  ``batch_id`` is client-
# assigned and unique per batch; the server keeps a bounded dedupe window
# of applied batches so a transport-level retry of the same batch_id
# replays the recorded per-op results instead of re-applying — batches
# are exactly-once even though the POST is retried like any idempotent
# verb.  Each op answers individually: ``ok`` + the op's normal response
# payload, or a typed error (e.g. every op of a fenced zombie's batch
# answers ``fenced`` — item-by-item, never partially ghost-applied).

BATCH_OP_KINDS = ("observe", "report", "release", "requeue")


@dataclass
class BatchOp:
    """One typed op inside a batch.  ``seq`` is the client's per-batch
    position (dense, 0-based) — results echo it so a caller can match
    them back without relying on list order."""
    seq: int
    op: str                                 # one of BATCH_OP_KINDS
    payload: Dict[str, Any]                 # the op's request to_json()

    def to_json(self) -> Dict[str, Any]:
        return {"seq": self.seq, "op": self.op, "payload": self.payload}

    @classmethod
    def from_json(cls, d) -> "BatchOp":
        op = d.get("op")
        if op not in BATCH_OP_KINDS:
            raise ApiError(E_BAD_REQUEST, f"unknown batch op {op!r}")
        return cls(int(d.get("seq", 0)), op, d.get("payload") or {})


@dataclass
class BatchRequest:
    batch_id: str
    ops: List[BatchOp] = field(default_factory=list)

    def to_json(self) -> Dict[str, Any]:
        return {"version": PROTOCOL_VERSION, "batch_id": self.batch_id,
                "ops": [o.to_json() for o in self.ops]}

    @classmethod
    def from_json(cls, d) -> "BatchRequest":
        if not d.get("batch_id"):
            raise ApiError(E_BAD_REQUEST, "batch requires 'batch_id'")
        return cls(d["batch_id"],
                   [BatchOp.from_json(o) for o in d.get("ops", [])])


@dataclass
class BatchOpResult:
    """Per-op outcome: ``result`` is the op's normal response JSON when
    ``ok``, ``error`` is an ``{"code", "message"}`` pair otherwise (same
    codes as the unbatched endpoints — API.md §Transport batching has the
    per-op error table)."""
    seq: int
    ok: bool
    result: Optional[Dict[str, Any]] = None
    error: Optional[Dict[str, Any]] = None

    @classmethod
    def success(cls, seq: int, result: Dict[str, Any]) -> "BatchOpResult":
        return cls(seq, True, result=result)

    @classmethod
    def failure(cls, seq: int, err: ApiError) -> "BatchOpResult":
        return cls(seq, False,
                   error={"code": err.code, "message": err.message})

    @property
    def error_code(self) -> Optional[str]:
        return (self.error or {}).get("code") if not self.ok else None

    def to_json(self) -> Dict[str, Any]:
        return {"seq": self.seq, "ok": self.ok, "result": self.result,
                "error": self.error}

    @classmethod
    def from_json(cls, d) -> "BatchOpResult":
        return cls(int(d.get("seq", 0)), bool(d.get("ok")),
                   d.get("result"), d.get("error"))


@dataclass
class BatchResponse:
    """``replayed`` marks a dedupe-window hit: the batch was already
    applied and these are the recorded results of the first
    application."""
    batch_id: str
    results: List[BatchOpResult] = field(default_factory=list)
    replayed: bool = False

    def to_json(self) -> Dict[str, Any]:
        return {"batch_id": self.batch_id,
                "results": [r.to_json() for r in self.results],
                "replayed": self.replayed}

    @classmethod
    def from_json(cls, d) -> "BatchResponse":
        return cls(d.get("batch_id", ""),
                   [BatchOpResult.from_json(r) for r in d.get("results", [])],
                   bool(d.get("replayed", False)))


# ------------------------------------------------------------------- fleet
# Messages for the fleet control plane (repro_torch.fleet): shards and
# schedulers heartbeat to the FleetManager, which answers with the
# current shard-map version so clients know when to re-route.  See
# API.md §Fleet.

@dataclass
class RequeueRequest:
    """Hand a *pending* suggestion back to the serving queue (dead-worker
    recovery): the suggestion keeps its id and its constant-liar lie, and
    the next ``suggest`` on this experiment serves it — exactly once —
    before any fresh speculation.

    ``assignment`` is the *transfer* form (rebalance handover): when the
    suggestion id is unknown to the receiving shard — it was minted by the
    previous owner — the assignment lets the new owner install it as a
    parked pending under the same id instead of rejecting it."""
    exp_id: str
    suggestion_id: str
    assignment: Optional[Dict[str, Any]] = None

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id, "suggestion_id": self.suggestion_id,
                "assignment": self.assignment}

    @classmethod
    def from_json(cls, d) -> "RequeueRequest":
        if "suggestion_id" not in d:
            raise ApiError(E_BAD_REQUEST, "requeue requires 'suggestion_id'")
        return cls(d.get("exp_id", ""), d["suggestion_id"],
                   d.get("assignment"))


@dataclass
class DrainRequest:
    """Quiesce one experiment on its current owner ahead of a handover:
    stop the prefetch pump, retire the speculative queue, park the pending
    set, and answer with the parked suggestions so the manager can
    transfer them to the new owner.  Idempotent; a drained experiment
    answers ``wrong_shard`` to later data-plane calls so clients re-route."""
    exp_id: str

    def to_json(self) -> Dict[str, Any]:
        return {"exp_id": self.exp_id}

    @classmethod
    def from_json(cls, d) -> "DrainRequest":
        return cls(d.get("exp_id", ""))


@dataclass
class DrainResponse:
    drained: bool = False
    pending: List[Suggestion] = field(default_factory=list)
    observations: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"drained": self.drained,
                "pending": [s.to_json() for s in self.pending],
                "observations": self.observations}

    @classmethod
    def from_json(cls, d) -> "DrainResponse":
        return cls(d.get("drained", False),
                   [Suggestion.from_json(s) for s in d.get("pending", [])],
                   d.get("observations", 0))


@dataclass
class HeartbeatRequest:
    """One liveness beat from a worker (a scheduler process or a shard).
    ``holdings`` maps exp_id -> the pending suggestion_ids this worker
    currently holds; the manager requeues exactly these if the worker is
    later declared dead."""
    worker_id: str
    kind: str = "scheduler"                 # scheduler | shard
    holdings: Dict[str, List[str]] = field(default_factory=dict)
    seq: int = 0                            # per-worker beat counter

    def to_json(self) -> Dict[str, Any]:
        return {"worker_id": self.worker_id, "kind": self.kind,
                "holdings": self.holdings, "seq": self.seq}

    @classmethod
    def from_json(cls, d) -> "HeartbeatRequest":
        if "worker_id" not in d:
            raise ApiError(E_BAD_REQUEST, "heartbeat requires 'worker_id'")
        return cls(d["worker_id"], d.get("kind", "scheduler"),
                   {k: list(v) for k, v in (d.get("holdings") or {}).items()},
                   int(d.get("seq", 0)))


@dataclass
class HeartbeatResponse:
    """``map_version`` lets a client detect shard-map changes without
    polling ``/fleet/map``; ``period`` is the manager-prescribed beat
    interval (seconds)."""
    state: str = "alive"                    # registered|alive|suspect|dead
    map_version: int = 0
    period: float = 1.0

    def to_json(self) -> Dict[str, Any]:
        return {"state": self.state, "map_version": self.map_version,
                "period": self.period}

    @classmethod
    def from_json(cls, d) -> "HeartbeatResponse":
        return cls(d.get("state", "alive"), int(d.get("map_version", 0)),
                   float(d.get("period", 1.0)))


@dataclass
class ShardMap:
    """Versioned routing table: consistent-hash ownership plus explicit
    per-experiment overrides (admission-control redirects and failover
    reassignments).  The version increments on every membership or
    override change; clients treat a version bump as 'recompute all
    routes'."""
    version: int = 0
    shards: Dict[str, str] = field(default_factory=dict)   # shard_id -> url
    overrides: Dict[str, str] = field(default_factory=dict)  # exp -> shard_id

    def to_json(self) -> Dict[str, Any]:
        return {"version": self.version, "shards": self.shards,
                "overrides": self.overrides}

    @classmethod
    def from_json(cls, d) -> "ShardMap":
        return cls(int(d.get("version", 0)), dict(d.get("shards") or {}),
                   dict(d.get("overrides") or {}))
