"""Client-side write-behind batching plane (API.md §Transport batching).

The fleet hot path is dominated by small fire-and-forget data-plane
calls — observe, release, and the below-rung majority of reports.  Tune
(arxiv 1807.05118) treats this traffic as a stream to be amortized, not
per-call RPC; :class:`WriteBehind` is that stream's client half.  Ops are
enqueued into per-*lane* FIFO queues (one lane per destination — a plain
``HTTPClient`` has one lane, a ``FleetClient`` one per owning shard) and
a flusher thread ships each lane as ONE :class:`BatchRequest` when any
trigger fires:

* **size** — the lane reached ``max_ops`` queued ops;
* **deadline** — the lane's oldest op aged past ``deadline`` (~10 ms);
* **blocking call** — the owner calls :meth:`flush` before any verb that
  must observe queued effects (suggest / status / create / stop / a
  rung-crossing report), draining the queue on the caller's own
  keep-alive connection so per-experiment op order is preserved.

Exactly-once: every batch carries a client-unique ``batch_id`` and is
sent as an *idempotent* POST — the server keeps a bounded dedupe window
and replays the recorded per-op results if a transport retry re-delivers
an already-applied batch, so the full-jitter backoff machinery retries
whole batches safely.

Ops never carry waiters: a call that needs its real result (a report
that can cross an ASHA rung, per :class:`DecisionGate`) flushes the
queue and then issues the plain unbatched call — same ordering, no
parked threads inside the flusher.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.api.protocol import (ApiError, BatchOp, BatchRequest,
                                      BatchResponse, DECISION_CONTINUE,
                                      Decision, E_INTERNAL)

OP_OBSERVE = "observe"
OP_REPORT = "report"
OP_RELEASE = "release"
OP_REQUEUE = "requeue"

FLUSH_MAX_OPS = 64         # size trigger: ship a lane at this many ops
FLUSH_DEADLINE_S = 0.010   # age trigger: oldest queued op waits at most this
MAX_OP_ERRORS = 64         # bounded per-client record of failed ops

_ALL_LANES = object()      # flush() sentinel: drain every lane


class QueuedOp:
    """One enqueued fire-and-forget op.  ``attempts`` counts re-enqueues
    after per-op or whole-batch failures (the owner's ``on_result`` /
    ``on_send_failure`` hooks bound it)."""

    __slots__ = ("kind", "payload", "attempts", "enqueued_at")

    def __init__(self, kind: str, payload: Dict[str, Any], attempts: int = 0):
        self.kind = kind
        self.payload = payload
        self.attempts = attempts
        self.enqueued_at = time.monotonic()

    @property
    def exp_id(self) -> str:
        return self.payload.get("exp_id", "")


class WriteBehind:
    """Per-lane op queues + one flusher thread.

    ``send(lane, BatchRequest) -> BatchResponse`` is the owner's
    transport (it may raise ``ApiError`` after its own retries).
    ``on_result(lane, op, result, error) -> bool`` sees every op outcome
    — a ``BatchOpResult`` on success, an ``ApiError`` on per-op failure —
    and returns True when it fully handled the op (e.g. re-homed and
    re-enqueued it); unhandled failures land in ``stats``/``op_errors``.
    ``on_send_failure(lane, ops, exc) -> bool`` likewise for a whole
    batch that never got a response.  ``after_flush()`` runs once per
    shipped batch (heartbeat piggyback hook)."""

    def __init__(self, send: Callable[[Any, BatchRequest], BatchResponse],
                 max_ops: int = FLUSH_MAX_OPS,
                 deadline: float = FLUSH_DEADLINE_S,
                 on_result: Optional[Callable] = None,
                 on_send_failure: Optional[Callable] = None,
                 after_flush: Optional[Callable[[], None]] = None,
                 name: str = "write-behind"):
        self._send = send
        self.max_ops = max(1, int(max_ops))
        self.deadline = max(0.0, float(deadline))
        self._on_result = on_result
        self._on_send_failure = on_send_failure
        self._after_flush = after_flush
        self._name = name
        self._lanes: Dict[Any, List[QueuedOp]] = {}
        self._cv = threading.Condition(threading.Lock())
        # serializes batch sends: lane order is FIFO because at most one
        # flush (thread or blocking caller) is shipping at a time
        self._send_lock = threading.RLock()
        self._nonce = uuid.uuid4().hex[:8]
        self._batch_n = 0
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self.stats = {"batches": 0, "ops": 0, "replayed": 0,
                      "op_errors": 0, "send_failures": 0}
        self.op_errors: List[dict] = []

    # ------------------------------------------------------------- enqueue
    def enqueue(self, kind: str, payload: Dict[str, Any],
                lane: Any = None, attempts: int = 0) -> QueuedOp:
        op = QueuedOp(kind, payload, attempts=attempts)
        with self._cv:
            if self._stopped:
                raise ApiError(E_INTERNAL, "write-behind is closed")
            self._lanes.setdefault(lane, []).append(op)
            self._ensure_thread()
            self._cv.notify_all()
        return op

    def depth(self, lane: Any = _ALL_LANES) -> int:
        with self._cv:
            if lane is _ALL_LANES:
                return sum(len(q) for q in self._lanes.values())
            return len(self._lanes.get(lane) or ())

    def _ensure_thread(self) -> None:
        # holding self._cv
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._loop,
                                            name=self._name, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------- flushing
    def _loop(self) -> None:
        while True:
            with self._cv:
                live = [l for l, q in self._lanes.items() if q]
                if self._stopped and not live:
                    return
                now = time.monotonic()
                due, next_due = [], None
                for lane in live:
                    q = self._lanes[lane]
                    at = q[0].enqueued_at + self.deadline
                    if (len(q) >= self.max_ops or at <= now
                            or self._stopped):
                        due.append(lane)
                    elif next_due is None or at < next_due:
                        next_due = at
                if not due:
                    self._cv.wait(timeout=(max(0.0, next_due - now)
                                           if next_due is not None else 0.2))
                    continue
            for lane in due:
                self._flush_lane(lane)

    def flush(self, lane: Any = _ALL_LANES) -> None:
        """Drain synchronously on the calling thread (the blocking-verb
        trigger): every op queued at call time is shipped before this
        returns.  Empty queues return without touching the send lock —
        the common case once the deadline flusher has shipped, and a
        convoy point if callers serialized on it just to find nothing."""
        if lane is not _ALL_LANES:
            with self._cv:
                if not self._lanes.get(lane):
                    return
            self._flush_lane(lane)
            return
        while True:
            with self._cv:
                live = [l for l, q in self._lanes.items() if q]
            if not live:
                return
            for l in live:
                self._flush_lane(l)

    def _flush_lane(self, lane: Any) -> None:
        with self._send_lock:
            while True:
                with self._cv:
                    q = self._lanes.get(lane)
                    if not q:
                        return
                    ops = q[:self.max_ops]
                    self._lanes[lane] = q[self.max_ops:]
                self._ship(lane, ops)

    def _ship(self, lane: Any, ops: List[QueuedOp]) -> None:
        # holding self._send_lock
        self._batch_n += 1
        req = BatchRequest(f"b{self._nonce}-{self._batch_n}",
                           [BatchOp(i, op.kind, op.payload)
                            for i, op in enumerate(ops)])
        try:
            resp = self._send(lane, req)
        except BaseException as e:
            self.stats["send_failures"] += 1
            if self._on_send_failure is not None \
                    and self._on_send_failure(lane, ops, e):
                return
            err = (e if isinstance(e, ApiError)
                   else ApiError(E_INTERNAL, f"{type(e).__name__}: {e}"))
            for op in ops:
                self._record_failure(lane, op, err)
            return
        self.stats["batches"] += 1
        self.stats["ops"] += len(ops)
        if resp.replayed:
            self.stats["replayed"] += 1
        by_seq = {r.seq: r for r in resp.results}
        for i, op in enumerate(ops):
            r = by_seq.get(i)
            if r is None:
                self._record_failure(lane, op, ApiError(
                    E_INTERNAL, f"batch {req.batch_id}: no result for "
                                f"op seq {i}"))
            elif r.ok:
                if self._on_result is not None:
                    self._on_result(lane, op, r, None)
            else:
                self._record_failure(
                    lane, op, ApiError.from_json({"error": r.error or {}}),
                    result=r)
        if self._after_flush is not None:
            try:
                self._after_flush()
            except Exception:
                pass

    def _record_failure(self, lane: Any, op: QueuedOp, err: ApiError,
                        result=None) -> None:
        if self._on_result is not None \
                and self._on_result(lane, op, result, err):
            return
        self.stats["op_errors"] += 1
        self.op_errors.append({"op": op.kind, "exp_id": op.exp_id,
                               "code": err.code, "message": err.message})
        if len(self.op_errors) > MAX_OP_ERRORS:
            del self.op_errors[:MAX_OP_ERRORS // 2]

    def close(self) -> None:
        """Flush everything still queued, then stop the flusher."""
        with self._cv:
            self._stopped = True
            t = self._thread
            self._cv.notify_all()
        self.flush()
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)


# ---------------------------------------------------------- decision gate
_UNKNOWN = object()


class DecisionGate:
    """Which reports may ride the batch (API.md §Transport batching).

    The service's :class:`Decision.next_rung` is the smallest step at
    which the *next* report from a trial can change policy state; every
    report strictly below it is CONTINUE by construction and is safe to
    fire-and-forget.  A report blocks for its real decision when the
    cached rung is unknown (first report of a trial) or ``step >=
    next_rung`` (it can cross the rung).  ``next_rung is None`` — no
    early stopping configured — never blocks after the first report.

    A non-CONTINUE decision arriving on a *batched* result (the
    experiment was stopped out from under the trial) is stashed and
    delivered on that trial's next report, bounding wind-down latency to
    one report interval."""

    MAX_TRIALS = 4096      # bounded: evict oldest trial keys

    def __init__(self):
        self._lock = threading.Lock()
        self._rungs: Dict[Tuple[str, str], Optional[int]] = {}
        self._stash: Dict[Tuple[str, str], Decision] = {}

    @staticmethod
    def key(req) -> Tuple[str, str]:
        return (req.exp_id, req.suggestion_id or req.trial_id)

    def blocking(self, req) -> bool:
        with self._lock:
            rung = self._rungs.get(self.key(req), _UNKNOWN)
        if rung is _UNKNOWN:
            return True
        return rung is not None and int(req.step) >= int(rung)

    def note(self, key: Tuple[str, str], decision: Decision) -> None:
        with self._lock:
            self._rungs[key] = decision.next_rung
            while len(self._rungs) > self.MAX_TRIALS:
                self._rungs.pop(next(iter(self._rungs)))
            if decision.decision != DECISION_CONTINUE:
                self._stash[key] = decision
                while len(self._stash) > self.MAX_TRIALS:
                    self._stash.pop(next(iter(self._stash)))

    def take_stashed(self, req) -> Optional[Decision]:
        with self._lock:
            return self._stash.pop(self.key(req), None)

    def ride_decision(self, req) -> Decision:
        """Synthetic CONTINUE for a riding report (``seq=0`` marks it as
        client-synthesized — the real seq arrives with the batch)."""
        with self._lock:
            return Decision(DECISION_CONTINUE,
                            next_rung=self._rungs.get(self.key(req)), seq=0)
