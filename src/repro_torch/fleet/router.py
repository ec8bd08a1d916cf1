"""FleetClient: a ``SuggestionClient`` that makes a sharded fleet look
like one suggestion service.

Routing: creates go through the FleetManager (that's where admission
control lives — a saturated owner shard redirects the experiment, a
saturated fleet answers ``fleet_busy``); everything after the create goes
*directly* to the owning shard, so the manager is never on the
suggest/observe hot path.  The owner is resolved from the cached
:class:`~repro_torch.api.protocol.ShardMap` — explicit override, else the
consistent-hash ring the client rebuilds locally from the map (blake2b is
process-stable, so client and manager always agree on ring ownership).

Failure handling: a routed call that fails with ``service unreachable`` /
``unknown_experiment`` / ``wrong_shard`` forces a map refresh, re-homes
the experiment onto the current owner (a config-less create resumes it
from the shared store — or from this client's cached config when the
store isn't shared), and retries once.  Until the manager has declared
the dead shard dead the retry may fail again; callers loop at their own
cadence (the scheduler already treats suggest errors as transient).

Heartbeats: a daemon thread beats every manager-prescribed ``period``
carrying this worker's *holdings* — the pending suggestion_ids it has
taken and not yet observed/released, per experiment.  If this process
dies, the manager requeues exactly those so survivors pick them up.

Batching (``batch=True``): the transport plane (API.md §Transport
batching) keeps one write-behind lane per *owning shard* — observe /
release / requeue / below-rung reports enqueue into the owner's lane and
ship as one ``BatchRequest`` per shard per flush trigger.  A per-op
``wrong_shard`` / ``fenced`` result re-homes and re-enqueues just that op
on the new owner's lane; holdings shrink only once a flush confirms the
op (a crash in between means the manager requeues an already-observed
suggestion, which the shard's closed-set dedupe absorbs — the safe
direction).  When a heartbeat is due, it piggybacks on the flush instead
of waiting for the periodic timer.
"""
from __future__ import annotations

import threading
import time
import uuid
from typing import Dict, List, Optional, Set, Union

from repro_torch.api.client import SuggestionClient
from repro_torch.api.http import HTTPClient
from repro_torch.api.protocol import (ApiError, BestResponse, CreateExperiment,
                                      CreateResponse, Decision, E_FENCED,
                                      E_INTERNAL, E_UNKNOWN_EXPERIMENT,
                                      E_WRONG_SHARD, HeartbeatRequest,
                                      HeartbeatResponse, ObserveRequest,
                                      ObserveResponse, ReportRequest, ShardMap,
                                      StatusResponse, SuggestBatch)
from repro_torch.api.transport import (FLUSH_DEADLINE_S, FLUSH_MAX_OPS,
                                       DecisionGate, OP_OBSERVE, OP_RELEASE,
                                       OP_REPORT, OP_REQUEUE, WriteBehind)
from repro_torch.fleet.hashring import HashRing

# ``fenced`` is retryable from the client's seat: the answering shard
# lost ownership, so a map refresh + re-route reaches the new owner
_RETRYABLE = (E_INTERNAL, E_UNKNOWN_EXPERIMENT, E_WRONG_SHARD, E_FENCED)


class _InprocFleet:
    """Manager access for a FleetClient living in the manager's process
    (tests, single-process fleets)."""

    def __init__(self, manager):
        self.manager = manager

    def fetch_map(self) -> ShardMap:
        return self.manager.shard_map()

    def create(self, req: CreateExperiment):
        resp, shard_id, _url, version = self.manager.create_experiment(req)
        return resp, shard_id, version

    def heartbeat(self, req: HeartbeatRequest) -> HeartbeatResponse:
        return self.manager.heartbeat(req)

    def shard_client(self, shard_id: str, url: str):
        handle = self.manager._shards.get(shard_id)
        if handle is None:
            raise ApiError(E_WRONG_SHARD, f"shard {shard_id!r} left the map")
        return handle.client

    def drop_urls(self, urls) -> None:
        pass

    def close(self) -> None:
        pass


class _HttpFleet:
    """Manager access over the wire (the ``serve-fleet`` verb)."""

    def __init__(self, url: str, timeout: float = 30.0):
        self._c = HTTPClient(url, timeout=timeout)
        self._clients: Dict[str, HTTPClient] = {}   # url -> client
        self._lock = threading.Lock()
        self.timeout = timeout

    def fetch_map(self) -> ShardMap:
        return ShardMap.from_json(self._c._call("GET", "/fleet/map"))

    def create(self, req: CreateExperiment):
        d = self._c._call("POST", "/fleet/experiments", req.to_json())
        return (CreateResponse.from_json(d), d.get("shard_id", ""),
                int(d.get("map_version", 0)))

    def heartbeat(self, req: HeartbeatRequest) -> HeartbeatResponse:
        return HeartbeatResponse.from_json(
            self._c._call("POST", "/fleet/heartbeat", req.to_json()))

    def shard_client(self, shard_id: str, url: str) -> HTTPClient:
        if not url:
            raise ApiError(E_WRONG_SHARD,
                           f"shard {shard_id!r} has no routable url")
        with self._lock:
            c = self._clients.get(url)
            if c is None:
                c = self._clients[url] = HTTPClient(url, timeout=self.timeout)
            return c

    def drop_urls(self, urls) -> None:
        """Sever keep-alive connections to shards that left the map: a
        half-dead shard can keep serving already-open connections after
        its listener is gone, and routing through one would split writes
        across two owners."""
        with self._lock:
            dropped = [self._clients.pop(u) for u in urls
                       if u in self._clients]
        for c in dropped:
            c.close()

    def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
        for c in clients:
            c.close()
        self._c.close()


class FleetClient(SuggestionClient):
    """One client for the whole fleet.  ``fleet`` is either a
    ``FleetManager`` instance (in-process) or a ``serve-fleet`` URL.

    ``replicas`` must match the manager's ring replicas (both default to
    64) — ring ownership is computed on both sides.
    """

    def __init__(self, fleet, worker_id: Optional[str] = None,
                 heartbeat: bool = True, timeout: float = 30.0,
                 replicas: int = 64, fault_plan=None,
                 batch: bool = False, batch_max: int = FLUSH_MAX_OPS,
                 batch_deadline: float = FLUSH_DEADLINE_S):
        if isinstance(fleet, str):
            self._proxy = _HttpFleet(fleet, timeout=timeout)
        else:
            self._proxy = _InprocFleet(fleet)
        self.worker_id = worker_id or f"sched-{uuid.uuid4().hex[:8]}"
        # chaos harness: a ``core.faults.FaultPlan`` consulted per routed
        # call (edge worker_id -> shard_id) and per heartbeat (-> manager)
        self._fault_plan = fault_plan
        # audit trail (bounded): heartbeat failures are recorded here
        # with a dedupe counter instead of being swallowed silently
        self.events: List[dict] = []
        self._beat_errors: Dict[str, int] = {}
        self._map = ShardMap(version=-1)
        self._ring = HashRing(replicas=replicas)
        self._replicas = replicas
        self._assigned: Dict[str, str] = {}   # exp_id -> shard_id (authoritative)
        self._configs: Dict[str, dict] = {}   # exp_id -> config (for re-home)
        self._holdings: Dict[str, Set[str]] = {}
        self._period = 1.0
        self._seq = 0
        self._lock = threading.RLock()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._last_beat = time.monotonic()
        self._wb: Optional[WriteBehind] = None
        self._gate: Optional[DecisionGate] = None
        if batch:
            self._gate = DecisionGate()
            self._wb = WriteBehind(self._send_shard_batch,
                                   max_ops=batch_max,
                                   deadline=batch_deadline,
                                   on_result=self._on_batch_result,
                                   after_flush=self._maybe_prompt_beat,
                                   name=f"wb-{self.worker_id}")
        self._refresh_map(force=True)
        if heartbeat:
            self.beat()                       # register before first suggest
            self._hb_thread = threading.Thread(target=self._beat_loop,
                                               name="fleet-heartbeat",
                                               daemon=True)
            self._hb_thread.start()

    # --------------------------------------------------------------- map
    def _refresh_map(self, force: bool = False,
                     version: Optional[int] = None) -> None:
        with self._lock:
            if not force and version is not None \
                    and version <= self._map.version:
                return
            m = self._proxy.fetch_map()
            if m.version == self._map.version and not force:
                return
            gone = [u for sid, u in self._map.shards.items()
                    if u and u not in m.shards.values()]
            self._map = m
            ring = HashRing(replicas=self._replicas)
            for sid in m.shards:
                ring.add(sid)
            self._ring = ring
            # assignments to shards that left the map fall back to the ring
            for exp, sid in list(self._assigned.items()):
                if sid not in m.shards:
                    del self._assigned[exp]
        # outside the lock: connection close can block on socket teardown
        if gone:
            self._proxy.drop_urls(gone)

    @property
    def map_version(self) -> int:
        with self._lock:
            return self._map.version

    def _owner(self, exp_id: str) -> str:
        with self._lock:
            sid = (self._map.overrides.get(exp_id)
                   or self._assigned.get(exp_id)
                   or self._ring.owner(exp_id))
            if sid is None or sid not in self._map.shards:
                sid = self._ring.owner(exp_id)
            if sid is None:
                raise ApiError(E_WRONG_SHARD, "fleet has no shards")
            return sid

    def _client_for(self, exp_id: str):
        with self._lock:
            sid = self._owner(exp_id)
            url = self._map.shards.get(sid, "")
        if self._fault_plan is not None:
            try:
                self._fault_plan.gate(self.worker_id, sid)
            except ConnectionRefusedError as e:
                # surface like a real transport failure so the routed
                # retry/refresh machinery handles injected partitions
                raise ApiError(E_INTERNAL, f"service unreachable: {e}")
        return self._proxy.shard_client(sid, url)

    # ----------------------------------------------------------- routing
    def _routed(self, exp_id: str, fn):
        """Run ``fn(shard_client)`` against the current owner; on a
        retryable failure refresh the map, re-home, retry once."""
        try:
            return fn(self._client_for(exp_id))
        except ApiError as e:
            if e.code not in _RETRYABLE:
                raise
            if e.code in (E_WRONG_SHARD, E_FENCED):
                # the answering shard disowned the experiment (drained or
                # fenced): the cached assignment is provably stale — drop
                # it so re-homing follows the ring/overrides, not the old
                # owner (re-creating there would resurrect a zombie)
                with self._lock:
                    self._assigned.pop(exp_id, None)
        self._refresh_map(force=True)
        self._rehome(exp_id)
        return fn(self._client_for(exp_id))

    def _rehome(self, exp_id: str) -> None:
        """Make sure the current owner is serving ``exp_id``: config-less
        create resumes it from the shared store; the cached config covers
        fleets without one.  Idempotent — resuming a live experiment is a
        no-op service-side."""
        cfg = self._configs.get(exp_id, {})
        try:
            client = self._client_for(exp_id)
            client.create_experiment(CreateExperiment(config=cfg,
                                                      exp_id=exp_id))
            with self._lock:
                self._assigned[exp_id] = self._owner(exp_id)
        except ApiError:
            pass    # let the retried call surface the real failure

    # ---------------------------------------------------------- batching
    def flush(self) -> None:
        """Drain every shard lane (no-op when batching is off)."""
        if self._wb is not None:
            self._wb.flush()

    def _enqueue_op(self, kind: str, payload: dict, exp_id: str) -> None:
        self._wb.enqueue(kind, payload, lane=self._owner(exp_id))

    def _send_shard_batch(self, shard_id, req):
        """WriteBehind transport: one batch per owning shard.  Works over
        both fleet flavors — ``LocalClient`` and ``HTTPClient`` expose
        the same ``apply_batch``."""
        with self._lock:
            url = self._map.shards.get(shard_id, "")
            known = shard_id in self._map.shards
        if not known:
            raise ApiError(E_WRONG_SHARD, f"shard {shard_id!r} left the map")
        if self._fault_plan is not None:
            try:
                self._fault_plan.gate(self.worker_id, shard_id)
            except ConnectionRefusedError as e:
                raise ApiError(E_INTERNAL, f"service unreachable: {e}")
        return self._proxy.shard_client(shard_id, url).apply_batch(req)

    def _on_batch_result(self, lane, op, result, err) -> bool:
        """Per-op outcome from a shipped batch (WriteBehind hook)."""
        p = op.payload
        if err is None:
            if op.kind == OP_REPORT:
                self._gate.note((p.get("exp_id"),
                                 p.get("suggestion_id") or p.get("trial_id")),
                                Decision.from_json(result.result))
            else:
                # confirmed on the owner: the holding may shrink now (and
                # only now — dropping before confirmation could strand a
                # suggestion the manager no longer knows to requeue)
                self._drop_holding(p.get("exp_id", ""),
                                   p.get("suggestion_id", ""))
            return False
        exp_id = p.get("exp_id", "")
        if err.code in _RETRYABLE and op.attempts < 2:
            # single-op re-home: wrong_shard / fenced / unreachable means
            # *this op's* owner moved — refresh, re-home, re-enqueue just
            # this op on the new owner's lane (the rest of the batch
            # already landed where it belonged)
            try:
                if err.code in (E_WRONG_SHARD, E_FENCED):
                    with self._lock:
                        self._assigned.pop(exp_id, None)
                self._refresh_map(force=True)
                self._rehome(exp_id)
                self._wb.enqueue(op.kind, p, lane=self._owner(exp_id),
                                 attempts=op.attempts + 1)
                return True
            except ApiError:
                pass        # fall through to terminal accounting
        self._drop_holding(exp_id, p.get("suggestion_id", ""))
        with self._lock:
            self.events.append({"event": "batch_op_failed", "op": op.kind,
                                "exp_id": exp_id, "code": err.code,
                                "error": err.message, "time": time.time()})
            if len(self.events) > 128:
                del self.events[:64]
        return False    # WriteBehind stats/op_errors record it too

    def _maybe_prompt_beat(self) -> None:
        """Flush piggyback: if a heartbeat is due, trigger it now instead
        of waiting out the periodic timer (holdings changed by the batch
        reach the manager on the flush cadence)."""
        if self._hb_thread is None:
            return
        with self._lock:
            due = time.monotonic() - self._last_beat >= self._period
        if due:
            self._wake.set()

    # ---------------------------------------------------------- protocol
    def create_experiment(self, req: CreateExperiment) -> CreateResponse:
        resp, shard_id, version = self._proxy.create(req)
        with self._lock:
            self._assigned[resp.exp_id] = shard_id
            if req.config:
                self._configs[resp.exp_id] = req.config
        self._refresh_map(version=version)
        return resp

    def suggest(self, exp_id: str, count: int = 1) -> SuggestBatch:
        self.flush()
        batch = self._routed(exp_id, lambda c: c.suggest(exp_id, count))
        if batch.suggestions:
            with self._lock:
                held = self._holdings.setdefault(exp_id, set())
                held.update(s.suggestion_id for s in batch.suggestions)
            # new holdings must reach the manager promptly: a crash in
            # the window before the next periodic beat would otherwise
            # leave these suggestions unknown (and unrecoverable)
            self._wake.set()
        return batch

    def observe(self, req: ObserveRequest) -> ObserveResponse:
        if self._wb is not None:
            # fire-and-forget into the owner's lane; the holding is kept
            # until a flush confirms (see _on_batch_result)
            self._enqueue_op(OP_OBSERVE, req.to_json(), req.exp_id)
            return ObserveResponse(accepted=True, duplicate=False,
                                   observations=-1)
        resp = self._routed(req.exp_id, lambda c: c.observe(req))
        self._drop_holding(req.exp_id, req.suggestion_id)
        return resp

    def report(self, req: ReportRequest) -> Decision:
        if self._wb is not None:
            stashed = self._gate.take_stashed(req)
            if stashed is not None:
                return stashed
            if not self._gate.blocking(req):
                self._enqueue_op(OP_REPORT, req.to_json(), req.exp_id)
                return self._gate.ride_decision(req)
            self._wb.flush()    # ordering: queued ops land first
        d = self._routed(req.exp_id, lambda c: c.report(req))
        if self._gate is not None:
            self._gate.note(self._gate.key(req), d)
            self._gate.take_stashed(req)    # delivered directly: unstash
        return d

    def release(self, exp_id: str, suggestion_id: str) -> bool:
        if self._wb is not None:
            self._enqueue_op(OP_RELEASE,
                             {"exp_id": exp_id,
                              "suggestion_id": suggestion_id}, exp_id)
            return True
        ok = self._routed(exp_id,
                          lambda c: c.release(exp_id, suggestion_id))
        self._drop_holding(exp_id, suggestion_id)
        return ok

    def requeue(self, exp_id: str, suggestion_id: str,
                assignment: Optional[dict] = None) -> bool:
        if self._wb is not None:
            self._enqueue_op(OP_REQUEUE,
                             {"exp_id": exp_id,
                              "suggestion_id": suggestion_id,
                              "assignment": assignment}, exp_id)
            return True
        ok = self._routed(exp_id,
                          lambda c: c.requeue(exp_id, suggestion_id,
                                              assignment=assignment))
        self._drop_holding(exp_id, suggestion_id)
        return ok

    def status(self, exp_id: str) -> StatusResponse:
        self.flush()
        resp = self._routed(exp_id, lambda c: c.status(exp_id))
        if self._wb is not None:
            resp.transport = dict(resp.transport or {})
            resp.transport["batch"] = dict(self._wb.stats)
            resp.transport["batch"]["depth"] = self._wb.depth()
        return resp

    def stop(self, exp_id: str, state: str = "stopped") -> StatusResponse:
        self.flush()
        resp = self._routed(exp_id, lambda c: c.stop(exp_id, state))
        with self._lock:
            self._holdings.pop(exp_id, None)
        return resp

    def best_response(self, exp_id: str) -> BestResponse:
        self.flush()
        return self._routed(exp_id, lambda c: c.best_response(exp_id))

    # -------------------------------------------------------- heartbeats
    def _drop_holding(self, exp_id: str, suggestion_id: str) -> None:
        with self._lock:
            held = self._holdings.get(exp_id)
            if held is not None:
                held.discard(suggestion_id)
                if not held:
                    del self._holdings[exp_id]

    def holdings(self) -> Dict[str, list]:
        with self._lock:
            return {e: sorted(s) for e, s in self._holdings.items()}

    def beat(self) -> HeartbeatResponse:
        """Send one heartbeat now (the daemon thread calls this on its
        own; tests call it to drive liveness deterministically)."""
        if self._fault_plan is not None:
            self._fault_plan.gate(self.worker_id, "manager")
        with self._lock:
            self._seq += 1
            req = HeartbeatRequest(worker_id=self.worker_id,
                                   kind="scheduler",
                                   holdings=self.holdings(), seq=self._seq)
        resp = self._proxy.heartbeat(req)
        with self._lock:
            self._period = max(0.05, float(resp.period))
            self._last_beat = time.monotonic()
        if resp.map_version != self.map_version:
            self._refresh_map(force=True)
        return resp

    def _beat_loop(self) -> None:
        while True:
            self._wake.wait(timeout=self._period)
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self.beat()
            except Exception as e:
                # manager briefly unreachable — keep beating (the
                # registry's auto-register tolerates manager restarts),
                # but never silently: the audit trail records it
                self._audit_beat_error(e)

    def _audit_beat_error(self, e: BaseException) -> None:
        """Record a heartbeat failure with bounded dedupe: the first
        occurrence and every 32nd repeat land in ``events``; the rest
        only bump the per-error counter."""
        key = f"{type(e).__name__}: {e}"
        with self._lock:
            n = self._beat_errors.get(key, 0) + 1
            if len(self._beat_errors) >= 32 and key not in self._beat_errors:
                self._beat_errors.pop(next(iter(self._beat_errors)))
            self._beat_errors[key] = n
            if n == 1 or n % 32 == 0:
                self.events.append({"event": "beat_error", "error": key,
                                    "count": n, "time": time.time()})
                if len(self.events) > 128:
                    del self.events[:64]

    def beat_errors(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._beat_errors)

    def close(self, join_timeout: float = 5.0) -> None:
        """Stop the heartbeat thread (joined with a timeout — a beat hung
        in a dead transport must not block interpreter exit) and release
        shard connections."""
        if self._wb is not None:
            try:
                self._wb.close()    # flush queued ops while shards live
            except ApiError:
                pass
        self._stop.set()
        self._wake.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=join_timeout)
            self._hb_thread = None
        self._proxy.close()
