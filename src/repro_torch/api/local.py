"""In-process suggestion-service backend.

``LocalClient`` owns what the scheduler used to reach into directly: the
optimizer (via ``make_optimizer``) and the system-of-record ``Store``.
All state transitions are lock-guarded, and every handed-out assignment is
tracked as a *pending suggestion*, so concurrent ``suggest`` calls from
parallel workers never receive duplicate assignments and never
oversubscribe the observation budget.

Suggestion pipeline: suggestion latency is decoupled from model
cost.  Per experiment, two locks split the work:

* ``state.lock`` — cheap bookkeeping (pending set, counters, queue pops).
  ``suggest`` normally completes under this lock alone: it pops a
  pre-computed suggestion from the prefetch queue in ~µs.
* ``state.opt_lock`` — serializes *all* optimizer compute (ask / tell /
  forget / restore).  Held by the background :class:`SuggestionPump`
  (which keeps the queue warm, folds deferred observations, refits
  hyperparameters, and prewarms the GP shape buckets) and by the coalesced
  miss path, where N concurrent queue misses are served by ONE batched
  ``ask(n)`` instead of N serialized fits.

``observe``/``release`` never touch the optimizer inline: they enqueue a
deferred tell/forget op (``state.ops``) and wake the pump; with the pump
disabled (``prefetch=0``) the op is drained synchronously, preserving the
fully-synchronous pre-pipeline semantics.  Lock order is always
``opt_lock`` before ``state.lock``; ``state.ops`` is popped only under
``opt_lock`` (see ``pipeline.drain_ops``), which makes resume's
"drain, then replay the log tail" sequence race-free.

This same object is also the backend behind ``serve_api`` — the HTTP layer
is a thin JSON shim over a ``LocalClient``.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Dict, List, Optional, Set, Union

from repro_torch.api import pipeline
from repro_torch.api.client import SuggestionClient
from repro_torch.api.pipeline import (MissSlot, PrefetchItem, SuggestionPump,
                                drain_ops, pop_prefetched, retire_queue,
                                serve_misses)
from repro_torch.api.protocol import (ApiError, BatchOpResult, BatchRequest,
                                BatchResponse, BestResponse,
                                CreateExperiment, CreateResponse,
                                DECISION_STOP, Decision, DrainResponse,
                                E_FENCED, E_INTERNAL, E_UNKNOWN_EXPERIMENT,
                                E_WRONG_SHARD, EPOCH_ZERO, ObserveRequest,
                                ObserveResponse, ReleaseRequest,
                                ReleaseResponse, ReportRequest,
                                RequeueRequest, StatusResponse, SuggestBatch,
                                Suggestion, epoch_tuple)
from repro_torch.core.experiment import ExperimentConfig
from repro_torch.core.space import strip_internal
from repro_torch.core.store import FencedError, Store
from repro_torch.core.suggest.base import (Observation, Optimizer,
                                           StoppingPolicy, make_optimizer,
                                           make_stopping_policy)
from repro_torch.device import resolve


class _ExperimentState:
    """Live service-side state for one experiment (pending set, prefetch
    queue, and deferred-op list are in-memory only; a service restart
    reclaims all pending budget and speculative suggestions — early-
    stopping rung state, by contrast, IS durable: snapshot in the
    experiment record + replay of the per-trial metric logs)."""

    def __init__(self, cfg: ExperimentConfig, optimizer: Optimizer,
                 stopper: Optional[StoppingPolicy] = None):
        self.cfg = cfg
        self.optimizer = optimizer
        self.stopper = stopper
        self.lock = threading.RLock()        # bookkeeping (fast paths)
        self.opt_lock = threading.RLock()    # optimizer compute (slow paths)
        self.pending: Dict[str, Suggestion] = {}
        self.orphaned: List[Suggestion] = []  # requeued pending (dead worker)
        self.sparse_ids: Set[str] = set()     # served off the sparse posterior
        self.closed: Set[str] = set()
        self.observed = 0
        self.failures = 0
        self.stopped = False
        self.best: Optional[Observation] = None
        self.metric_seq = 0          # high-water mark of the metric stream
        # --- pipeline state (see repro_torch.api.pipeline) ---
        self.queue: List[PrefetchItem] = []      # warm speculative asks
        self.ops: List[tuple] = []               # deferred tell/forget
        self.miss_slots: List[MissSlot] = []     # coalescing parked misses
        self.pump: Optional[SuggestionPump] = None
        self.staleness = max(1, cfg.staleness)
        self.stats = {"hits": 0, "misses": 0, "coalesced": 0,
                      "invalidated": 0, "prefilled": 0, "prewarmed": 0,
                      "batched_prefilled": 0,
                      "sparse_prefilled": 0, "sparse_served": 0,
                      "requeued": 0, "requeue_served": 0,
                      # sparse-vs-exact quality on finished trials (the
                      # SPARSE_MAX tuning signal)
                      "sparse_obs": 0, "sparse_regret": 0.0,
                      "exact_obs": 0, "exact_regret": 0.0}
        # ownership fence (API.md §Fleet / Fencing): the epoch this
        # incarnation adopted the experiment at; ``fenced`` flips once a
        # newer incarnation's claim is detected and is terminal for this
        # state object (a re-create re-claims and replaces it)
        self.epoch = EPOCH_ZERO
        self.fenced = False
        self.last_mirror = 0.0       # status.json mirror throttle
        self.appends = 0             # observes between log append + account
        self.append_cv = threading.Condition(self.lock)
        self._seq = 0
        self._sid_nonce = uuid.uuid4().hex[:6]
        self._snap_version = -1      # stopper.version last persisted

    def next_suggestion_id(self) -> str:
        self._seq += 1
        # the nonce makes ids unique across state *incarnations*: after a
        # shard dies, the adopting shard's counter restarts, and a bare
        # sequence number would re-mint ids that are already in the
        # observation log (breaking closed-set dedupe for stale workers)
        return f"s{self._sid_nonce}-{self._seq:05d}"

    def pump_depth(self) -> int:
        """Resolved prefetch depth: an explicit ``cfg.prefetch`` wins;
        ``None`` auto-enables the pump only for optimizers whose ``ask``
        is expensive (model-based — GP), sized to cover one full
        slot-fill burst plus refill headroom."""
        if self.cfg.prefetch is not None:
            return max(0, int(self.cfg.prefetch))
        if getattr(self.optimizer, "expensive_ask", False):
            return max(2, min(2 * int(self.cfg.parallel), 16))
        return 0


def _public_best(best) -> Optional[Dict]:
    """Serialize a best observation for user-facing readouts, stripping
    internal ``__``-prefixed echo keys (constant-liar tokens, particle
    ids) from the assignment."""
    if best is None:
        return None
    d = best.to_json()
    if isinstance(d.get("assignment"), dict):
        d["assignment"] = strip_internal(d["assignment"])
    return d


DRAINED_TOMBSTONES = 1024    # max remembered handed-over experiments
BATCH_DEDUPE_WINDOW = 512    # applied batches remembered for replay


class LocalClient(SuggestionClient):
    def __init__(self, store: Union[Store, str], device=None):
        self.store = store if isinstance(store, Store) else Store(store)
        # where every experiment's model lives (None: the CUDA card);
        # resolved once and handed to each optimizer, never persisted in
        # the experiment config
        self.device = resolve(device)
        self._exps: Dict[str, _ExperimentState] = {}
        self._lock = threading.Lock()
        # owner token: unique per service incarnation — the second half of
        # the fence record (epoch orders ownership across grants; the
        # token disambiguates incarnations within one epoch)
        self.incarnation = f"svc-{uuid.uuid4().hex[:8]}"
        # experiments drained off this shard (rebalance handover): answer
        # wrong_shard — not unknown_experiment — so routed clients refresh
        # the map instead of re-adopting here
        self._drained: Dict[str, float] = {}
        # exactly-once batch replay (API.md §Transport batching):
        # batch_id -> ("inflight", Event) | ("done", BatchResponse).
        # Bounded window: a transport retry redelivers promptly, so only
        # the recent past needs remembering.
        self._batch_lock = threading.Lock()
        self._batches: Dict[str, tuple] = {}

    # -------------------------------------------------------------- fencing
    def _tombstone(self, exp_id: str) -> None:
        # holding self._lock
        self._drained[exp_id] = time.time()
        while len(self._drained) > DRAINED_TOMBSTONES:
            self._drained.pop(next(iter(self._drained)))

    def _claim_fence(self, exp_id: str, epoch) -> tuple:
        """Adopt the experiment's fence record.  An explicit ``epoch`` is
        a manager grant (claim exactly there — stale grants from a
        deposed manager raise ``fenced``); without one, an *existing*
        record is re-claimed at its current epoch (owner swap: last
        adopter within an epoch wins), and an absent record is left
        absent — standalone services never enter the fencing regime."""
        try:
            if epoch is not None:
                return self.store.claim_fence(exp_id, epoch_tuple(epoch),
                                              self.incarnation)
            cur, owner = self.store.read_fence(exp_id)
            if cur == EPOCH_ZERO and not owner:
                return EPOCH_ZERO
            return self.store.claim_fence(exp_id, cur, self.incarnation)
        except FencedError as e:
            raise ApiError(E_FENCED, str(e))

    def _check_fence(self, exp_id: str, state: _ExperimentState) -> None:
        """Write guard: every durable write re-validates ownership (one
        cached os.stat).  On a lost fence the incarnation stands down —
        pump stopped, parked misses unblocked, all further calls
        answered ``fenced`` — and the write is rejected *before* it
        reaches the log."""
        if state.fenced:
            raise ApiError(E_FENCED,
                           f"{exp_id}: this incarnation was fenced")
        try:
            self.store.check_fence(exp_id, state.epoch, self.incarnation)
        except FencedError as e:
            self._stand_down(state)
            raise ApiError(E_FENCED, str(e))

    def _stand_down(self, state: _ExperimentState) -> None:
        with state.lock:
            if state.fenced:
                return
            state.fenced = True
            pump = state.pump
            slots, state.miss_slots = state.miss_slots, []
            for sl in slots:
                sl.done = True
                sl.event.set()
        if pump is not None:
            pump.stop(join=False)   # no join: may be called from any path

    # ------------------------------------------------------------ lifecycle
    def create_experiment(self, req: CreateExperiment) -> CreateResponse:
        exp_id = req.exp_id
        if req.config:
            cfg = ExperimentConfig.from_json(req.config)
        else:
            # config-less resume (fleet failover): a new owner shard
            # adopts an experiment it has never seen straight out of the
            # shared system-of-record store
            with self._lock:
                live = self._exps.get(exp_id) if exp_id else None
            if live is not None:
                cfg = live.cfg
            else:
                try:
                    cfg = self.store.load_config(exp_id)
                except FileNotFoundError:
                    raise ApiError(E_UNKNOWN_EXPERIMENT,
                                   f"no experiment {exp_id!r} to adopt")
        with self._lock:
            on_disk = (exp_id is not None
                       and (self.store.exp_dir(exp_id) / "config.json")
                       .exists())
            state = self._exps.get(exp_id) if exp_id else None
            fresh = state is None
            if fresh:
                if exp_id is None:
                    from repro_torch.core.experiment import new_experiment_id
                    exp_id = new_experiment_id()
                if not on_disk:
                    self.store.create_experiment(exp_id, cfg)
            # (re-)adopting clears the handover tombstone: this shard is
            # being told to serve the experiment again
            if exp_id is not None:
                self._drained.pop(exp_id, None)
            if fresh:
                optimizer = make_optimizer(cfg.optimizer, cfg.space,
                                           seed=cfg.seed, device=self.device,
                                           **cfg.optimizer_options)
                stopper = (make_stopping_policy(cfg.early_stop, goal=cfg.goal)
                           if cfg.early_stop else None)
                state = _ExperimentState(cfg, optimizer, stopper)
                # grab both locks BEFORE publishing (canonical order: opt
                # before state) so no concurrent suggest sees observed=0
                # pre-replay
                state.opt_lock.acquire()
                state.lock.acquire()
                self._exps[exp_id] = state
        if not fresh:
            # live re-create/resume: quiesce the pump first, then take the
            # locks in canonical order
            with state.lock:
                pump = state.pump
            if pump is not None:
                pump.stop(join=True)
            state.opt_lock.acquire()
            state.lock.acquire()
        try:
            # claim ownership BEFORE any durable write below: a zombie
            # acting on a deposed manager's grant must fail the whole
            # create, not half-adopt
            try:
                state.epoch = self._claim_fence(exp_id, req.epoch)
            except ApiError:
                if fresh:
                    with self._lock:
                        self._exps.pop(exp_id, None)
                raise
            state.fenced = False
            resumed = on_disk or state.observed > 0
            state.cfg = cfg          # resume may raise the budget
            state.stopped = False    # re-creating declares intent to run
            state.staleness = max(1, cfg.staleness)
            if resumed:
                # keep the stored config in sync with the resumed one
                (self.store.exp_dir(exp_id) / "config.json").write_text(
                    json.dumps(cfg.to_json(), indent=1))
            # quiesce in-flight observes (append done, accounting not yet)
            # so the log, the deferred ops, and the counters agree, then
            # fold the deferred observations BEFORE the replay — the
            # log-tail arithmetic in Optimizer.restore stays exact
            deadline = time.monotonic() + 5.0
            while state.appends and time.monotonic() < deadline:
                state.append_cv.wait(0.1)
            drain_ops(state)
            records = self.store.load_observation_records(exp_id)
            prior = [Observation.from_json(r) for r in records]
            # restore() is idempotent: only the log tail beyond what the
            # optimizer has already absorbed is replayed
            state.optimizer.restore(
                {"history": [o.to_json() for o in prior]})
            # rebuild the duplicate-observe dedupe set from the log: an
            # adopting incarnation must reject a straggler's re-observe
            # of a suggestion the previous owner already logged
            state.closed.update(r["suggestion_id"] for r in records
                                if r.get("suggestion_id"))
            state.observed = len(prior)
            state.failures = sum(1 for o in prior if o.failed)
            ok = [o for o in prior if not o.failed and o.value is not None]
            state.best = max(ok, key=lambda o: o.value) if ok else None
            self._restore_rungs(exp_id, state, cfg)
        finally:
            state.lock.release()
            state.opt_lock.release()
        self._ensure_pump(exp_id, state)
        return CreateResponse(exp_id=exp_id, resumed=resumed,
                              observations=state.observed)

    def _restore_rungs(self, exp_id: str, state: _ExperimentState,
                       cfg: ExperimentConfig) -> None:
        """Resume trial-events state exactly like the observation log:
        load the rung snapshot from the experiment record, replay the
        metric-log tail beyond its ``seq`` high-water mark (crash between
        a metric append and the snapshot write), and advance ``metric_seq``
        past everything on disk so post-restart reports never reuse seq
        numbers — even for experiments with no stopping policy.
        Idempotent — a live state's absorbed stream is never replayed
        twice."""
        if cfg.early_stop and state.stopper is None:
            state.stopper = make_stopping_policy(cfg.early_stop,
                                                 goal=cfg.goal)
        if state.stopper is not None and state.metric_seq == 0:
            snap = self.store.get_status(exp_id).get("rungs")
            if snap:
                state.stopper.restore(snap)
                state.metric_seq = int(snap.get("seq", 0))
                state._snap_version = state.stopper.version
        records = self.store.load_metrics(exp_id)
        tail = [r for r in records if r.get("seq", 0) > state.metric_seq]
        if state.stopper is not None:
            for r in tail:
                state.stopper.report(
                    r.get("trial_key") or r.get("trial_id", ""),
                    int(r["step"]), float(r["value"]))
        if records:
            state.metric_seq = max(
                state.metric_seq,
                max(int(r.get("seq", 0)) for r in records))
        if tail:
            self._snapshot_rungs(exp_id, state)

    def _snapshot_rungs(self, exp_id: str, state: _ExperimentState) -> None:
        """Persist the rung table into the experiment record (status.json)
        whenever it actually changed — reports between rungs don't touch
        policy state and stay off this path."""
        if state.stopper is None or state.stopper.version == state._snap_version:
            return
        snap = dict(state.stopper.state(), seq=state.metric_seq)
        state._snap_version = state.stopper.version
        self.store.update_status(exp_id, rungs=snap)

    def _state(self, exp_id: str) -> _ExperimentState:
        with self._lock:
            state = self._exps.get(exp_id)
            drained = state is None and exp_id in self._drained
        if state is None:
            if drained:
                raise ApiError(E_WRONG_SHARD,
                               f"experiment {exp_id!r} was handed over "
                               f"(drained from this shard)")
            raise ApiError(E_UNKNOWN_EXPERIMENT,
                           f"no live experiment {exp_id!r}")
        return state

    # ------------------------------------------------------------- pipeline
    def _mint(self, state: _ExperimentState, assignment,
              sparse: bool = False) -> Suggestion:
        """Turn an assignment into a tracked pending suggestion.  MUST be
        called with ``state.lock`` held.  ``sparse`` marks suggestions
        served off the approximate posterior so their eventual outcome
        feeds the sparse-vs-exact quality counters."""
        s = Suggestion(state.next_suggestion_id(), assignment)
        state.pending[s.suggestion_id] = s
        if sparse:
            state.sparse_ids.add(s.suggestion_id)
        return s

    def _ensure_pump(self, exp_id: str, state: _ExperimentState) -> None:
        """Start (or restart, e.g. after ``close``/resume) the prefetch
        pump when the config calls for one and the experiment can still
        make progress."""
        depth = state.pump_depth()
        with state.lock:
            if (depth <= 0 or state.stopped
                    or state.observed >= state.cfg.budget):
                return
            if state.pump is not None and state.pump.alive:
                return
            state.pump = SuggestionPump(
                state, exp_id, depth,
                lambda a: self._mint(state, a)).start()

    def _drain_sync(self, state: _ExperimentState) -> None:
        """Apply deferred optimizer ops inline — the no-pump path keeps
        the pre-pipeline synchronous semantics (tells/forgets visible the
        moment observe/release returns)."""
        with state.opt_lock:
            drain_ops(state)

    def _suggest_miss(self, state: _ExperimentState,
                      need: int) -> List[Suggestion]:
        """Queue-dry fallback: park a miss slot and race for the optimizer
        lock; whoever wins serves every parked slot with one batched
        ``ask`` (cross-scheduler coalescing).  Losers just wait — their
        suggestions are computed by the winner (or the pump)."""
        slot = MissSlot(need)
        with state.lock:
            if state.stopped:
                return []
            state.miss_slots.append(slot)
        while not slot.done:
            if state.opt_lock.acquire(timeout=0.02):
                try:
                    if not slot.done:
                        serve_misses(state, lambda a: self._mint(state, a))
                finally:
                    state.opt_lock.release()
            else:
                slot.event.wait(0.02)
        return slot.result

    # ------------------------------------------------------ suggest/observe
    def suggest(self, exp_id: str, count: int = 1) -> SuggestBatch:
        state = self._state(exp_id)
        if state.fenced:
            # cheap flag check only — serving from a not-yet-detected
            # zombie is harmless (its observes are fenced at the log),
            # so the µs hot path pays no stat() here
            raise ApiError(E_FENCED,
                           f"{exp_id}: this incarnation was fenced")
        self._ensure_pump(exp_id, state)
        with state.lock:
            if state.stopped:
                return SuggestBatch([], remaining=0)
            # requeued (orphaned) suggestions are served first: they are
            # already pending — same id, same constant-liar lie — so they
            # consume no budget headroom and are handed out exactly once
            batch: List[Suggestion] = []
            while state.orphaned and len(batch) < int(count):
                s = state.orphaned.pop(0)
                if (s.suggestion_id in state.closed
                        or s.suggestion_id not in state.pending):
                    continue    # observed/released while parked
                batch.append(s)
                state.stats["requeue_served"] += 1
            headroom = (state.cfg.budget - state.observed
                        - len(state.pending))
            n = max(0, min(int(count) - len(batch), headroom))
            fresh, stale = pop_prefetched(state, n)
            batch.extend(self._mint(state, it.assignment, sparse=it.sparse)
                         for it in fresh)
            need = n - len(fresh)
            if stale:
                state.ops.extend(("forget", a) for a in stale)
            pump = state.pump
            refill = len(state.queue) < state.pump_depth()
        if pump is not None and pump.alive:
            if refill or stale or need:
                pump.wake()
        elif stale:
            self._drain_sync(state)
        if need > 0:
            batch.extend(self._suggest_miss(state, need))
        with state.lock:
            remaining = (state.cfg.budget - state.observed
                         - len(state.pending))
        return SuggestBatch(batch, remaining=max(0, remaining))

    def observe(self, req: ObserveRequest) -> ObserveResponse:
        state = self._state(req.exp_id)
        # ownership guard BEFORE any bookkeeping: a fenced incarnation's
        # observation must neither close the suggestion nor reach the log
        self._check_fence(req.exp_id, state)
        obs = Observation(req.assignment, req.value, req.stddev,
                          req.failed, dict(req.metadata))
        with state.lock:
            if req.suggestion_id in state.closed:
                return ObserveResponse(accepted=False, duplicate=True,
                                       observations=state.observed)
            if state.stopped:
                # stopped/deleted experiments take no more observations
                # (a straggler must not flip 'deleted' back to 'complete')
                return ObserveResponse(accepted=False, duplicate=False,
                                       observations=state.observed)
            state.closed.add(req.suggestion_id)
            # the model fold is deferred: the pump (or the next optimizer-
            # lock holder) absorbs it off this hot path.  Enqueued BEFORE
            # the log append: a concurrent live resume drains this op
            # (under opt_lock) before replaying the log, so whether or not
            # its load sees the append below, the optimizer absorbs this
            # observation exactly once (restore only replays the tail
            # beyond len(history)).
            state.ops.append(("tell", obs))
            state.appends += 1
        # system-of-record append OUTSIDE the experiment lock (the store
        # serializes its own handles): holding the lock across file I/O
        # would make every concurrent queue pop wait on a flush.  The
        # closed-set insert above already de-duplicated; the suggestion
        # stays *pending* until the same lock section that increments
        # ``observed``, so budget headroom never transiently inflates.
        # ``appends`` marks the append-to-accounting window so a live
        # resume (create_experiment) can quiesce in-flight observes
        # before deriving counters from the log.
        try:
            self.store.append_observation(req.exp_id, obs, req.trial_id,
                                          suggestion_id=req.suggestion_id)
        except BaseException:
            with state.lock:
                state.appends -= 1
                state.append_cv.notify_all()
            raise
        with state.lock:
            # tolerate untracked ids (service restart lost the pending set)
            state.pending.pop(req.suggestion_id, None)
            state.observed += 1
            state.appends -= 1
            state.append_cv.notify_all()
            if req.failed:
                state.failures += 1
            # sparse-vs-exact quality: instantaneous regret of this
            # finished trial against the best KNOWN BEFORE it, bucketed
            # by which posterior served its suggestion — the SPARSE_MAX
            # tuning signal
            was_sparse = req.suggestion_id in state.sparse_ids
            state.sparse_ids.discard(req.suggestion_id)
            if not obs.failed and obs.value is not None:
                regret = (max(0.0, state.best.value - obs.value)
                          if state.best is not None else 0.0)
                bucket = "sparse" if was_sparse else "exact"
                state.stats[bucket + "_obs"] += 1
                state.stats[bucket + "_regret"] += regret
            if (not obs.failed and obs.value is not None
                    and (state.best is None
                         or obs.value > state.best.value)):
                state.best = obs
            fields = dict(observations=state.observed,
                          failures=state.failures,
                          best=_public_best(state.best))
            complete = state.observed >= state.cfg.budget
            observed = state.observed
            pump = state.pump
        if complete:
            fields["state"] = "complete"
            self.store.update_status(req.exp_id, **fields)
        else:
            self._mirror_status(req.exp_id, state, fields)
        # the trial is terminal: its metric stream will never grow again —
        # evict its file handle from the store LRU so a fleet-scale churn
        # of short trials can't pin thousands of open files
        self._evict_trial_handles(req.exp_id, req.suggestion_id,
                                  req.trial_id)
        if pump is not None and pump.alive:
            pump.wake()     # fold + staleness sweep + refill
        else:
            self._drain_sync(state)
        return ObserveResponse(accepted=True, duplicate=False,
                               observations=observed)

    def _evict_trial_handles(self, exp_id: str, *trial_keys: str) -> None:
        """Close the cached append handles of a terminal trial's metric
        stream (keyed by suggestion_id or trial_id — evict both)."""
        for key in trial_keys:
            if key:
                self.store.release_handle(self.store.metric_path(exp_id,
                                                                 key))

    def _mirror_status(self, exp_id: str, state: _ExperimentState,
                       fields: Dict) -> None:
        """Throttled status.json mirror: the in-memory state (and the
        observation log) are authoritative; the mirror exists for cold
        reads and need not be written per observation under contention.
        Terminal transitions bypass this and always write."""
        now = time.monotonic()
        with state.lock:
            if now - state.last_mirror < 0.05:
                return
            state.last_mirror = now
        self.store.update_status(exp_id, **fields)

    def report(self, req: ReportRequest) -> Decision:
        """Trial-events hot path: append the progress point to the trial's
        metric stream, run it through the experiment's (shared) stopping
        policy, and answer continue/stop/pause.  Single-writer under the
        experiment lock — N schedulers prune against ONE rung table."""
        state = self._state(req.exp_id)
        self._check_fence(req.exp_id, state)   # report appends durably
        with state.lock:
            return self._report_locked(req.exp_id, state, req)

    def _report_locked(self, exp_id: str, state: _ExperimentState,
                       req: ReportRequest) -> Decision:
        """Body of :meth:`report` (fence already checked, ``state.lock``
        held) — shared with the batched apply path, where one lock
        acquisition covers a whole per-experiment op group."""
        if state.stopped:
            # deleted/stopped experiments wind their trials down via
            # the next report, even without a worker-side stop flag
            return Decision(DECISION_STOP, next_rung=None,
                            seq=state.metric_seq)
        # suggestion_id keys the stream when present: it is unique
        # service-wide, so speculative twins merge and two schedulers'
        # identically-numbered trials never collide
        key = req.suggestion_id or req.trial_id
        state.metric_seq += 1
        rec = {"seq": state.metric_seq, "trial_key": key,
               "trial_id": req.trial_id, "step": req.step,
               "value": req.value, "time": time.time()}
        if req.metadata:
            rec["metadata"] = req.metadata
        self.store.append_metric(exp_id, key, rec)
        if state.stopper is None:
            return Decision(next_rung=None, seq=state.metric_seq)
        decision = state.stopper.report(key, req.step, req.value)
        self._snapshot_rungs(exp_id, state)
        if decision == DECISION_STOP:
            # final prune: the stream is closed — drop its handle
            self._evict_trial_handles(exp_id, key)
        return Decision(decision,
                        next_rung=state.stopper.next_rung(key),
                        seq=state.metric_seq)

    def release(self, exp_id: str, suggestion_id: str) -> bool:
        state = self._state(exp_id)
        with state.lock:
            s = state.pending.pop(suggestion_id, None)
            state.sparse_ids.discard(suggestion_id)
            if s is not None:
                # never coming back: let the optimizer drop its
                # constant-liar bookkeeping for this point
                state.ops.append(("forget", s.assignment))
            pump = state.pump
        if s is not None:
            if pump is not None and pump.alive:
                pump.wake()
            else:
                self._drain_sync(state)
        return s is not None

    def requeue(self, exp_id: str, suggestion_id: str,
                assignment: Optional[Dict] = None) -> bool:
        """Dead-worker recovery (fleet event loop): park a *pending*
        suggestion for re-serving.  Unlike ``release`` the suggestion
        keeps its id and its constant-liar lie — the next ``suggest``
        hands it (exactly once) to a surviving worker, so the optimizer
        sees no retraction and the observation, whoever produces it,
        dedupes by the same suggestion_id.

        With ``assignment`` this is the *transfer* form (rebalance
        handover): a suggestion id minted by the previous owner is
        installed here as a parked pending under the same id, so the
        in-flight trial's eventual observation still lands exactly
        once."""
        state = self._state(exp_id)
        with state.lock:
            return self._requeue_locked(state, suggestion_id, assignment)

    @staticmethod
    def _requeue_locked(state: _ExperimentState, suggestion_id: str,
                        assignment: Optional[Dict] = None) -> bool:
        """Body of :meth:`requeue` (``state.lock`` held) — shared with
        the batched apply path."""
        s = state.pending.get(suggestion_id)
        if (s is None and assignment is not None
                and suggestion_id not in state.closed
                and not state.stopped):
            s = Suggestion(suggestion_id, assignment)
            state.pending[suggestion_id] = s
        if s is None or suggestion_id in state.closed or state.stopped:
            return False
        if all(o.suggestion_id != suggestion_id
               for o in state.orphaned):
            state.orphaned.append(s)
            state.stats["requeued"] += 1
        return True

    # ------------------------------------------------------------- batching
    def apply_batch(self, req: BatchRequest) -> BatchResponse:
        """Apply one ordered op batch (API.md §Transport batching) with
        exactly-once replay: the first delivery of a ``batch_id`` applies
        and records its per-op results; any redelivery (transport retry
        after a lost response) answers the recorded results with
        ``replayed=True`` instead of re-applying.  The window is bounded
        (``BATCH_DEDUPE_WINDOW``) — retries are prompt, so only the
        recent past needs remembering."""
        my_ev = None
        with self._batch_lock:
            ent = self._batches.get(req.batch_id)
            if ent is None:
                my_ev = threading.Event()
                self._batches[req.batch_id] = ("inflight", my_ev)
            elif ent[0] == "done":
                return BatchResponse(req.batch_id, ent[1].results,
                                     replayed=True)
        if my_ev is None:
            # concurrent redelivery while the first is still applying:
            # wait for it rather than racing a second application
            ent[1].wait(timeout=60.0)
            with self._batch_lock:
                ent = self._batches.get(req.batch_id)
            if ent is not None and ent[0] == "done":
                return BatchResponse(req.batch_id, ent[1].results,
                                     replayed=True)
            raise ApiError(E_INTERNAL,
                           f"batch {req.batch_id}: first delivery failed")
        try:
            resp = self._apply_batch(req)
        except BaseException:
            with self._batch_lock:
                self._batches.pop(req.batch_id, None)
            my_ev.set()
            raise
        with self._batch_lock:
            self._batches[req.batch_id] = ("done", resp)
            done = [k for k, v in self._batches.items() if v[0] == "done"]
            for k in done[:max(0, len(done) - BATCH_DEDUPE_WINDOW)]:
                self._batches.pop(k, None)
        my_ev.set()
        return resp

    _BATCH_PARSERS = {"observe": ObserveRequest, "report": ReportRequest,
                      "release": ReleaseRequest, "requeue": RequeueRequest}

    def _apply_batch(self, req: BatchRequest) -> BatchResponse:
        """Group ops per experiment (preserving in-batch order) and apply
        each group with one lock acquisition per phase instead of one
        per op."""
        results: List[Optional[BatchOpResult]] = [None] * len(req.ops)
        groups: Dict[str, List] = {}
        for i, op in enumerate(req.ops):
            try:
                parsed = self._BATCH_PARSERS[op.op].from_json(op.payload)
            except ApiError as e:
                results[i] = BatchOpResult.failure(op.seq, e)
                continue
            groups.setdefault(parsed.exp_id, []).append((i, op, parsed))
        for exp_id, items in groups.items():
            self._apply_group(exp_id, items, results)
        return BatchResponse(req.batch_id, [
            r if r is not None else BatchOpResult.failure(
                op.seq, ApiError(E_INTERNAL, "op not processed"))
            for r, op in zip(results, req.ops)])

    def _apply_group(self, exp_id: str, items: List,
                     results: List[Optional[BatchOpResult]]) -> None:
        def fail_all(err: ApiError) -> None:
            for i, op, _ in items:
                if results[i] is None:
                    results[i] = BatchOpResult.failure(op.seq, err)

        try:
            state = self._state(exp_id)
        except ApiError as e:
            fail_all(e)
            return
        # ONE fence check per group (one cached stat amortized over the
        # whole group, vs one per unbatched call).  A fenced zombie's
        # group is rejected item-by-item with typed ``fenced`` results —
        # no op is half-applied.
        if state.fenced or any(op.op in ("observe", "report")
                               for _, op, _ in items):
            try:
                self._check_fence(exp_id, state)
            except ApiError as e:
                fail_all(e)
                return
        accepted: List = []      # observes that passed bookkeeping
        deferred = False         # any tell/forget enqueued this group
        # phase 1 — bookkeeping for the whole group under ONE lock
        # acquisition, in batch order (per-experiment ordering contract)
        with state.lock:
            for i, op, r in items:
                if op.op == "observe":
                    if r.suggestion_id in state.closed:
                        results[i] = BatchOpResult.success(
                            op.seq, ObserveResponse(
                                accepted=False, duplicate=True,
                                observations=state.observed).to_json())
                    elif state.stopped:
                        results[i] = BatchOpResult.success(
                            op.seq, ObserveResponse(
                                accepted=False, duplicate=False,
                                observations=state.observed).to_json())
                    else:
                        state.closed.add(r.suggestion_id)
                        obs = Observation(r.assignment, r.value, r.stddev,
                                          r.failed, dict(r.metadata))
                        # deferred fold, enqueued before the log append —
                        # same exactly-once contract as observe()
                        state.ops.append(("tell", obs))
                        state.appends += 1
                        deferred = True
                        accepted.append((i, op, r, obs))
                elif op.op == "report":
                    try:
                        d = self._report_locked(exp_id, state, r)
                        results[i] = BatchOpResult.success(op.seq,
                                                           d.to_json())
                    except ApiError as e:
                        results[i] = BatchOpResult.failure(op.seq, e)
                elif op.op == "release":
                    released = False
                    # an observe earlier in this batch may have closed
                    # the id (its pending-pop lands in phase 3): the
                    # closed set is the authority, same as observe dedupe
                    if r.suggestion_id not in state.closed:
                        s = state.pending.pop(r.suggestion_id, None)
                        state.sparse_ids.discard(r.suggestion_id)
                        if s is not None:
                            state.ops.append(("forget", s.assignment))
                            deferred = True
                            released = True
                    results[i] = BatchOpResult.success(
                        op.seq, ReleaseResponse(released=released).to_json())
                else:   # requeue
                    ok = self._requeue_locked(state, r.suggestion_id,
                                              r.assignment)
                    results[i] = BatchOpResult.success(op.seq,
                                                       {"requeued": ok})
        # phase 2 — system-of-record appends OUTSIDE the lock (the store
        # serializes its own handles), exactly like observe()
        appended: List = []
        for i, op, r, obs in accepted:
            try:
                self.store.append_observation(exp_id, obs, r.trial_id,
                                              suggestion_id=r.suggestion_id)
                appended.append((i, op, r, obs))
            except BaseException as e:
                results[i] = BatchOpResult.failure(
                    op.seq, e if isinstance(e, ApiError) else
                    ApiError(E_INTERNAL, f"{type(e).__name__}: {e}"))
        # phase 3 — accounting for the whole group under ONE lock
        # acquisition; per-op responses see the progressive totals
        fields = None
        complete = False
        with state.lock:
            for i, op, r, obs in appended:
                state.pending.pop(r.suggestion_id, None)
                state.observed += 1
                if r.failed:
                    state.failures += 1
                was_sparse = r.suggestion_id in state.sparse_ids
                state.sparse_ids.discard(r.suggestion_id)
                if not obs.failed and obs.value is not None:
                    regret = (max(0.0, state.best.value - obs.value)
                              if state.best is not None else 0.0)
                    bucket = "sparse" if was_sparse else "exact"
                    state.stats[bucket + "_obs"] += 1
                    state.stats[bucket + "_regret"] += regret
                if (not obs.failed and obs.value is not None
                        and (state.best is None
                             or obs.value > state.best.value)):
                    state.best = obs
                results[i] = BatchOpResult.success(
                    op.seq, ObserveResponse(
                        accepted=True, duplicate=False,
                        observations=state.observed).to_json())
            if accepted:
                state.appends -= len(accepted)
                state.append_cv.notify_all()
            if appended:
                fields = dict(observations=state.observed,
                              failures=state.failures,
                              best=_public_best(state.best))
                complete = state.observed >= state.cfg.budget
            pump = state.pump
        # phase 4 — ONE coalesced status-mirror write per batch group
        # (terminal transitions bypass the throttle and always write)
        if fields is not None:
            if complete:
                fields["state"] = "complete"
                self.store.update_status(exp_id, **fields)
            else:
                self._mirror_status(exp_id, state, fields)
        for i, op, r, obs in appended:
            self._evict_trial_handles(exp_id, r.suggestion_id, r.trial_id)
        if deferred:
            if pump is not None and pump.alive:
                pump.wake()     # one wake per group, not per op
            else:
                self._drain_sync(state)

    def drain(self, exp_id: str) -> DrainResponse:
        """Quiesce + hand over one experiment (rebalance control plane):
        stop its pump, fold deferred observations, retire the
        speculative queue, drop the live state, and answer with the
        still-pending suggestions so the manager can transfer them to
        the new owner.  Leaves a tombstone so later routed calls get
        ``wrong_shard`` (refresh your map), not ``unknown_experiment``
        (which would invite clients to re-adopt here).  Idempotent."""
        with self._lock:
            state = self._exps.get(exp_id)
            if state is None:
                self._tombstone(exp_id)
                return DrainResponse(drained=False, pending=[],
                                     observations=0)
        with state.lock:
            pump = state.pump
        if pump is not None:
            pump.stop(join=True)    # no speculation past the handover
        with state.opt_lock:
            drain_ops(state)        # folds are real data — keep them
            retire_queue(state)     # flush speculative constant-liar lies
            with state.lock:
                pending = sorted(
                    (s for s in state.pending.values()
                     if s.suggestion_id not in state.closed),
                    key=lambda s: s.suggestion_id)
                slots, state.miss_slots = state.miss_slots, []
                for sl in slots:
                    sl.done = True
                    sl.event.set()
                observed = state.observed
        with self._lock:
            self._exps.pop(exp_id, None)
            self._tombstone(exp_id)
        return DrainResponse(drained=True, pending=pending,
                             observations=observed)

    def load(self) -> Dict:
        """Shard-level load summary — the fleet's admission-control
        signal: live experiment count, total pending, and the shared
        FitExecutor's queue depth (``backlog``) + recent duty cycle."""
        with self._lock:
            states = list(self._exps.values())
        live = pending = prefetched = 0
        for st in states:
            with st.lock:
                if not st.stopped and st.observed < st.cfg.budget:
                    live += 1
                pending += len(st.pending)
                prefetched += len(st.queue)
        ex = pipeline.executor_snapshot() or {}
        return {"experiments": len(states), "live": live,
                "pending": pending, "prefetched": prefetched,
                "backlog": int(ex.get("backlog", 0)),
                "duty": float(ex.get("duty", 0.0)),
                "executor": ex or None}

    # -------------------------------------------------------------- queries
    def status(self, exp_id: str) -> StatusResponse:
        with self._lock:
            state = self._exps.get(exp_id)
        if state is None:
            return self._status_from_store(exp_id)
        # freshness + terminal hygiene: fold deferred observations, and
        # once the experiment can't serve again (stopped / budget spent)
        # retire the speculative queue's constant-liar lies.  Skipped
        # entirely when there is nothing to do — the common monitoring
        # read stays off the optimizer lock (a pump mid-fit must not
        # stall a GET /status).
        with state.lock:
            dirty = bool(state.ops) or bool(
                state.queue and (state.stopped
                                 or state.observed >= state.cfg.budget))
        if dirty:
            with state.opt_lock:
                drain_ops(state)
                retire_queue(state, terminal_only=True)
        with state.lock:
            st = self.store.get_status(exp_id)
            pump = state.pump
            pump_stats = dict(state.stats,
                              alive=bool(pump is not None and pump.alive),
                              depth=state.pump_depth())
            # refit-schedule observability: the adaptive warm-
            # step / refit-period schedule and the shared fit executor's
            # counters ride along in the pump stats (additive fields)
            schedule = state.optimizer.refit_schedule()
            if schedule is not None:
                pump_stats["refit"] = schedule
            # sparse-vs-exact serving quality (mean instantaneous regret
            # on finished trials) — the SPARSE_MAX tuning readout
            n_s, n_e = state.stats["sparse_obs"], state.stats["exact_obs"]
            pump_stats["quality"] = {
                "sparse_n": n_s, "exact_n": n_e,
                "sparse_mean_regret": (
                    round(state.stats["sparse_regret"] / n_s, 6)
                    if n_s else None),
                "exact_mean_regret": (
                    round(state.stats["exact_regret"] / n_e, 6)
                    if n_e else None),
                # live auto-tuned sparse-subset budget: the pump feeds
                # these regret counters back through
                # Optimizer.tune_sparse each tick
                "sparse_max": getattr(
                    state.optimizer, "_sparse_max", None)}
            if pump is not None:
                # None until a fit was actually submitted — a monitoring
                # read must not spawn the executor's worker pool
                pump_stats["executor"] = pipeline.executor_snapshot()
            return StatusResponse(
                exp_id=exp_id, state=st.get("state", "pending"),
                name=state.cfg.name, budget=state.cfg.budget,
                observations=state.observed, failures=state.failures,
                pending=len(state.pending),
                best=_public_best(state.best),
                prefetched=len(state.queue), pump=pump_stats,
                epoch=(list(state.epoch)
                       if state.epoch != EPOCH_ZERO else None))

    def _status_from_store(self, exp_id: str) -> StatusResponse:
        """Cold path: experiment not live in this process — answer from
        the system of record (works across process restarts)."""
        try:
            cfg = self.store.load_config(exp_id)
        except FileNotFoundError:
            raise ApiError(E_UNKNOWN_EXPERIMENT, f"no experiment {exp_id!r}")
        st = self.store.get_status(exp_id)
        obs = self.store.load_observations(exp_id)
        ok = [o for o in obs if not o.failed and o.value is not None]
        best = max(ok, key=lambda o: o.value) if ok else None
        return StatusResponse(
            exp_id=exp_id, state=st.get("state", "pending"), name=cfg.name,
            budget=cfg.budget, observations=len(obs),
            failures=sum(1 for o in obs if o.failed), pending=0,
            best=_public_best(best))

    def stop(self, exp_id: str, state: str = "stopped") -> StatusResponse:
        with self._lock:
            exp = self._exps.get(exp_id)
        if exp is not None:
            # stop writes a terminal status — fenced incarnations don't
            # get to flip a handed-over experiment's durable state
            self._check_fence(exp_id, exp)
            with exp.lock:
                exp.stopped = True
                pump = exp.pump
            if pump is not None:
                pump.stop(join=True)    # no new speculation after this
            with exp.opt_lock:
                drain_ops(exp)          # folds are real data — keep them
                retire_queue(exp)       # stopped: flush unconditionally
                with exp.lock:
                    doomed = [s.assignment for s in exp.pending.values()]
                    exp.pending.clear()
                    exp.orphaned.clear()
                    exp.sparse_ids.clear()
                    # unblock any parked miss slots with empty batches
                    slots, exp.miss_slots = exp.miss_slots, []
                    for sl in slots:
                        sl.done = True
                        sl.event.set()
                for a in doomed:
                    exp.optimizer.forget(a)
        elif not (self.store.exp_dir(exp_id) / "config.json").exists():
            raise ApiError(E_UNKNOWN_EXPERIMENT, f"no experiment {exp_id!r}")
        self.store.update_status(exp_id, state=state)
        return self.status(exp_id)

    def best_response(self, exp_id: str) -> BestResponse:
        return BestResponse(best=self.status(exp_id).best)

    def close(self) -> None:
        """Wind down every experiment's pump (service shutdown).  Leaves
        experiment state resumable: a later ``suggest``/``create`` simply
        restarts the pump."""
        with self._lock:
            states = list(self._exps.values())
        for st in states:
            with st.lock:
                pump = st.pump
            if pump is not None:
                pump.stop(join=True)
