"""Service-side asynchronous suggestion pipeline (prefetch pump + miss
coalescing) — the machinery that makes ``LocalClient.suggest`` latency
independent of model cost.

Three cooperating pieces (all operating on one ``_ExperimentState``):

* **Prefetch pump** (`SuggestionPump`): a per-experiment background thread
  that keeps a bounded queue of speculative suggestions warm.  Each queued
  suggestion was produced by a real ``ask()`` (so it carries its
  constant-liar ``__lie`` token and EI already accounts for it); the pump
  also absorbs the *deferred optimizer work* — observation folds,
  hyperparameter refits, lie retirement — that ``observe``/``release``
  only enqueue.  Cold-start cost (the CUDA kernels' build, library
  handles, first allocations) is moved off-path too: the pump prewarms
  the power-of-two GP shape buckets at start and again before the
  history crosses into the next bucket.

* **Miss coalescing** (`serve_misses`): concurrent ``suggest`` calls that
  find the queue dry park a `MissSlot` and race for the optimizer lock;
  the winner serves *every* parked slot with a single batched ``ask(n)``
  instead of N serialized model fits.  Losers wait on their slot's event
  — they never touch the optimizer.

* **Staleness bound**: every queued suggestion remembers the observation
  count it was computed at (``born_obs``).  Once ``staleness`` (K) new
  observations have arrived, the suggestion is *invalidated* — dropped at
  pop time (and proactively by the pump), its constant-liar lie retired —
  so a warm queue can never serve a point the model has since learned to
  avoid.  The same bound is what makes *sparse* refills safe: under
  saturation the pump refills from the optimizer's approximate
  subset-of-data posterior (``ask(n, speculative=True)``), and any
  approximation error is confined to queue entries at most K
  observations old.

* **Shared fit executor** (`FitExecutor`): hyperparameter-fit debt is
  never paid on a pump thread.  Pumps submit it to one process-wide
  priority-queue executor (miss-serving experiments first, idle
  maintenance last) whose workers run the fit compute without holding
  the experiment's optimizer lock (``Optimizer.fit_job``) — so N live
  experiments stop burning N cores on Adam loops while requests park.

Locking protocol (shared with ``repro_torch.api.local``): ``state.opt_lock``
serializes all optimizer access (ask/tell/forget/restore) and must be
acquired *before* ``state.lock`` (cheap bookkeeping) when both are held.
``state.ops`` — the deferred tell/forget queue — is only ever popped
while holding ``opt_lock`` (see ``drain_ops``), which is what makes
create/resume's "drain then replay the log tail" sequence race-free.
"""
from __future__ import annotations

import atexit
import heapq
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch import card_pool

#: Largest ``ask`` the pipeline issues per optimizer-lock hold (pump
#: refill ticks and coalesced miss rounds alike).  Bounds lock latency
#: (a request arriving mid-batch waits one chunk, not one queue fill)
#: and pins the q-EI scan shapes to the power-of-two pads <= 8 — exactly
#: what ``prewarm`` compiles, so no batch size ever pays a first-touch
#: scan compile on the request path.  Coalesced misses beyond a chunk
#: stay parked and are served by the next lock winner in ~one cheap
#: recondition+scan round each (hyperfits are deferred to the pump).
#: Only a single ``suggest(count > 8)`` call exceeds the chunk.
ASK_CHUNK = 8

#: FitExecutor priorities (lower = sooner): a fit for an experiment whose
#: requests are parking on queue misses beats one whose queue merely needs
#: refilling, which beats idle maintenance debt.
PRIO_MISS, PRIO_REFILL, PRIO_IDLE = 0, 1, 2

#: Sentinel a ``BatchableFit.snapshot`` returns to mean "requeue me"
#: (the optimizer lock was contended) — distinct from None ("nothing
#: owed, drop the job").
RETRY = object()


class FitLane:
    """One experiment's snapshotted fit, ready to join a batched
    dispatch: ``spec`` is the optimizer's batchable fit descriptor
    (``Optimizer.fit_spec`` — bucket, step count, copied arrays, a
    ``runner``) and ``install`` applies the fitted hyperparameters under
    that experiment's locks.  Lanes sharing ``group_key`` fit together
    in ONE lane-batched dispatch (``gp.batched_fit``)."""

    __slots__ = ("spec", "install")

    def __init__(self, spec, install):
        self.spec = spec
        self.install = install

    @property
    def group_key(self):
        """Lanes may co-batch iff this matches.  The spec defines its own
        grouping (``FitSpec``: (runner, bucket) — step counts merge via
        the masked variable-step loop; ``AskSpec``: (runner, bucket,
        k_pad, pool shape)); legacy specs without one group on
        (runner, bucket, steps), the older contract."""
        key = getattr(self.spec, "group_key", None)
        if key is not None:
            return key
        return (self.spec.runner, self.spec.bucket, self.spec.steps)


class BatchableFit:
    """Marker wrapper for executor jobs that can co-batch.
    ``snapshot()`` runs on a worker thread and returns a ``FitLane``,
    ``RETRY`` (lock contention — requeue), or None (debt already paid).
    The executor gathers every queued BatchableFit whose snapshot shares
    the primary's ``group_key`` into one dispatch."""

    __slots__ = ("snapshot",)

    def __init__(self, snapshot: Callable[[], Any]):
        self.snapshot = snapshot


class BatchableAsk(BatchableFit):
    """A batchable queue-refill *ask*.  Same snapshot/gather
    machinery as ``BatchableFit`` — the spec's ``kind`` ("ask") routes
    the dispatch to the ``batched_asks``/``ask_lanes`` counters so fit
    and ask batching stay separately observable.  Miss serving never
    goes through this path: coalesced misses keep their exact inline
    ``ask`` (PRIO_MISS semantics unchanged)."""
    __slots__ = ()


class FitExecutor:
    """Process-wide executor for deferred hyperparameter fits.

    Before this existed every per-experiment pump ran its own
    ``Optimizer.maintain()`` inline: N live experiments meant N threads
    each burning a core on an Adam loop while suggest requests parked
    behind the optimizer lock.  Now pumps only recondition and pop —
    fits are *submitted* here, deduplicated per experiment, and run by a
    small shared worker pool in priority order (miss-serving experiments
    first, idle ``maintain()`` debt last).

    Jobs are two-phase (``Optimizer.fit_job``): the expensive compute
    runs WITHOUT the experiment's optimizer lock (pure torch over a
    snapshot), and only the cheap install step takes the lock — so a
    fit in flight never blocks the request path.

    One instance serves the whole process (``fit_executor()``); workers
    are daemon threads, so tests and short-lived CLIs need no teardown.
    The workers are enrolled in the GP's fixed set of threads
    (``repro_torch.card_pool``): the GP's numerics run on them inline,
    and every other thread's GP work is handed to that set.
    ``submit`` coalesces by key (one outstanding job per experiment,
    escalating to the highest requested priority), which bounds the
    queue at O(live experiments)."""

    #: idle wait between queue polls (wakes are event-driven via submit)
    IDLE_WAIT = 0.25

    #: how long a non-urgent batchable fit waits for co-batchable peers
    #: to arrive before dispatching (seconds).  PRIO_MISS fits never
    #: wait — a request is parked on that fit's install.
    GATHER_WINDOW = 0.02

    #: bounds for the *dynamic* co-batch width (``max_lanes``): the cap
    #: on experiments fitted in one batched dispatch is sized from the
    #: executor's own saturation signals (backlog per worker, duty
    #: cycle) and rounded to a power of two so every width lands on a
    #: ``gp.lane_pad`` compile bucket
    LANES_MIN = 2
    LANES_CAP = 16

    #: legacy pin: when set, overrides the dynamic sizing with a fixed
    #: cap (tests pin this to make batch widths deterministic)
    MAX_LANES: Optional[int] = None

    #: window (seconds) over which the duty cycle decays — admission
    #: control wants *recent* saturation, not the lifetime average
    DUTY_WINDOW = 30.0

    def __init__(self, workers: Optional[int] = None):
        if workers is None:
            # a small shared pool: fits saturate the device (torch releases
            # the GIL), so more workers than ~cpu/4 just thrash the caches
            workers = max(1, min(2, (os.cpu_count() or 2) // 4))
        self.workers = workers
        self._cv = threading.Condition()
        self._heap: List[tuple] = []            # (prio, seq, key)
        self._jobs: Dict[Any, tuple] = {}       # key -> (prio, fn)
        self._active: set = set()               # keys running on a worker
        # job kind -> key of the job whose worker is gathering peers of
        # that kind; other workers leave such jobs for its batch
        self._gathering: Dict[type, Any] = {}
        self._seq = 0
        self._stopped = False
        self.stats = {"executed": 0, "coalesced": 0, "requeued": 0,
                      "batched": 0, "lanes": 0,
                      "batched_asks": 0, "ask_lanes": 0}
        # duty-cycle accounting (the fleet's admission-control signal):
        # busy worker-seconds, decayed over DUTY_WINDOW so a burst of
        # fits shows up — and clears — within one window
        self._duty_busy = 0.0
        self._duty_mark = time.monotonic()
        self._threads = [
            threading.Thread(target=self._run, name=f"fit-exec-{i}",
                             daemon=True)
            for i in range(workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- queue
    def submit(self, key: Any, fn: Callable[[], bool],
               prio: int = PRIO_IDLE) -> None:
        """Queue ``fn`` under ``key``; one job per key is outstanding at
        a time (re-submits coalesce, keeping the most recent ``fn`` and
        the most urgent priority).  ``fn`` runs on a worker thread and
        returns True to be requeued (e.g. it lost an optimizer-lock
        race)."""
        with self._cv:
            if self._stopped:
                return
            if key in self._active:
                # this key's job is mid-run on a worker: don't queue a
                # second fit for the same experiment (the debt check is
                # level-triggered — the pump re-submits on a later tick
                # once the running fit has installed, if still owed)
                self.stats["coalesced"] += 1
                return
            cur = self._jobs.get(key)
            if cur is not None:
                self.stats["coalesced"] += 1
                if prio < cur[0]:       # escalate: push a fresher entry;
                    self._jobs[key] = (prio, fn)    # the stale one is
                    self._seq += 1                  # skipped at pop time
                    heapq.heappush(self._heap, (prio, self._seq, key))
                    self._cv.notify()
                else:
                    self._jobs[key] = (cur[0], fn)
                return
            self._jobs[key] = (prio, fn)
            self._seq += 1
            heapq.heappush(self._heap, (prio, self._seq, key))
            self._cv.notify()

    def cancel(self, key: Any) -> bool:
        """Drop the outstanding job for ``key`` (experiment stopped)."""
        with self._cv:
            return self._jobs.pop(key, None) is not None

    def backlog(self) -> int:
        with self._cv:
            return len(self._jobs)

    @property
    def alive(self) -> bool:
        return not self._stopped and any(t.is_alive() for t in self._threads)

    def stop(self, join: bool = True) -> None:
        """Tear down (tests only — the process-wide singleton normally
        lives as long as the process; its threads are daemons)."""
        with self._cv:
            self._stopped = True
            self._jobs.clear()
            self._heap.clear()
            self._cv.notify_all()
        if join:
            for t in self._threads:
                if t is not threading.current_thread():
                    t.join(timeout=5.0)

    def _decay_duty(self, now: float) -> None:
        """Exponential decay of the busy accumulator (holding _cv)."""
        dt = now - self._duty_mark
        if dt > 0:
            self._duty_busy *= 0.5 ** (dt / self.DUTY_WINDOW)
            self._duty_mark = now

    def duty(self) -> float:
        """Fraction of worker capacity spent running fits over the recent
        window, in [0, 1] — together with ``backlog`` this is the shard
        saturation signal the FleetManager admits against."""
        with self._cv:
            now = time.monotonic()
            self._decay_duty(now)
            # a freshly-started executor has no window yet; normalize by
            # the half-life-weighted capacity of the window
            cap = self.workers * self.DUTY_WINDOW / 2.0
            return min(1.0, self._duty_busy / cap) if cap > 0 else 0.0

    def _max_lanes_locked(self, duty: float) -> int:
        """Dynamic co-batch cap (holding ``_cv``): aim to clear the
        current backlog in one dispatch round per worker, doubling when
        the recent duty cycle says the pool is saturated (bigger batches
        amortize better exactly when dispatches are the bottleneck);
        round up to a power of two (compile-bucket alignment), clamp to
        [LANES_MIN, LANES_CAP]."""
        if self.MAX_LANES is not None:
            return self.MAX_LANES
        want = (len(self._jobs) + self.workers - 1) // max(1, self.workers)
        if duty >= 0.5:
            want *= 2
        lanes = self.LANES_MIN
        while lanes < want and lanes < self.LANES_CAP:
            lanes *= 2
        return lanes

    def max_lanes(self) -> int:
        """Current cap on experiments co-batched into one dispatch."""
        with self._cv:
            now = time.monotonic()
            self._decay_duty(now)
            cap = self.workers * self.DUTY_WINDOW / 2.0
            duty = min(1.0, self._duty_busy / cap) if cap > 0 else 0.0
            return self._max_lanes_locked(duty)

    def snapshot(self) -> Dict[str, Any]:
        with self._cv:
            now = time.monotonic()
            self._decay_duty(now)
            cap = self.workers * self.DUTY_WINDOW / 2.0
            duty = min(1.0, self._duty_busy / cap) if cap > 0 else 0.0
            batched = self.stats["batched"]
            mean_batch = (round(self.stats["lanes"] / batched, 3)
                          if batched else 0.0)
            b_asks = self.stats["batched_asks"]
            mean_ask_batch = (round(self.stats["ask_lanes"] / b_asks, 3)
                              if b_asks else 0.0)
            return dict(self.stats, backlog=len(self._jobs),
                        workers=self.workers, duty=round(duty, 4),
                        mean_batch=mean_batch,
                        mean_ask_batch=mean_ask_batch,
                        max_lanes=self._max_lanes_locked(duty))

    # ----------------------------------------------------------- workers
    def _gathers(self, fn, prio: int) -> bool:
        """Whether ``fn`` waits one GATHER_WINDOW for peers to join it."""
        return (isinstance(fn, BatchableFit) and prio > PRIO_MISS
                and self.GATHER_WINDOW > 0.0)

    def _end_gather(self, fn, key) -> None:
        """Hand ``fn``'s kind back to every worker (holding ``_cv``)."""
        if self._gathering.get(type(fn)) == key:
            del self._gathering[type(fn)]
            self._cv.notify_all()

    def _pop(self):
        """Highest-priority live job, or None after an idle wait.  Heap
        entries whose key was cancelled/coalesced away (priority no
        longer matching) are lazily skipped.  A job of a kind another
        worker is gathering peers of stays queued for that worker's batch
        — a second worker popping it would dispatch it alone."""
        with self._cv:
            while not self._stopped:
                held, found = [], None
                while self._heap:
                    entry = heapq.heappop(self._heap)
                    prio, _, key = entry
                    cur = self._jobs.get(key)
                    if cur is None or cur[0] != prio:
                        continue
                    if type(cur[1]) in self._gathering:
                        held.append(entry)
                        continue
                    found = (key, cur[1], prio)
                    break
                for entry in held:
                    heapq.heappush(self._heap, entry)
                if found is not None:
                    key, fn, prio = found
                    del self._jobs[key]
                    self._active.add(key)
                    if self._gathers(fn, prio):
                        self._gathering[type(fn)] = key
                    return found
                self._cv.wait(self.IDLE_WAIT)
                if not self._heap:
                    return None
            return None

    def _run(self) -> None:
        # one of the GP's fixed threads: its fits and asks run here inline
        card_pool.enroll()
        while True:
            item = self._pop()
            if item is None:
                if self._stopped:
                    return
                continue
            key, fn, prio = item
            err = None
            sleep_adj = 0.0
            t0 = time.monotonic()
            try:
                if isinstance(fn, BatchableFit):
                    again, sleep_adj = self._run_batch(key, fn, prio)
                else:
                    again = bool(fn())
            except Exception as e:  # noqa: executor must survive any job
                again = False
                err = f"{type(e).__name__}: {e}"
            with self._cv:
                self._end_gather(fn, key)   # if it ended before its grab
                self._active.discard(key)   # before any re-submit
                self._decay_duty(time.monotonic())
                # gather-window sleeps are idle time, not fit work —
                # they must not inflate the admission-control duty cycle
                self._duty_busy += max(
                    0.0, time.monotonic() - t0 - sleep_adj)
                self.stats["executed"] += 1
                if again:
                    self.stats["requeued"] += 1
                if err is not None:
                    # surfaced via snapshot()/StatusResponse — a
                    # persistently failing fit must not die silently
                    # (the pump keeps re-submitting while debt is owed)
                    self.stats["failed"] = self.stats.get("failed", 0) + 1
                    self.stats["last_error"] = err
            if again:
                self.submit(key, fn, prio)

    def _run_batch(self, key: Any, fn: BatchableFit,
                   prio: int) -> tuple:
        """Execute one batchable fit, co-batching queued peers.

        Snapshot the primary lane; unless the fit is miss-urgent, sleep
        one GATHER_WINDOW so concurrently-owed experiments can queue;
        then pull every queued ``BatchableFit`` whose snapshot shares
        the primary's (runner, bucket, steps) group and dispatch them
        all through ONE ``runner(specs)`` call — the optimizer stacks
        the lanes and runs the Adam loop lane-batched, so k fits cost one
        batched dispatch instead of k.  Installs run per lane, individually
        exception-guarded, each under its own experiment's optimizer
        lock (the two-phase contract is per lane, unchanged).

        Returns (requeue_primary, seconds_slept) — the sleep is
        subtracted from the duty-cycle accounting by ``_run``."""
        lane = fn.snapshot()
        if lane is RETRY:
            return True, 0.0
        if lane is None:
            return False, 0.0
        slept = 0.0
        if self._gathers(fn, prio):
            # deliberate plain sleep (not a _cv wait): we *want* to stay
            # out of the way while pumps enqueue peers
            time.sleep(self.GATHER_WINDOW)
            slept = self.GATHER_WINDOW
        grabbed: List[tuple] = []
        lanes_cap = self.max_lanes()
        with self._cv:
            for k2 in list(self._jobs):
                if 1 + len(grabbed) >= lanes_cap:
                    break
                p2, f2 = self._jobs[k2]
                # same kind only: a fit and a refill ask never share a
                # group, so grabbing the other kind wastes a peer slot and
                # a snapshot under that experiment's optimizer lock
                if type(f2) is type(fn):
                    del self._jobs[k2]
                    self._active.add(k2)
                    grabbed.append((k2, p2, f2))
            self._end_gather(fn, key)
        lanes = [(key, lane)]
        for k2, p2, f2 in grabbed:
            try:
                l2 = f2.snapshot()
            except Exception as e:  # noqa: peer snapshot must not kill batch
                with self._cv:
                    self._active.discard(k2)
                    self.stats["failed"] = self.stats.get("failed", 0) + 1
                    self.stats["last_error"] = f"{type(e).__name__}: {e}"
                continue
            if (l2 is not None and l2 is not RETRY
                    and l2.group_key == lane.group_key):
                lanes.append((k2, l2))
                continue
            # not co-batchable: release the key BEFORE re-submitting so
            # submit() doesn't coalesce the job away as "active"
            with self._cv:
                self._active.discard(k2)
            if l2 is not None:      # RETRY or mismatched group: still owed
                self.submit(k2, f2, p2)
        try:
            out, dt = lane.spec.runner([l.spec for _, l in lanes])
            per = dt / max(1, len(lanes))
            failed = 0
            err = None
            for (_, l), params in zip(lanes, out):
                try:
                    l.install(params, per)
                except Exception as e:  # noqa: one bad install ≠ batch loss
                    failed += 1
                    err = f"{type(e).__name__}: {e}"
            is_ask = getattr(lane.spec, "kind", "fit") == "ask"
            with self._cv:
                # fit and ask dispatches count separately, so mean_batch
                # stays a pure fit-co-batching signal (tests pin it)
                self.stats["batched_asks" if is_ask else "batched"] += 1
                self.stats["ask_lanes" if is_ask else "lanes"] += len(lanes)
                # _run counts the primary; peers are accounted here
                self.stats["executed"] += len(lanes) - 1
                if failed:
                    self.stats["failed"] = (
                        self.stats.get("failed", 0) + failed)
                    self.stats["last_error"] = err
        finally:
            with self._cv:
                for k2, _ in lanes[1:]:
                    self._active.discard(k2)
        return False, slept


_EXECUTOR: Optional[FitExecutor] = None
_EXECUTOR_LOCK = threading.Lock()


@atexit.register
def _shutdown_executor() -> None:
    """Drain the executor before interpreter teardown.  Its workers are
    daemon threads issuing CUDA work; since the batched ask plane keeps
    them busy whenever any queue is below depth, a process exiting
    mid-dispatch would tear the CUDA runtime down under a worker that is
    still inside a call and abort instead of exiting cleanly.  stop()
    discards the queue and joins the in-flight job."""
    ex = _EXECUTOR
    if ex is not None and ex.alive:
        ex.stop(join=True)


def fit_executor() -> FitExecutor:
    """The process-wide fit executor (created on first use; replaced if a
    test stopped the previous one)."""
    global _EXECUTOR
    with _EXECUTOR_LOCK:
        if _EXECUTOR is None or not _EXECUTOR.alive:
            _EXECUTOR = FitExecutor()
        return _EXECUTOR


def cancel_fit(key: Any) -> None:
    """Cancel a queued fit without instantiating the executor (pump
    teardown on processes that never submitted a fit)."""
    ex = _EXECUTOR
    if ex is not None and ex.alive:
        ex.cancel(key)


def executor_snapshot() -> Optional[Dict[str, Any]]:
    """The live executor's counters, or None — status/monitoring reads
    must not spawn the worker pool as a side effect."""
    ex = _EXECUTOR
    if ex is not None and ex.alive:
        return ex.snapshot()
    return None


class PrefetchItem:
    """One speculative suggestion waiting in the pump queue.  ``sparse``
    marks entries minted from the sparse subset-of-data posterior (queue
    refills under saturation) rather than the exact one."""
    __slots__ = ("assignment", "born_obs", "sparse")

    def __init__(self, assignment: Dict[str, Any], born_obs: int,
                 sparse: bool = False):
        self.assignment = assignment
        self.born_obs = born_obs
        self.sparse = sparse


class MissSlot:
    """A ``suggest`` call waiting out a queue miss.  Filled (with up to
    ``need`` suggestions — possibly fewer, budget permitting) by whichever
    thread wins the optimizer lock and serves the coalesced batch."""
    __slots__ = ("need", "event", "result", "done")

    def __init__(self, need: int):
        self.need = need
        self.event = threading.Event()
        self.result: List[Any] = []
        self.done = False


def drain_ops(state) -> int:
    """Apply the deferred optimizer operations (observation folds and lie
    retirements that ``observe``/``release`` enqueued).  MUST be called
    with ``state.opt_lock`` held; pops under ``state.lock`` so no op is
    ever in flight outside both locks.  Returns the number applied."""
    with state.lock:
        ops, state.ops = state.ops, []
    if not ops:
        return 0
    tells: List[Any] = []
    for kind, payload in ops:
        if kind == "tell":
            tells.append(payload)
        else:                           # "forget"
            if tells:
                state.optimizer.tell(tells)
                tells = []
            state.optimizer.forget(payload)
    if tells:
        state.optimizer.tell(tells)
    return len(ops)


def pop_prefetched(state, want: int):
    """Pop up to ``want`` fresh queue items; returns (fresh
    ``PrefetchItem``s, stale assignments).  MUST be called with
    ``state.lock`` held.  Stale items (older than the K-observation
    staleness bound) are skimmed off and returned for lie retirement —
    they are never served.  Fresh items keep their ``sparse`` flag so
    the mint step can attribute the served suggestion to the exact or
    approximate posterior (the SPARSE_MAX quality counters)."""
    fresh: List[PrefetchItem] = []
    stale: List[Dict[str, Any]] = []
    sparse_served = 0
    while state.queue and len(fresh) < want:
        # LIFO: always serve the *freshest* speculation — it was computed
        # against the most observations.  Older entries age toward the
        # staleness bound at the front and are swept by the pump.
        item = state.queue.pop()
        if state.observed - item.born_obs >= state.staleness:
            stale.append(item.assignment)
        else:
            fresh.append(item)
            sparse_served += bool(item.sparse)
    if stale:
        state.stats["invalidated"] += len(stale)
    if fresh:
        state.stats["hits"] += len(fresh)
    if sparse_served:
        # how much of the served traffic rode the approximate posterior —
        # the signal for tuning SPARSE_MAX
        state.stats["sparse_served"] = (
            state.stats.get("sparse_served", 0) + sparse_served)
    return fresh, stale


def retire_queue(state, terminal_only: bool = False) -> int:
    """Flush the prefetch queue and retire its constant-liar lies.  MUST
    be called with ``state.opt_lock`` held.  With ``terminal_only`` the
    flush only happens once the experiment can't serve again (stopped or
    budget spent) — the shared hygiene used by the pump's wind-down,
    ``status()`` and ``stop()``.  Returns the number retired."""
    with state.lock:
        if terminal_only and not (state.stopped
                                  or state.observed >= state.cfg.budget):
            return 0
        doomed = [i.assignment for i in state.queue]
        state.queue = []
        if doomed:
            state.stats["invalidated"] += len(doomed)
    for a in doomed:
        state.optimizer.forget(a)
    return len(doomed)


def serve_misses(state, make_suggestion: Callable[[Dict[str, Any]], Any]) -> int:
    """Serve parked `MissSlot`s with ONE batched ``ask`` (cross-scheduler
    request coalescing: concurrent queue misses share one model pass, not
    N serialized ones).  MUST be called with ``state.opt_lock`` held.
    ``make_suggestion`` mints a pending Suggestion from an assignment —
    called under ``state.lock``.  A round serves up to ``ASK_CHUNK``
    suggestions (the first slot is always taken whole); overflow slots
    stay parked for the next lock winner — usually their own waiting
    thread's retry loop.  Returns the number of slots served."""
    drain_ops(state)
    with state.lock:
        waiting = [s for s in state.miss_slots if not s.done]
        slots, acc = [], 0
        for s in waiting:
            if slots and acc + s.need > ASK_CHUNK:
                break
            slots.append(s)
            acc += s.need
        state.miss_slots = waiting[len(slots):]
        if not slots:
            return 0
        if state.stopped:
            total = 0
        else:
            headroom = (state.cfg.budget - state.observed
                        - len(state.pending))
            total = min(sum(s.need for s in slots), max(0, headroom))
    assigns = state.optimizer.ask(total) if total > 0 else []
    with state.lock:
        # headroom may have shrunk while we computed (queue pops register
        # pending under state.lock only) — never overdraw the budget
        headroom = state.cfg.budget - state.observed - len(state.pending)
        if state.stopped:
            headroom = 0
        usable = assigns[:max(0, headroom)]
        extra = assigns[len(usable):]
        i = 0
        for slot in slots:
            take = usable[i:i + slot.need]
            i += len(take)
            slot.result = [make_suggestion(a) for a in take]
            slot.done = True
            slot.event.set()
        extra.extend(usable[i:])
        if len(slots) > 1:
            state.stats["coalesced"] += len(slots) - 1
        state.stats["misses"] += len(slots)
    for a in extra:     # opt_lock still held
        state.optimizer.forget(a)
    return len(slots)


class SuggestionPump:
    """Per-experiment background worker: folds deferred observations,
    refits the model, prewarms compile buckets, invalidates stale queue
    entries, and keeps the prefetch queue at ``depth``.  Owns no locks of
    its own — it speaks the same ``opt_lock``/``state.lock`` protocol as
    the request path, always acquiring ``opt_lock`` with a timeout so
    ``stop()`` stays responsive even mid-fit."""

    #: fallback poll period — wakes are event-driven (observe/suggest/stop)
    IDLE_WAIT = 0.25

    def __init__(self, state, exp_id: str, depth: int,
                 make_suggestion: Callable[[Dict[str, Any]], Any]):
        self.state = state
        self.exp_id = exp_id
        self.depth = depth
        self.make_suggestion = make_suggestion
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._prewarm_goal = 0
        # miss counter at the last tick — the saturation signal.  Seeded
        # from the state so a restarted pump (close/resume reuses the
        # _ExperimentState) doesn't read pre-restart misses as live
        # saturation and serve sparse refills on an idle service.
        self._seen_misses = state.stats.get("misses", 0)
        self._thread = threading.Thread(
            target=self._run, name=f"suggest-pump-{exp_id}", daemon=True)

    @property
    def fit_key(self) -> tuple:
        """This experiment's coalescing key on the shared FitExecutor."""
        return ("fit", id(self.state))

    @property
    def ask_key(self) -> tuple:
        """Coalescing key of this experiment's batched refill ask — a
        separate key from ``fit_key`` so a queued refill never coalesces
        away an owed hyperfit (or vice versa)."""
        return ("ask", id(self.state))

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "SuggestionPump":
        self._thread.start()
        return self

    def wake(self) -> None:
        self._wake.set()

    def stop(self, join: bool = True, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        cancel_fit(self.fit_key)
        cancel_fit(self.ask_key)
        if join and self._thread.is_alive() \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive() and not self._stop.is_set()

    # ------------------------------------------------------------ internals
    def _run(self) -> None:
        state = self.state
        # pipeline mode: ask() folds new data by cheap recondition; the
        # hyperparameter refits run here, in maintain(), when quiet
        state.optimizer.defer_fits = True
        try:
            self._prewarm()
            while not self._stop.is_set():
                busy = self._tick()
                if self._stop.is_set() or self._finished():
                    break
                if not busy:
                    self._wake.wait(self.IDLE_WAIT)
                    self._wake.clear()
        except Exception as e:  # noqa: pump death must not kill the service
            with state.lock:
                state.stats["pump_error"] = f"{type(e).__name__}: {e}"
        finally:
            # back to synchronous semantics for any pump-less aftermath
            state.optimizer.defer_fits = False

    def _finished(self) -> bool:
        state = self.state
        with state.lock:
            return state.stopped or state.observed >= state.cfg.budget

    def _prewarm(self) -> None:
        """Compile the shape buckets the near-term asks will need.  Reads
        only immutable optimizer config — runs without
        ``opt_lock`` so the first suggests aren't blocked behind compiles."""
        state = self.state
        with state.lock:
            n = (state.observed + len(state.pending) + len(state.queue)
                 + self.depth + 8)
            goal = min(max(n, 1), state.cfg.budget + self.depth)
        if goal <= self._prewarm_goal:
            return
        self._prewarm_goal = goal
        warmed = state.optimizer.prewarm(goal, batch=min(self.depth, 8))
        if warmed:
            with state.lock:
                state.stats["prewarmed"] += warmed

    def _tick(self) -> bool:
        """One unit of pump work; returns True when anything was done (the
        loop re-ticks immediately) and False to idle-wait.  Hyperfits are
        NOT run here: debt is submitted to the shared ``FitExecutor`` so
        the pump thread only reconditions and pops."""
        state = self.state
        self._prewarm()     # cheap no-op once the goal bucket is compiled
        if not state.opt_lock.acquire(timeout=0.1):
            return True     # contended: re-check stop flag, then retry
        try:
            if self._stop.is_set():
                return False
            busy = drain_ops(state) > 0
            # a parked miss means the queue is already dry — serve it first
            busy = serve_misses(state, self.make_suggestion) > 0 or busy
            # terminal: nothing more will be served — retire the whole
            # queue's lies and let the thread wind down
            retired = retire_queue(state, terminal_only=True)
            # prune stale speculation, then top the queue back up
            with state.lock:
                stale = [i.assignment for i in state.queue
                         if state.observed - i.born_obs >= state.staleness]
                if stale:
                    state.queue = [
                        i for i in state.queue
                        if state.observed - i.born_obs < state.staleness]
                    state.stats["invalidated"] += len(stale)
                if state.stopped or state.observed >= state.cfg.budget:
                    want = 0
                else:
                    headroom = (state.cfg.budget - state.observed
                                - len(state.pending) - len(state.queue))
                    # chunked refill: bounded lock hold + bounded q-EI
                    # scan shapes; the loop re-ticks until at depth
                    want = min(self.depth - len(state.queue),
                               max(0, headroom), ASK_CHUNK)
                # saturation signal: requests outran the warm queue since
                # the last tick (served misses, or slots parked right now)
                misses_now = state.stats["misses"]
                saturated = (misses_now > self._seen_misses
                             or bool(state.miss_slots))
                self._seen_misses = misses_now
            for a in stale:
                state.optimizer.forget(a)
            swept = bool(stale) or retired > 0
            self._tune_sparse()
            self._push_fit_debt(saturated, want)
            if want <= 0:
                return busy or swept
            # under saturation a speculative_ask optimizer refills from
            # its sparse posterior — bounded cost regardless of history
            # size, so the queue keeps pace past refit-bound throughput;
            # misses and synchronous asks still use the exact path.
            # sparse_eligible() confirms the sparse path would really
            # engage (enough history, fitted model), so the sparse_*
            # counters never mislabel exact suggestions
            spec = (saturated
                    and getattr(state.optimizer, "speculative_ask", False)
                    and state.optimizer.sparse_eligible())
            if (getattr(state.optimizer, "batchable_asks", False)
                    and state.optimizer.ask_spec_ready()):
                # batched ask plane: publish the refill as a
                # batchable snapshot on the shared executor, which may
                # co-batch it with other experiments' refills into ONE
                # lane-batched q-EI dispatch; its install callback fills the
                # queue and wakes this pump.  Misses never ride this
                # path — serve_misses above keeps its exact inline ask.
                fit_executor().submit(
                    self.ask_key,
                    BatchableAsk(lambda: self._ask_lane(spec)),
                    PRIO_REFILL)
                return busy or swept
            assigns = (state.optimizer.ask(want, speculative=True)
                       if spec else state.optimizer.ask(want))
            with state.lock:
                if state.stopped or state.observed >= state.cfg.budget:
                    take = []
                else:
                    headroom = (state.cfg.budget - state.observed
                                - len(state.pending) - len(state.queue))
                    take = assigns[:max(0, headroom)]
                state.queue.extend(
                    PrefetchItem(a, state.observed, sparse=spec)
                    for a in take)
                state.stats["prefilled"] += len(take)
                if spec:
                    state.stats["sparse_prefilled"] = (
                        state.stats.get("sparse_prefilled", 0) + len(take))
                extra = assigns[len(take):]
            for a in extra:
                state.optimizer.forget(a)
            return True
        finally:
            state.opt_lock.release()

    def _tune_sparse(self) -> None:
        """Feed the service's sparse-vs-exact suggestion quality counters
        back into the optimizer's live sparse-subset budget
        (``Optimizer.tune_sparse`` grows/shrinks it from observed
        regret).
        Called with ``opt_lock`` held."""
        tune = getattr(self.state.optimizer, "tune_sparse", None)
        if tune is None:
            return
        state = self.state
        with state.lock:
            quality = {k: state.stats.get(k, 0)
                       for k in ("sparse_obs", "sparse_regret",
                                 "exact_obs", "exact_regret")}
        tune(quality)

    def _push_fit_debt(self, saturated: bool, want: int) -> None:
        """Submit owed hyperfit work to the shared executor, prioritized
        by how starved this experiment is.  Called with ``opt_lock``
        held (``maintenance_due`` reads optimizer state).  Optimizers
        that publish batchable fit descriptors (``batchable_fits``) go
        through the co-batching path; the rest keep the plain
        two-phase ``fit_job`` contract."""
        if not self.state.optimizer.maintenance_due():
            return
        prio = (PRIO_MISS if saturated
                else PRIO_REFILL if want > 0 else PRIO_IDLE)
        if getattr(self.state.optimizer, "batchable_fits", False):
            fit_executor().submit(self.fit_key,
                                  BatchableFit(self._fit_lane), prio)
        else:
            fit_executor().submit(self.fit_key, self._maintain_job, prio)

    def _fit_lane(self):
        """Snapshot this experiment's owed fit as a batchable lane
        (``FitExecutor._run_batch``'s snapshot phase).  Returns a
        ``FitLane``, ``RETRY`` on optimizer-lock contention, or None
        when the debt has already been paid.  The lane's install runs
        later on the executor thread, under ``opt_lock`` — the same
        two-phase contract as ``_maintain_job``, split so the compute
        phase can be shared across experiments."""
        state = self.state
        if self._stop.is_set():
            return None
        if not state.opt_lock.acquire(timeout=0.05):
            return None if self._stop.is_set() else RETRY
        try:
            drain_ops(state)            # the fit should see every fold
            spec = state.optimizer.fit_spec()
        finally:
            state.opt_lock.release()
        if spec is None:
            return None

        def install(params, dt):
            with state.opt_lock:
                if self._stop.is_set():
                    return
                spec.install(params, dt)
                with state.lock:
                    state.stats["maintained"] = (
                        state.stats.get("maintained", 0) + 1)
        return FitLane(spec, install)

    def _ask_lane(self, speculative: bool):
        """Snapshot this experiment's queue refill as a batchable ask
        lane.  Phase 1, here: under ``opt_lock``, drain the
        deferred folds, recompute the refill budget (``want`` may have
        shrunk since the tick that submitted us), and let the optimizer
        snapshot an ``AskSpec`` — posterior prepared, selection
        deferred.  Returns a ``FitLane``, ``RETRY`` on lock contention,
        or None when no refill is owed anymore.  Phase 2 (the q-EI
        scan) runs lock-free on the executor, possibly co-batched;
        phase 3 — the install below — mints the assignments and
        extends the queue under this experiment's own locks."""
        state = self.state
        if self._stop.is_set():
            return None
        if not state.opt_lock.acquire(timeout=0.05):
            return None if self._stop.is_set() else RETRY
        try:
            drain_ops(state)
            with state.lock:
                if state.stopped or state.observed >= state.cfg.budget:
                    return None
                headroom = (state.cfg.budget - state.observed
                            - len(state.pending) - len(state.queue))
                want = min(self.depth - len(state.queue),
                           max(0, headroom), ASK_CHUNK)
                born = state.observed
            if want <= 0:
                return None
            spec = state.optimizer.ask_spec(want, speculative=speculative)
        finally:
            state.opt_lock.release()
        if spec is None:
            return None
        inner = spec.install
        sparse = spec.sparse

        def install(result, dt):
            with state.opt_lock:
                if self._stop.is_set():
                    return
                assigns = inner(result, dt)
                with state.lock:
                    if state.stopped or state.observed >= state.cfg.budget:
                        take = []
                    else:
                        headroom = (state.cfg.budget - state.observed
                                    - len(state.pending) - len(state.queue))
                        take = assigns[:max(0, headroom)]
                    # born is the snapshot-time observation count: the
                    # staleness clock starts when the posterior was
                    # captured, not when the dispatch landed
                    state.queue.extend(
                        PrefetchItem(a, born, sparse=sparse) for a in take)
                    state.stats["prefilled"] += len(take)
                    state.stats["batched_prefilled"] = (
                        state.stats.get("batched_prefilled", 0) + len(take))
                    if sparse:
                        state.stats["sparse_prefilled"] = (
                            state.stats.get("sparse_prefilled", 0)
                            + len(take))
                    extra = assigns[len(take):]
                for a in extra:
                    state.optimizer.forget(a)
            self._wake.set()
        return FitLane(spec, install)

    def _maintain_job(self) -> bool:
        """One deferred hyperfit, run on the shared FitExecutor.  Phase
        1 snapshots the fit under ``opt_lock`` (cheap), phase 2 runs the
        Adam loop with NO lock held, phase 3 installs the result under
        ``opt_lock`` (cheap) — requests never wait behind the fit
        itself.  Returns True to be requeued after losing the lock
        race."""
        state = self.state
        if self._stop.is_set():
            return False
        if not state.opt_lock.acquire(timeout=0.05):
            return not self._stop.is_set()
        try:
            drain_ops(state)            # the fit should see every fold
            job = state.optimizer.fit_job()
        finally:
            state.opt_lock.release()
        if job is None:
            return False
        install = job()                 # the expensive part — lock-free
        with state.opt_lock:
            if not self._stop.is_set():
                install()
                with state.lock:
                    state.stats["maintained"] = (
                        state.stats.get("maintained", 0) + 1)
        return False
