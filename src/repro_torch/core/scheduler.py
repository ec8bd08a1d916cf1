"""Parallel trial scheduler — the Kubernetes-job-controller analogue.

Responsibilities (paper mapping):
* keep ``parallel`` trials in flight against the suggestion service (§2.1:
  "evaluating multiple model configurations simultaneously");
* admission control against the cluster allocator (§3.5.1: Kubernetes
  "manages resource and capacity limitations" -> our allocator does);
* failed observations are first-class results, with bounded retries
  (§2.5: "code throwing exceptions ... report failure");
* early stopping via ``ctx.report`` (§2.5 stopping experiments) — the
  decision is made SERVICE-side (shared ASHA rung table behind
  ``SuggestionClient.report``), so any number of schedulers driving one
  experiment prune consistently; this scheduler only honors the decision:
  ``stop`` prunes the trial, ``pause`` checkpoints its progress marker,
  releases the lease, and requeues the spec for a later resume (promotion);
* straggler mitigation: speculative duplicate of the slowest running trial
  when it exceeds ``straggler_factor x`` the median completed runtime and a
  slot is free — first finisher wins (beyond-paper, required at 1000-node
  scale);
* preemption/revocation: a revoked lease requeues the trial; trials resume
  from their checkpoint directory if they wrote one.

Trials run on a thread pool: PyTorch releases the GIL inside its native
kernels and CUDA calls (a trial's Python between them still holds it),
and each trial drives the devices of its lease.  The scheduler never
holds a raw ``Optimizer``: it drives a ``SuggestionClient`` (suggest /
observe / release — see API.md), so the same loop runs against the
in-process ``LocalClient`` or a remote HTTP suggestion service.  The
service is the single writer of the observation log; the scheduler writes
only trial logs and its local status mirror.
"""
from __future__ import annotations

import json
import queue
import threading
import time
import traceback
import uuid
from concurrent.futures import FIRST_COMPLETED, Future, ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.api.client import SuggestionClient
from repro_torch.api.protocol import (ApiError, DECISION_CONTINUE,
                                      DECISION_PAUSE, DECISION_STOP,
                                      ObserveRequest, ReportRequest)
from repro_torch.core.cluster import Cluster, SliceLease
from repro_torch.core.experiment import ExperimentConfig, TrialSpec
from repro_torch.core.space import strip_internal
from repro_torch.core.store import Store


class TrialExit(Exception):
    """Base for control-flow exits raised from ``ctx.report``; carries the
    last reported (step, value) so harvest can record the partial curve."""

    def __init__(self, trial_id, step=None, value=None):
        super().__init__(trial_id)
        self.step, self.value = step, value


class TrialStopped(TrialExit):
    """Raised inside a trial when the service (or delete) says stop.
    The pruned trial still yields a (partial) observation — rung values
    are informative, not failures."""


class TrialPaused(TrialExit):
    """Raised inside a trial when the service answers ``pause``: the trial
    winds down, its lease is released and its spec requeued; it resumes
    later from its checkpoint (promotion-based early stopping)."""


class TrialPreempted(Exception):
    """Raised when the trial's slice was revoked mid-run."""


@dataclass
class TrialContext:
    """Handed to the user's trial function (the 'container environment')."""
    trial_id: str
    experiment_id: str
    lease: Optional[SliceLease]
    checkpoint_dir: str
    _log: Callable[[str], None]
    _report: Callable[[int, float], str]
    _should_stop: Callable[[], bool]
    resume_step: Optional[int] = None   # set when resuming a paused trial:
                                        # the step it last reported (your
                                        # checkpoint in checkpoint_dir is
                                        # at or beyond this step)

    def log(self, msg: str) -> None:
        self._log(msg)

    def report(self, step: int, value: float) -> None:
        """Progress report — a thin client call to the suggestion
        service's trial-events endpoint.  Raises to end this execution:
        ``TrialStopped`` on a final prune (service decision / delete /
        speculative loser), ``TrialPaused`` when the service parks the
        trial pending promotion, ``TrialPreempted`` on lease revocation.
        Save your checkpoint (to ``checkpoint_dir``) before or at each
        report so pause/preemption can resume without losing work."""
        if self.lease is not None and self.lease.revoked:
            raise TrialPreempted(self.trial_id)
        if self._should_stop():
            raise TrialStopped(self.trial_id, step, value)
        decision = self._report(step, value)
        if decision == DECISION_STOP:
            raise TrialStopped(self.trial_id, step, value)
        if decision == DECISION_PAUSE:
            raise TrialPaused(self.trial_id, step, value)


@dataclass
class _Running:
    spec: TrialSpec
    future: Future
    lease: Optional[SliceLease]
    started: float
    stop_flag: threading.Event
    speculative_of: Optional[str] = None


class _Reporter:
    """Worker-side report batching: at most one service round trip per
    ``cfg.report_every`` steps per trial (same-step repeats always
    coalesce), so a tight training loop can't DoS the service — but a
    rung boundary is never skipped: the service returns ``next_rung`` and
    any report at/past it goes through regardless of the throttle."""

    def __init__(self, sched: "Scheduler", spec: TrialSpec):
        self._sched = sched
        self._spec = spec
        self._last_step: Optional[int] = None
        self._next_rung: Optional[int] = None

    def __call__(self, step: int, value: float) -> str:
        every = max(1, self._sched.cfg.report_every)
        if self._last_step is not None:
            rung_due = (self._next_rung is not None
                        and step >= self._next_rung)
            if step - self._last_step < every and not rung_due:
                return DECISION_CONTINUE        # coalesced locally
        try:
            d = self._sched.client.report(ReportRequest(
                exp_id=self._sched.exp_id, trial_id=self._spec.trial_id,
                step=step, value=value,
                suggestion_id=self._spec.suggestion_id))
        except ApiError:
            # progress metadata is advisory: a service blip must not kill
            # the trial — skip this report and keep training
            return DECISION_CONTINUE
        self._last_step = step
        self._next_rung = d.next_rung
        return d.decision


class Scheduler:
    def __init__(self, exp_id: str, cfg: ExperimentConfig,
                 client: SuggestionClient, cluster: Optional[Cluster],
                 store: Store, trial_fn: Callable[[Dict[str, Any],
                                                   TrialContext], float]):
        self.exp_id = exp_id
        self.cfg = cfg
        self.client = client
        self.cluster = cluster
        self.store = store
        self.trial_fn = trial_fn
        self._stop = threading.Event()
        self._wake = threading.Event()          # set by future done-callbacks
        self._lock = threading.Lock()
        self._status_interval = 0.2             # min seconds between mirrors
        self._last_status_write = 0.0
        self._running: Dict[str, _Running] = {}
        self._requeue: List[TrialSpec] = []
        self._done_values: List[float] = []     # runtimes of completions
        self._reported: set = set()             # origins already observed
        self._suggest_retry_at = 0.0            # backoff after empty batch
        self._observations = 0
        self._failures = 0
        self._trial_seq = 0

    # ----------------------------------------------------------------- api
    @property
    def running_trials(self) -> int:
        return len(self._running)

    @property
    def paused_trials(self) -> int:
        """Trials parked by a service ``pause`` decision, awaiting
        promotion (their suggestions stay pending at the service)."""
        return sum(1 for s in self._requeue if s.paused_obs >= 0)

    @property
    def finished(self) -> bool:
        return self._stop.is_set() or self._observations >= self.cfg.budget

    def stop(self) -> None:
        """Terminate all executions (paper §2.5 / `delete` verb)."""
        self._stop.set()
        self._wake.set()
        for r in list(self._running.values()):
            r.stop_flag.set()

    def run(self) -> Dict[str, Any]:
        # resume lands mid-budget: the service knows how far the log got
        for attempt in range(3):
            try:
                st = self.client.status(self.exp_id)
                break
            except ApiError as e:
                if attempt == 2:
                    # surface the failure instead of dying silently in a
                    # background thread
                    self.store.update_status(self.exp_id, state="failed",
                                             error=str(e))
                    raise
                time.sleep(0.2 * (attempt + 1))
        self._observations = st.observations
        self._failures = st.failures
        self.store.update_status(self.exp_id, state="running",
                                 budget=self.cfg.budget)
        pool = ThreadPoolExecutor(max_workers=self.cfg.parallel + 2,
                                  thread_name_prefix=f"trial-{self.exp_id}")
        try:
            idle = 0
            while (self._observations < self.cfg.budget
                   and not self._stop.is_set()):
                # event-driven tick: trial completions wake the loop via
                # future done-callbacks; the timeout only paces straggler
                # checks, suggest backoff retries, and idle re-sync.
                # Harvest BEFORE filling so a completion frees its slot in
                # the same tick (fill-first would idle a slot for a full
                # wait timeout after every completion).
                self._wake.clear()
                self._harvest()
                self._fill_slots(pool)
                self._maybe_speculate(pool)
                self._prefetch_ahead()
                if not self._running and not self._requeue:
                    # other workers may hold the remaining budget, or the
                    # experiment may have been stopped service-side: re-sync
                    idle += 1
                    if idle % 2 == 0:
                        st = None
                        try:
                            st = self.client.status(self.exp_id)
                        except ApiError:
                            pass        # service blip; keep waiting
                        if st is not None:
                            self._observations = max(self._observations,
                                                     st.observations)
                            self._failures = max(self._failures, st.failures)
                            if st.state in ("stopped", "deleted"):
                                self._stop.set()
                else:
                    idle = 0
                if (self._observations >= self.cfg.budget
                        or self._stop.is_set()):
                    break       # don't sleep a tick just to re-test the loop
                self._wake.wait(0.05)
        finally:
            self.stop()
            # drain
            futures = [r.future for r in self._running.values()]
            if futures:
                wait(futures, timeout=30)
            self._harvest(final=True)
            # locally-requeued specs still hold pending budget — return it
            for spec in self._requeue:
                self._release(spec)
            self._requeue.clear()
            pool.shutdown(wait=False, cancel_futures=True)
        try:
            best = self.client.best(self.exp_id)
        except ApiError:
            best = None     # final readout is cosmetic; don't lose the run
        status = self.store.update_status(
            self.exp_id,
            state="complete" if not self._stop.is_set() or
            self._observations >= self.cfg.budget else "stopped",
            observations=self._observations, failures=self._failures,
            running=self._in_flight(),   # pool is drained: normally 0
            best=(best.to_json() if best else None))
        return status

    # ------------------------------------------------------------ internals
    def _pause_marker(self, trial_id: str):
        return (self.store.exp_dir(self.exp_id) / "ckpt" / trial_id
                / "pause.json")

    def _write_pause_marker(self, spec: TrialSpec, step, value) -> None:
        """Snapshot the paused trial's progress next to its checkpoints so
        the resumed attempt knows where to pick up (``ctx.resume_step``)."""
        p = self._pause_marker(spec.trial_id)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps({"step": step, "value": value,
                                 "pauses": spec.pauses + 1,
                                 "time": time.time()}))

    def _load_pause_marker(self, ckpt_dir) -> Optional[int]:
        try:
            return int(json.loads(
                (ckpt_dir / "pause.json").read_text())["step"])
        except (OSError, ValueError, KeyError):
            return None

    def _next_specs(self, n: int) -> List[TrialSpec]:
        specs: List[TrialSpec] = []
        deferred: List[TrialSpec] = []
        while self._requeue and len(specs) < n:
            spec = self._requeue.pop(0)
            if spec.paused_obs >= 0 and self._observations <= spec.paused_obs:
                # paused awaiting promotion: no new rung information has
                # arrived since the pause, so resuming now would only be
                # re-paused — prefer fresh work
                deferred.append(spec)
                continue
            specs.append(spec)
        if len(specs) < n and time.time() >= self._suggest_retry_at:
            try:
                batch = self.client.suggest(self.exp_id, n - len(specs))
            except ApiError:
                # transient service failure: back off, retry next tick
                self._suggest_retry_at = time.time() + 0.5
                return specs
            if not batch.suggestions:
                # budget held by pending suggestions elsewhere — back off
                self._suggest_retry_at = time.time() + 0.05
            for s in batch.suggestions:
                self._trial_seq += 1
                specs.append(TrialSpec(f"t{self._trial_seq:04d}",
                                       s.assignment,
                                       suggestion_id=s.suggestion_id))
        if not specs and deferred and not self._running:
            # nothing else to run and no trial in flight that could bring
            # new information: resume paused trials anyway rather than
            # deadlock (their next pause with unchanged observations is
            # finalized as a pruned observation — see _harvest)
            specs, deferred = deferred[:n], deferred[n:]
        self._requeue.extend(deferred)
        return specs

    def _in_flight(self) -> int:
        return len(self._running)

    def _pending_budget(self) -> int:
        return self.cfg.budget - self._observations - sum(
            1 for r in self._running.values() if not r.speculative_of)

    def _fill_slots(self, pool: ThreadPoolExecutor) -> None:
        free = self.cfg.parallel - self._in_flight()
        want = min(free, max(0, self._pending_budget()))
        if want <= 0:
            return
        for spec in self._next_specs(want):
            self._launch(pool, spec)

    def _prefetch_ahead(self) -> None:
        """Pipelined next-suggestion fetch (opt-in via ``cfg.prefetch``):
        while every slot is busy, pull ONE spec ahead of need into the
        local requeue so the next freed slot launches immediately instead
        of paying a service round trip first.  The spec's suggestion stays
        pending service-side; shutdown releases it like any requeued spec."""
        if not self.cfg.prefetch or self._stop.is_set():
            return
        if self._requeue or self._in_flight() < self.cfg.parallel:
            return
        if self._pending_budget() <= 0 \
                or time.time() < self._suggest_retry_at:
            return
        try:
            batch = self.client.suggest(self.exp_id, 1)
        except ApiError:
            self._suggest_retry_at = time.time() + 0.5
            return
        if not batch.suggestions:
            self._suggest_retry_at = time.time() + 0.05
        for s in batch.suggestions:
            self._trial_seq += 1
            self._requeue.append(TrialSpec(f"t{self._trial_seq:04d}",
                                           s.assignment,
                                           suggestion_id=s.suggestion_id))

    def _launch(self, pool: ThreadPoolExecutor, spec: TrialSpec,
                speculative_of: Optional[str] = None) -> bool:
        lease = None
        if self.cluster is not None:
            lease = self.cluster.allocate(
                self.cfg.resources.pool, self.cfg.resources.chips,
                on_revoke=lambda l, tid=spec.trial_id: self._on_revoke(tid))
            if lease is None:       # admission control: no capacity
                self._requeue.insert(0, spec)
                return False
        stop_flag = threading.Event()
        if speculative_of:
            suffix = f"-spec{spec.attempt}"
        else:
            suffix = ((f"-r{spec.attempt}" if spec.attempt else "")
                      + (f"-p{spec.pauses}" if spec.pauses else ""))
        run_id = spec.trial_id + suffix
        ckpt_dir = self.store.exp_dir(self.exp_id) / "ckpt" / spec.trial_id
        ctx = TrialContext(
            trial_id=run_id, experiment_id=self.exp_id, lease=lease,
            checkpoint_dir=str(ckpt_dir),
            _log=lambda m, rid=run_id: self.store.append_log(
                self.exp_id, rid, m),
            _report=_Reporter(self, spec),
            _should_stop=stop_flag.is_set,
            resume_step=self._load_pause_marker(ckpt_dir)
            if spec.pauses else None)
        fut = pool.submit(self._run_trial, spec, ctx)
        fut.add_done_callback(lambda _f: self._wake.set())
        self._running[run_id] = _Running(spec, fut, lease, time.time(),
                                         stop_flag, speculative_of)
        return True

    def _run_trial(self, spec: TrialSpec, ctx: TrialContext):
        clean = strip_internal(spec.assignment)
        ctx.log(f"start attempt={spec.attempt} assignment={clean}")
        value = self.trial_fn(clean, ctx)
        ctx.log(f"done value={value}")
        return value

    def _on_revoke(self, trial_id: str) -> None:
        # lease revoked (node failure): flag the trial; harvest requeues it
        for rid, r in self._running.items():
            if r.spec.trial_id == trial_id:
                r.stop_flag.set()

    def _median_runtime(self) -> Optional[float]:
        if len(self._done_values) < 3:
            return None
        s = sorted(self._done_values)
        return s[len(s) // 2]

    def _maybe_speculate(self, pool: ThreadPoolExecutor) -> None:
        if not self.cfg.straggler_factor or self._stop.is_set():
            return
        med = self._median_runtime()
        if med is None or self._in_flight() >= self.cfg.parallel:
            return
        now = time.time()
        for rid, r in list(self._running.items()):
            if r.speculative_of or r.spec.speculative:
                continue
            already = any(rr.speculative_of == r.spec.trial_id
                          for rr in self._running.values())
            if already:
                continue
            if now - r.started > self.cfg.straggler_factor * med:
                dup = TrialSpec(r.spec.trial_id, r.spec.assignment,
                                attempt=r.spec.attempt + 1, speculative=True,
                                suggestion_id=r.spec.suggestion_id)
                if self._launch(pool, dup, speculative_of=r.spec.trial_id):
                    self.store.append_log(
                        self.exp_id, rid,
                        f"straggler: speculative duplicate launched "
                        f"(elapsed {now - r.started:.1f}s > "
                        f"{self.cfg.straggler_factor:.1f} x median {med:.1f}s)")

    def _goal_value(self, value: float) -> float:
        """Observed values are goal-normalized (maximize) before they
        reach the service."""
        return value if self.cfg.goal == "max" else -value

    def _observe(self, spec: TrialSpec, origin: str,
                 value: Optional[float], failed: bool = False,
                 metadata: Optional[Dict[str, Any]] = None) -> None:
        """Report one trial outcome through the suggestion service.  The
        service deduplicates by suggestion_id (first observe wins), so a
        speculative twin racing us is counted at most once.  Transient
        service failures are retried; a lost observe must not abort the
        whole run (the service reclaims the pending entry on restart)."""
        req = ObserveRequest(
            exp_id=self.exp_id, suggestion_id=spec.suggestion_id,
            assignment=spec.assignment, value=value, failed=failed,
            trial_id=origin, metadata=metadata or {})
        resp = None
        for attempt in range(3):
            try:
                resp = self.client.observe(req)
                break
            except ApiError as e:
                if attempt == 2:
                    self.store.append_log(
                        self.exp_id, origin,
                        f"observe lost after 3 attempts: {e}")
                    # hand the budget slot back so the run can still
                    # finish (the computed value is lost, a fresh
                    # suggestion replaces it)
                    self._release(spec)
                else:
                    time.sleep(0.1 * (attempt + 1))
        self._reported.add(origin)
        if resp is None or not resp.accepted:
            return
        self._observations = max(self._observations + 1, resp.observations)
        if failed:
            self._failures += 1

    def _release(self, spec: TrialSpec) -> None:
        if not spec.suggestion_id:
            return
        try:
            self.client.release(self.exp_id, spec.suggestion_id)
        except ApiError:
            pass    # experiment already stopped/deleted service-side

    def _write_status(self, force: bool = False) -> None:
        """Mirror progress into status.json at most once per harvest pass
        and no more often than ``_status_interval`` (the run-final write is
        forced, so the mirror always converges)."""
        now = time.monotonic()
        if not force and now - self._last_status_write < self._status_interval:
            return
        self._last_status_write = now
        self.store.update_status(
            self.exp_id, observations=self._observations,
            failures=self._failures, running=self._in_flight())

    def _harvest(self, final: bool = False) -> None:
        done = [(rid, r) for rid, r in self._running.items()
                if r.future.done()]
        for rid, r in done:
            del self._running[rid]
            if r.lease is not None and self.cluster is not None:
                self.cluster.release(r.lease)
            stopped_at = None
            try:
                value = r.future.result()
                err = None
            except (TrialStopped,) as e:
                value, err = e.value, ("stopped", str(e))
                stopped_at = e.step
            except TrialPaused as e:
                value, err = e.value, ("paused", str(e))
                stopped_at = e.step
            except TrialPreempted as e:
                value, err = None, ("preempted", str(e))
            except Exception as e:  # noqa: trial crash is data, not a bug
                value, err = None, ("crashed",
                                    f"{type(e).__name__}: {e}")
                self.store.append_log(self.exp_id, rid,
                                      "TRACEBACK\n" + traceback.format_exc())

            origin = r.speculative_of or r.spec.trial_id
            if origin in self._reported:
                continue    # a speculative twin already reported

            if err is None:
                # cancel the twin, if any
                for rr in self._running.values():
                    if (rr.speculative_of == origin
                            or rr.spec.trial_id == origin):
                        rr.stop_flag.set()
                runtime = time.time() - r.started
                self._done_values.append(runtime)
                goal_v = self._goal_value(value)
                self._observe(r.spec, origin, goal_v, metadata={
                    "trial_id": origin, "runtime_s": runtime,
                    "attempt": r.spec.attempt,
                    **{k: v for k, v in r.spec.assignment.items()
                       if k.startswith("__")}})
            elif err[0] == "paused":
                progressed = (r.spec.paused_obs < 0
                              or self._observations > r.spec.paused_obs)
                if r.speculative_of:
                    pass    # origin still runs this suggestion; just drop
                elif final or self._stop.is_set():
                    self._release(r.spec)
                elif progressed:
                    # park the trial: keep its suggestion pending, snapshot
                    # its progress marker, free the slot + lease; it
                    # resumes from checkpoint once the rung population
                    # shifts (or nothing else is left to run)
                    self._write_pause_marker(r.spec, stopped_at, value)
                    self._requeue.append(TrialSpec(
                        r.spec.trial_id, r.spec.assignment,
                        attempt=r.spec.attempt,
                        suggestion_id=r.spec.suggestion_id,
                        pauses=r.spec.pauses + 1,
                        paused_obs=self._observations))
                    self.store.append_log(
                        self.exp_id, rid,
                        f"paused at step={stopped_at} (lease released; "
                        f"awaiting promotion)")
                elif value is not None:
                    # re-paused with no new observations since the last
                    # pause: no promotion is coming — finalize as a pruned
                    # partial observation so the experiment can complete
                    goal_v = self._goal_value(value)
                    self._observe(r.spec, origin, goal_v,
                                  metadata={"trial_id": origin,
                                            "pruned": True, "paused": True,
                                            "pruned_at_step": stopped_at})
                else:
                    self._release(r.spec)
            elif err[0] == "stopped" and value is not None:
                # early-stopped: record the last rung value as a pruned
                # (partial) observation — informative, not a failure
                goal_v = self._goal_value(value)
                self._observe(r.spec, origin, goal_v,
                              metadata={"trial_id": origin, "pruned": True,
                                        "pruned_at_step": stopped_at})
            elif err[0] == "stopped":
                # stopped before any report (delete/shutdown): hand the
                # unevaluated suggestion back to the budget
                self._release(r.spec)
            elif err[0] == "preempted" or (err[0] == "crashed"
                                           and r.spec.attempt
                                           < self.cfg.max_retries):
                if not final and not self._stop.is_set():
                    self._requeue.append(TrialSpec(
                        r.spec.trial_id, r.spec.assignment,
                        attempt=r.spec.attempt + 1,
                        suggestion_id=r.spec.suggestion_id))
                    self.store.append_log(self.exp_id, rid,
                                          f"requeued after {err[0]}")
                else:
                    self._release(r.spec)
            else:
                self._observe(r.spec, origin, None, failed=True,
                              metadata={"trial_id": origin,
                                        "reason": err[1]})
        if done:
            self._write_status(force=final)
