"""FleetManager: the control plane that shards experiments across N
suggestion-service processes.

Responsibilities:

* **Routing truth** — owns the consistent-hash ring and the versioned
  :class:`~repro_torch.api.protocol.ShardMap` (ring ownership + per-experiment
  overrides).  Routers cache the map and re-fetch on a version bump.
* **Admission control** — ``create_experiment`` consults the target
  shard's last load probe (FitExecutor ``backlog`` + ``duty`` cycle): a
  saturated shard's new experiment is redirected to the
  least-loaded eligible shard (recorded as a map override), and when the
  whole fleet is saturated the create comes back as a typed
  ``fleet_busy`` (HTTP 503) the caller can back off on.
* **Ownership epochs (fencing)** — every create/adoption/handover the
  manager initiates carries a granted ``[term, seq]`` epoch; the adopting
  shard claims the experiment's fence record at that epoch, so every
  older incarnation (a zombie across a healed partition, a loser of a
  dual-manager split) is actively rejected at its next durable write
  with ``E_FENCED`` instead of silently splitting the log.
* **Liveness event loop** — one thread probes shards (pull: healthz +
  load, each probe bounded by a per-probe deadline) and sweeps the
  worker registry (push: scheduler heartbeats carrying their
  pending-suggestion holdings).  A scheduler declared dead gets its
  leases revoked (``on_dead`` hook) and every pending suggestion it held
  *requeued* on the owning shard — same id, same constant-liar lie — so
  a survivor's next ``suggest`` serves it exactly once.  A shard
  declared dead leaves the ring (version bump); its experiments re-home
  to the ring successor, which adopts them out of the shared
  system-of-record store at a freshly granted epoch.
* **Rebalance on add** — a shard joining the ring receives exactly the
  experiments whose ring ownership moved (minimal key disruption):
  each is *drained* on its current owner (pump stopped, pendings
  parked), adopted by the new owner at a bumped epoch (fencing the old
  one), and its parked pendings transferred under their original ids.
  A crash-safe handover journal (``fleet/rebalance.json``) lets a
  manager death mid-rebalance resume — or roll back — cleanly.
* **Warm standby** — a second manager constructed with ``standby=True``
  watches the epoch-guarded leader lease in the shared store; on a
  stale lease it rebuilds registry + ring + overrides from the control
  snapshot and heartbeat event tail, bumps the leadership *term* (so
  all its epoch grants out-rank the old manager's), resumes any
  in-flight rebalance journal, and starts acting.  Fencing makes
  split-brain harmless: the deposed manager's grants lose every claim.

The manager holds no optimizer state; besides routing metadata it writes
only the ``fleet/`` control files (leader lease, rebuildable snapshot,
event tail, rebalance journal) — shards stay the single writers of their
experiments' logs.
"""
from __future__ import annotations

import json
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from repro_torch.api.http import HTTPClient
from repro_torch.api.protocol import (ApiError, CreateExperiment,
                                      CreateResponse, E_FENCED, E_FLEET_BUSY,
                                      E_UNKNOWN_EXPERIMENT, HeartbeatRequest,
                                      HeartbeatResponse, ShardMap)
from repro_torch.core.store import Store
from repro_torch.fleet.hashring import HashRing
from repro_torch.fleet.heartbeat import S_ALIVE, S_DEAD, WorkerRegistry


class ShardHandle:
    """One shard as the manager sees it: an id, a client (HTTP for real
    processes, or any ``SuggestionClient`` with ``load``/``requeue`` for
    in-process shards), and the last probe result."""

    def __init__(self, shard_id: str, client, url: str = ""):
        self.shard_id = shard_id
        self.client = client
        self.url = url
        self.load: Dict[str, Any] = {}      # last successful probe
        self.probe_failures = 0
        self.probe_timeouts = 0
        # chaos harness: manager↔shard edge gate (raises InjectedPartition)
        self.fault_gate: Optional[Callable[[], None]] = None

    def gate(self) -> None:
        if self.fault_gate is not None:
            self.fault_gate()

    def probe(self) -> bool:
        """One liveness+load probe; True on success."""
        try:
            self.gate()
            load = self.client.load() or {}
        except Exception:
            self.probe_failures += 1
            return False
        self.load = load
        self.probe_failures = 0
        return True

    def note_timeout(self) -> None:
        """The event loop's per-probe deadline expired with this probe
        still in flight: count it as a failed probe (no beat this tick)
        so a wedged shard — accepting connections but never answering —
        still progresses toward ``dead`` instead of stalling the tick."""
        self.probe_failures += 1
        self.probe_timeouts += 1

    def to_json(self) -> Dict[str, Any]:
        return {"shard_id": self.shard_id, "url": self.url,
                "load": self.load, "probe_failures": self.probe_failures,
                "probe_timeouts": self.probe_timeouts}


class FleetManager:
    """See module docstring.  Thread-safe; ``start()`` spawns the event
    loop, ``stop()`` joins it."""

    #: admission thresholds: a shard is saturated when its fit-executor
    #: backlog or recent duty cycle crosses these
    ADMIT_BACKLOG = 4
    ADMIT_DUTY = 0.75

    def __init__(self, period: float = 1.0,
                 suspect_after: Optional[float] = None,
                 dead_after: Optional[float] = None,
                 admit_backlog: Optional[int] = None,
                 admit_duty: Optional[float] = None,
                 replicas: int = 64,
                 store: Optional[Union[Store, str]] = None,
                 manager_id: Optional[str] = None,
                 standby: bool = False,
                 probe_timeout: Optional[float] = None,
                 lease_timeout: Optional[float] = None,
                 shard_resolver: Optional[Callable] = None,
                 fault_plan=None):
        self.registry = WorkerRegistry(period=period,
                                       suspect_after=suspect_after,
                                       dead_after=dead_after)
        self.ring = HashRing(replicas=replicas)
        self.admit_backlog = (self.ADMIT_BACKLOG if admit_backlog is None
                              else int(admit_backlog))
        self.admit_duty = (self.ADMIT_DUTY if admit_duty is None
                           else float(admit_duty))
        self.store = (store if (store is None or isinstance(store, Store))
                      else Store(store))
        self.manager_id = manager_id or f"mgr-{uuid.uuid4().hex[:6]}"
        # per-probe deadline: the tick budgets this
        # much wall clock for the WHOLE parallel probe round; a probe
        # still in flight past it is counted failed for this tick
        self.probe_timeout = (max(0.2, period) if probe_timeout is None
                              else float(probe_timeout))
        self.lease_timeout = (3.0 * period if lease_timeout is None
                              else float(lease_timeout))
        # standby: rebuilds in-proc shard clients on takeover;
        # (shard_id, url) -> client, defaults to HTTPClient(url)
        self._shard_resolver = shard_resolver
        self.fault_plan = fault_plan
        self._lock = threading.RLock()
        self._shards: Dict[str, ShardHandle] = {}
        self._overrides: Dict[str, str] = {}     # exp_id -> shard_id
        self._experiments: Dict[str, str] = {}   # exp_id -> shard_id (last)
        self._version = 0
        self._epoch_seq = 0                      # monotone grant counter
        self._logged_holdings: Dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.events: List[Dict[str, Any]] = []   # bounded audit trail
        self.stats = {"ticks": 0, "requeued": 0, "dead_workers": 0,
                      "dead_shards": 0, "redirects": 0, "busy_rejections": 0,
                      "adopted": 0, "rebalanced": 0, "probe_timeouts": 0}
        self.term = 0
        self.role = "standby" if standby else "active"
        if not standby:
            self._become_leader()
            self._resume_rebalance()

    # ----------------------------------------------------------- leadership
    def _become_leader(self) -> None:
        """Claim (or re-claim) leadership: term = stored term + 1, so
        every epoch this manager grants out-ranks every grant of every
        previous leader — the fencing layer does the rest."""
        prev = 0
        if self.store is not None:
            rec = self.store.read_fleet_state("leader") or {}
            prev = int(rec.get("term", 0))
        self.term = max(self.term, prev) + 1
        self.role = "active"
        self._renew_lease()

    def _renew_lease(self) -> bool:
        """Refresh the epoch-guarded leader file; detect deposition.  A
        newer term in the file means another manager took over — stand
        down (our grants lose every fence claim anyway)."""
        if self.store is None:
            return True
        rec = self.store.read_fleet_state("leader") or {}
        if int(rec.get("term", 0)) > self.term:
            self.role = "deposed"
            self._event("deposed", term=self.term,
                        by_term=int(rec.get("term", 0)),
                        by=rec.get("manager_id", ""))
            return False
        self.store.write_fleet_state("leader", {
            "manager_id": self.manager_id, "term": self.term,
            "time": time.time(), "period": self.registry.period})
        return True

    def _grant_epoch(self) -> List[int]:
        with self._lock:
            self._epoch_seq += 1
            return [self.term, self._epoch_seq]

    def _persist(self) -> None:
        """Write the rebuildable control snapshot (standby's cold-start
        state).  Called on every membership / override / ownership
        change — the manager is off the suggest/observe hot path, so
        this is one small atomic file write per rare control event."""
        if self.store is None or self.role != "active":
            return
        with self._lock:
            snap = {"manager_id": self.manager_id, "term": self.term,
                    "version": self._version, "epoch_seq": self._epoch_seq,
                    "period": self.registry.period,
                    "shards": {sid: h.url
                               for sid, h in self._shards.items()},
                    "overrides": dict(self._overrides),
                    "experiments": dict(self._experiments),
                    "time": time.time()}
        self.store.write_fleet_state("manager", snap)

    # ------------------------------------------------------------- standby
    def poll_standby(self) -> bool:
        """One standby round: watch the active's lease, take over when it
        goes stale (or vanishes).  Public so tests drive failover
        deterministically.  Returns True when a takeover happened."""
        if self.store is None or self.role != "standby":
            return False
        rec = self.store.read_fleet_state("leader")
        if rec is not None:
            self.term = max(self.term, int(rec.get("term", 0)))
            age = time.time() - float(rec.get("time", 0.0))
            if age <= self.lease_timeout:
                return False
        self.takeover()
        return True

    def takeover(self) -> None:
        """Standby → active: rebuild registry + ring + overrides from the
        control snapshot and the heartbeat event tail, bump the
        leadership term (stale grants now lose every claim), resume or
        roll back an in-flight rebalance journal, and start acting."""
        snap = (self.store.read_fleet_state("manager") or {}
                if self.store is not None else {})
        with self._lock:
            self._version = max(self._version, int(snap.get("version", 0)))
            self._epoch_seq = max(self._epoch_seq,
                                  int(snap.get("epoch_seq", 0)))
            for exp, sid in (snap.get("overrides") or {}).items():
                self._overrides.setdefault(exp, sid)
            for exp, sid in (snap.get("experiments") or {}).items():
                self._experiments.setdefault(exp, sid)
        if float(snap.get("period", 0)) > 0:
            self.registry.period = float(snap["period"])
        for sid, url in (snap.get("shards") or {}).items():
            with self._lock:
                known = sid in self._shards
            if known:
                continue
            client = None
            if self._shard_resolver is not None:
                client = self._shard_resolver(sid, url)
            elif url:
                client = HTTPClient(url, timeout=5.0)
            if client is None:
                continue
            self._install_shard(ShardHandle(sid, client, url))
        # replay worker holdings from the event tail so a death right
        # after takeover still requeues the right suggestions
        if self.store is not None:
            for ev in self.store.load_fleet_events():
                if ev.get("event") == "beat":
                    self.registry.beat(ev.get("worker_id", ""),
                                       kind=ev.get("kind", "scheduler"),
                                       holdings=ev.get("holdings") or {})
        self._become_leader()
        with self._lock:
            self._version += 1      # force routers to re-fetch from us
        self._event("takeover", manager_id=self.manager_id, term=self.term)
        self._resume_rebalance()
        self._persist()

    # ----------------------------------------------------------- membership
    def _install_shard(self, handle: ShardHandle) -> None:
        if self.fault_plan is not None:
            handle.fault_gate = self.fault_plan.edge_gate(
                "manager", handle.shard_id)
        with self._lock:
            self._shards[handle.shard_id] = handle
            self.ring.add(handle.shard_id)
            self._version += 1
        self.registry.register(handle.shard_id, kind="shard",
                               url=handle.url)

    def add_shard(self, url_or_client, shard_id: Optional[str] = None,
                  rebalance: bool = True) -> ShardHandle:
        """Attach one shard (a ``serve-api`` URL, or an in-process
        client).  Bumps the map version and — unless ``rebalance=False``
        — hands over exactly the experiments whose ring ownership moved
        to the new shard (minimal disruption set), via the crash-safe
        drain → adopt(epoch bump) → transfer journal."""
        if isinstance(url_or_client, str):
            url = url_or_client.rstrip("/")
            client = HTTPClient(url, timeout=5.0)
            shard_id = shard_id or url
        else:
            client = url_or_client
            url = getattr(client, "base_url", "")
            shard_id = shard_id or f"shard-{len(self._shards)}"
        handle = ShardHandle(shard_id, client, url)
        moved: List[str] = []
        with self._lock:
            if rebalance:
                moved = self.ring.moved_by_adding(
                    shard_id, [e for e in self._experiments
                               if e not in self._overrides])
        self._install_shard(handle)
        self._persist()
        if moved:
            self._rebalance(moved, shard_id)
        return handle

    def remove_shard(self, shard_id: str) -> None:
        """Administrative removal (drain); dead shards go through
        ``_on_dead_shard`` instead."""
        with self._lock:
            self._shards.pop(shard_id, None)
            self.ring.remove(shard_id)
            self._purge_overrides(shard_id)
            self._version += 1
        self._persist()

    def _purge_overrides(self, shard_id: str) -> None:
        # holding self._lock
        for exp, sid in list(self._overrides.items()):
            if sid == shard_id:
                del self._overrides[exp]

    # ------------------------------------------------------------ rebalance
    def _rebalance(self, moved: List[str], new_sid: str) -> None:
        """Build + journal + run the handover plan for ``moved``."""
        with self._lock:
            entries = [{"exp_id": e,
                        "from": self._experiments.get(e, ""),
                        "epoch": self._grant_epoch(), "done": False}
                       for e in sorted(moved)]
        journal = {"id": uuid.uuid4().hex[:8], "to": new_sid,
                   "term": self.term, "time": time.time(),
                   "entries": entries}
        if self.store is not None:
            self.store.write_fleet_state("rebalance", journal)
        self._event("rebalance_begin", to=new_sid, moved=len(entries))
        self._run_journal(journal)

    def _resume_rebalance(self) -> None:
        """Crash recovery: a journal on disk means a manager died (or was
        deposed) mid-rebalance.  Re-grant the undone entries at OUR term
        — the dead manager's grants may already be contested — and run
        the journal to completion; a vanished target shard rolls the
        whole thing back instead."""
        if self.store is None:
            return
        journal = self.store.read_fleet_state("rebalance")
        if not journal:
            return
        remaining = [e for e in journal.get("entries", [])
                     if not e.get("done")]
        for entry in remaining:
            entry["epoch"] = self._grant_epoch()
        self.store.write_fleet_state("rebalance", journal)
        self._event("rebalance_resume", to=journal.get("to", ""),
                    remaining=len(remaining))
        self._run_journal(journal)

    def _run_journal(self, journal: Dict[str, Any]) -> None:
        new_sid = journal.get("to", "")
        with self._lock:
            target = self._shards.get(new_sid)
        if target is None:
            # target left (or never re-joined after the crash): roll back
            # — the ring no longer routes to it, experiments stay where
            # they are, nothing was half-moved (entries are atomic)
            if self.store is not None:
                self.store.clear_fleet_state("rebalance")
            self._event("rebalance_rollback", to=new_sid)
            return
        for entry in journal.get("entries", []):
            if entry.get("done"):
                continue
            if self._handover(entry, target):
                entry["done"] = True
                with self._lock:
                    self.stats["rebalanced"] += 1
                if self.store is not None:
                    # journal the per-entry progress so a crash between
                    # entries resumes exactly where it stopped
                    self.store.write_fleet_state("rebalance", journal)
        if all(e.get("done") for e in journal.get("entries", [])):
            if self.store is not None:
                self.store.clear_fleet_state("rebalance")
            self._persist()
            self._event("rebalance_done", to=new_sid,
                        moved=len(journal.get("entries", [])))

    def _handover(self, entry: Dict[str, Any], target: ShardHandle) -> bool:
        """Move one experiment: drain on the old owner (park pendings),
        adopt on the new owner at the granted epoch (fences the old
        incarnation), transfer the parked pendings under their original
        ids.  Returns True when the entry is settled (including the
        benign nothing-to-do outcomes)."""
        exp_id, old_sid = entry["exp_id"], entry.get("from", "")
        with self._lock:
            old = self._shards.get(old_sid)
        pending = []
        if old is not None and old_sid != target.shard_id:
            try:
                old.gate()
                dr = old.client.drain(exp_id)
                pending = dr.pending
            except Exception as e:
                # old owner unreachable: adopt anyway — its incarnation
                # is fenced the moment the claim lands, and its pendings
                # requeue via the worker-death path if their holders die
                self._event("drain_failed", exp_id=exp_id,
                            from_shard=old_sid, error=str(e))
        try:
            target.gate()
            target.client.create_experiment(CreateExperiment(
                config={}, exp_id=exp_id, epoch=entry["epoch"]))
        except ApiError as e:
            if e.code == E_UNKNOWN_EXPERIMENT:
                # store not shared / experiment never persisted: routers
                # holding the config re-home it on their next call
                self._event("handover_skipped", exp_id=exp_id,
                            error=str(e))
                return True
            if e.code == E_FENCED:
                # someone out-granted us mid-handover (we were deposed):
                # the experiment already has a newer owner — settled
                self._event("handover_fenced", exp_id=exp_id)
                return True
            self._event("adopt_failed", exp_id=exp_id, error=str(e))
            return False
        except Exception as e:
            self._event("adopt_failed", exp_id=exp_id, error=str(e))
            return False
        transferred = 0
        for s in pending:
            try:
                if target.client.requeue(exp_id, s.suggestion_id,
                                         assignment=s.assignment):
                    transferred += 1
            except Exception:
                pass    # already observed / experiment stopped
        with self._lock:
            self._experiments[exp_id] = target.shard_id
        self._event("handover", exp_id=exp_id, from_shard=old_sid,
                    to_shard=target.shard_id, epoch=entry["epoch"],
                    transferred=transferred)
        return True

    # -------------------------------------------------------------- routing
    def shard_map(self) -> ShardMap:
        with self._lock:
            return ShardMap(version=self._version,
                            shards={s.shard_id: s.url
                                    for s in self._shards.values()},
                            overrides=dict(self._overrides))

    def owner_of(self, exp_id: str) -> Optional[ShardHandle]:
        with self._lock:
            sid = self._overrides.get(exp_id) or self.ring.owner(exp_id)
            return self._shards.get(sid) if sid else None

    def _eligible(self) -> List[ShardHandle]:
        """Alive shards, least-loaded first (backlog, duty, live count)."""
        out = []
        with self._lock:
            shards = list(self._shards.values())
        for s in shards:
            if self.registry.state(s.shard_id) in (S_ALIVE, None) \
                    or self.registry.state(s.shard_id) == "registered":
                out.append(s)
        out.sort(key=lambda s: (int(s.load.get("backlog", 0)),
                                float(s.load.get("duty", 0.0)),
                                int(s.load.get("live", 0))))
        return out

    def _saturated(self, shard: ShardHandle) -> bool:
        return (int(shard.load.get("backlog", 0)) >= self.admit_backlog
                or float(shard.load.get("duty", 0.0)) >= self.admit_duty)

    # ------------------------------------------------------------ admission
    def create_experiment(self, req: CreateExperiment
                          ) -> Tuple[CreateResponse, str, str, int]:
        """Admission-controlled create: route to the hash owner unless it
        is saturated, else redirect to the least-loaded eligible shard
        (recorded as a map override); raise ``fleet_busy`` when every
        shard is saturated.  The create is forwarded with a granted
        ownership epoch — the serving shard claims the experiment's
        fence record at it.  Returns (response, shard_id, url, version)."""
        exp_id = req.exp_id
        if exp_id is None:
            from repro_torch.core.experiment import new_experiment_id
            exp_id = new_experiment_id()
        req = CreateExperiment(config=req.config, exp_id=exp_id,
                               epoch=self._grant_epoch())
        target = self.owner_of(exp_id)
        if target is None:
            raise ApiError(E_FLEET_BUSY, "fleet has no shards")
        if self._saturated(target):
            eligible = [s for s in self._eligible()
                        if not self._saturated(s)]
            if not eligible:
                with self._lock:
                    self.stats["busy_rejections"] += 1
                raise ApiError(
                    E_FLEET_BUSY,
                    f"all {len(self._shards)} shards saturated "
                    f"(backlog>={self.admit_backlog} or "
                    f"duty>={self.admit_duty}); retry later")
            redirect = eligible[0]
            with self._lock:
                if redirect.shard_id != self.ring.owner(exp_id):
                    self._overrides[exp_id] = redirect.shard_id
                else:
                    self._overrides.pop(exp_id, None)
                self._version += 1
                self.stats["redirects"] += 1
            self._event("admission_redirect", exp_id=exp_id,
                        from_shard=target.shard_id,
                        to_shard=redirect.shard_id)
            target = redirect
        resp = target.client.create_experiment(req)
        with self._lock:
            self._experiments[resp.exp_id] = target.shard_id
            version = self._version
        self._persist()
        return resp, target.shard_id, target.url, version

    # ------------------------------------------------------------ liveness
    def heartbeat(self, req: HeartbeatRequest,
                  on_dead: Optional[Callable] = None) -> HeartbeatResponse:
        state = self.registry.beat(req.worker_id, kind=req.kind,
                                   holdings=req.holdings)
        if on_dead is not None:
            rec = self.registry.get(req.worker_id)
            if rec is not None:
                rec.on_dead = on_dead
        with self._lock:
            version = self._version
        # persist holdings *changes* to the event tail: that's exactly
        # what a standby needs to requeue correctly after takeover
        if self.store is not None and self.role == "active":
            key = json.dumps(req.holdings, sort_keys=True)
            with self._lock:
                changed = self._logged_holdings.get(req.worker_id) != key
                if changed:
                    self._logged_holdings[req.worker_id] = key
            if changed:
                self.store.append_fleet_event(
                    {"event": "beat", "worker_id": req.worker_id,
                     "kind": req.kind, "holdings": req.holdings,
                     "time": time.time()})
        return HeartbeatResponse(state=state, map_version=version,
                                 period=self.registry.period)

    def start(self) -> "FleetManager":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run,
                                            name="fleet-manager",
                                            daemon=True)
            self._thread.start()
        return self

    def stop(self, join: bool = True) -> None:
        self._stop.set()
        if join and self._thread is not None \
                and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive() \
            and not self._stop.is_set()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                if self.role == "standby":
                    self.poll_standby()
                elif self.role == "active":
                    self.tick()
                else:           # deposed: nothing left to do
                    return
            except Exception as e:  # noqa: the loop must survive any tick
                self._event("tick_error", error=f"{type(e).__name__}: {e}")
            self._stop.wait(self.registry.period)

    def tick(self) -> None:
        """One event-loop round: renew the leader lease, probe shards in
        parallel (per-probe deadline), sweep the registry, and act on
        every freshly-dead worker.  Public so tests (and a paused
        manager) can drive the loop deterministically."""
        if self.fault_plan is not None:
            self.fault_plan.tick()      # the chaos harness's logical clock
        if self.role != "active" or not self._renew_lease():
            return
        with self._lock:
            shards = list(self._shards.values())
            self.stats["ticks"] += 1
        deadline = time.monotonic() + self.probe_timeout
        threads = [threading.Thread(target=self._probe_one, args=(s,),
                                    daemon=True) for s in shards]
        for t in threads:
            t.start()
        for s, t in zip(shards, threads):
            # ONE shared deadline for the round: a single wedged shard
            # consumes its own budget, not one timeout per shard — the
            # old sequential join let N hung probes stall the tick N
            # periods, delaying dead-worker detection fleet-wide
            t.join(timeout=max(0.0, deadline - time.monotonic()))
            if t.is_alive():
                s.note_timeout()
                with self._lock:
                    self.stats["probe_timeouts"] += 1
        for rec in self.registry.sweep():
            if rec.kind == "shard":
                handle = self._shards.get(rec.worker_id)
                if handle is not None and handle.probe_failures == 0:
                    # silent past the deadline but no probe ever *failed*:
                    # the shard is slow (startup, GC, load), not gone —
                    # only refused/broken/timed-out probes count as death
                    self.registry.beat(rec.worker_id, kind="shard",
                                       url=rec.url)
                    continue
                self._on_dead_shard(rec.worker_id)
            else:
                self._on_dead_worker(rec)

    def _probe_one(self, shard: ShardHandle) -> None:
        if shard.probe():
            self.registry.beat(shard.shard_id, kind="shard", url=shard.url)

    # --------------------------------------------------------- fault paths
    def _on_dead_worker(self, rec) -> None:
        """A scheduler stopped heartbeating: revoke its leases (hook) and
        requeue every pending suggestion it held so survivors can claim
        them.  Requeue (not release) keeps id + lie — the observation,
        whoever finally produces it, dedupes service-side."""
        with self._lock:
            self.stats["dead_workers"] += 1
        if rec.on_dead is not None:
            try:
                rec.on_dead(rec)
            except Exception:
                pass
        requeued = 0
        for exp_id, sids in rec.holdings.items():
            shard = self.owner_of(exp_id)
            if shard is None:
                continue
            for sid in sids:
                try:
                    shard.gate()
                    if shard.client.requeue(exp_id, sid):
                        requeued += 1
                except (ApiError, ConnectionError):
                    pass        # experiment gone / shard mid-failover
        with self._lock:
            self.stats["requeued"] += requeued
        self._event("worker_dead", worker_id=rec.worker_id,
                    requeued=requeued)

    def _on_dead_shard(self, shard_id: str) -> None:
        """A shard stopped answering probes: drop it from the ring (map
        version bump) and re-home its experiments to their new ring
        owners — each adopted out of the shared system-of-record store
        at a freshly granted epoch, so if the 'dead' shard was merely
        partitioned it comes back to find every write fenced.  The dead
        shard's in-memory pending set is gone; the resume replay
        reclaims that budget (the restore semantics)."""
        with self._lock:
            self.stats["dead_shards"] += 1
            dead = self._shards.pop(shard_id, None)
            self.ring.remove(shard_id)
            self._purge_overrides(shard_id)
            self._version += 1
            orphans = [e for e, s in self._experiments.items()
                       if s == shard_id]
        adopted = 0
        for exp_id in orphans:
            new_owner = self.owner_of(exp_id)
            if new_owner is None:
                continue
            try:
                new_owner.gate()
                new_owner.client.create_experiment(
                    CreateExperiment(config={}, exp_id=exp_id,
                                     epoch=self._grant_epoch()))
                adopted += 1
                with self._lock:
                    self._experiments[exp_id] = new_owner.shard_id
            except ApiError as e:
                # store not shared with this shard (or experiment never
                # persisted): routers with the config cached will re-home
                # it on their next create
                if e.code != E_UNKNOWN_EXPERIMENT:
                    self._event("adopt_failed", exp_id=exp_id,
                                error=str(e))
            except Exception as e:
                self._event("adopt_failed", exp_id=exp_id, error=str(e))
        with self._lock:
            self.stats["adopted"] += adopted
        self._persist()
        self._event("shard_dead", shard_id=shard_id,
                    url=dead.url if dead else "", orphans=len(orphans),
                    adopted=adopted)

    # --------------------------------------------------------------- misc
    def _event(self, kind: str, **fields) -> None:
        with self._lock:
            self.events.append(dict(fields, event=kind))
            if len(self.events) > 256:
                del self.events[:128]
        # lifecycle events land in the durable audit tail too (standby
        # forensics); tick errors stay in-memory — they can repeat every
        # period and the tail is append-only
        if (self.store is not None and kind != "tick_error"
                and self.role == "active"):
            try:
                self.store.append_fleet_event(
                    dict(fields, event=kind, manager_id=self.manager_id,
                         time=time.time()))
            except OSError:
                pass

    def status(self) -> Dict[str, Any]:
        with self._lock:
            shards = {s.shard_id: s.to_json()
                      for s in self._shards.values()}
            version = self._version
            stats = dict(self.stats)
            experiments = len(self._experiments)
        return {"version": version, "shards": shards,
                "workers": self.registry.to_json(),
                "experiments": experiments, "stats": stats,
                "period": self.registry.period,
                "manager_id": self.manager_id, "role": self.role,
                "term": self.term}
