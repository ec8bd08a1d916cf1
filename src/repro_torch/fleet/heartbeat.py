"""Worker liveness: the registered → alive → suspect → dead state machine.

Every worker (scheduler process or service shard) is a ``WorkerRecord``
with a *monotonic-clock* deadline: wall-clock jumps (NTP steps, VM
suspend) must never mass-declare a fleet dead.  The registry is pure
bookkeeping — the FleetManager's event loop calls ``sweep()`` and acts on
the transitions it returns (dead workers get their pending suggestions
requeued; dead shards leave the hash ring).

States:
  registered  seen a registration but no heartbeat yet (grace = dead_after
              from registration, so a worker that registers and
              immediately wedges is still collected)
  alive       beat within ``suspect_after``
  suspect     missed beats past ``suspect_after`` — still routable, but
              the manager may start double-checking (probe) it
  dead        past ``dead_after``: leases revoked, holdings requeued,
              record retired after ``retire_after``
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

S_REGISTERED = "registered"
S_ALIVE = "alive"
S_SUSPECT = "suspect"
S_DEAD = "dead"


class WorkerRecord:
    __slots__ = ("worker_id", "kind", "url", "state", "last_beat",
                 "registered_at", "beats", "holdings", "on_dead", "meta")

    def __init__(self, worker_id: str, kind: str = "scheduler",
                 url: str = "", now: Optional[float] = None,
                 on_dead: Optional[Callable[["WorkerRecord"], None]] = None):
        now = time.monotonic() if now is None else now
        self.worker_id = worker_id
        self.kind = kind                    # scheduler | shard
        self.url = url
        self.state = S_REGISTERED
        self.last_beat = now                # registration counts as contact
        self.registered_at = now
        self.beats = 0
        # exp_id -> [suggestion_id, ...] — what to requeue on death
        self.holdings: Dict[str, List[str]] = {}
        self.on_dead = on_dead              # in-process revocation hook
        self.meta: Dict[str, Any] = {}

    def to_json(self) -> Dict[str, Any]:
        return {"worker_id": self.worker_id, "kind": self.kind,
                "url": self.url, "state": self.state, "beats": self.beats,
                "age_s": round(time.monotonic() - self.registered_at, 3),
                "silent_s": round(time.monotonic() - self.last_beat, 3),
                "holdings": {k: len(v) for k, v in self.holdings.items()}}


class WorkerRegistry:
    """Thread-safe liveness table.  ``period`` is the prescribed beat
    interval; the deadlines default to 2 periods (suspect) and 4 periods
    (dead) unless given explicitly — "requeued within 2 heartbeat
    periods" in the acceptance criteria is measured against
    ``dead_after``."""

    def __init__(self, period: float = 1.0,
                 suspect_after: Optional[float] = None,
                 dead_after: Optional[float] = None,
                 retire_after: float = 60.0):
        self.period = float(period)
        self.suspect_after = (self.period * 1.0 if suspect_after is None
                              else float(suspect_after))
        self.dead_after = (self.period * 2.0 if dead_after is None
                           else float(dead_after))
        if self.dead_after < self.suspect_after:
            self.dead_after = self.suspect_after
        self.retire_after = float(retire_after)
        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerRecord] = {}

    # -------------------------------------------------------------- intake
    def register(self, worker_id: str, kind: str = "scheduler",
                 url: str = "", now: Optional[float] = None,
                 on_dead=None) -> WorkerRecord:
        with self._lock:
            rec = self._workers.get(worker_id)
            if rec is None or rec.state == S_DEAD:
                # a dead worker re-registering is a NEW incarnation: old
                # holdings were already requeued, start clean
                rec = WorkerRecord(worker_id, kind, url, now=now,
                                   on_dead=on_dead)
                self._workers[worker_id] = rec
            return rec

    def beat(self, worker_id: str, kind: str = "scheduler",
             holdings: Optional[Dict[str, List[str]]] = None,
             now: Optional[float] = None, url: str = "") -> str:
        """Record one heartbeat; auto-registers unknown workers (a
        manager restart must not orphan a running fleet).  Returns the
        worker's state AFTER the beat."""
        now = time.monotonic() if now is None else now
        with self._lock:
            rec = self._workers.get(worker_id)
            if rec is None or rec.state == S_DEAD:
                rec = WorkerRecord(worker_id, kind, url, now=now)
                self._workers[worker_id] = rec
            rec.last_beat = now
            rec.beats += 1
            if url:
                rec.url = url
            if rec.state in (S_REGISTERED, S_SUSPECT, S_ALIVE):
                rec.state = S_ALIVE
            if holdings is not None:
                rec.holdings = {k: list(v) for k, v in holdings.items()}
            return rec.state

    # --------------------------------------------------------------- sweep
    def sweep(self, now: Optional[float] = None) -> List[WorkerRecord]:
        """Advance every record's state against its monotonic deadline;
        returns the records that JUST transitioned to dead (each exactly
        once — the caller requeues their holdings).  Long-dead records
        are retired after ``retire_after``."""
        now = time.monotonic() if now is None else now
        newly_dead: List[WorkerRecord] = []
        with self._lock:
            for wid in list(self._workers):
                rec = self._workers[wid]
                silent = now - rec.last_beat
                if rec.state == S_DEAD:
                    if silent > self.dead_after + self.retire_after:
                        del self._workers[wid]
                    continue
                if silent >= self.dead_after:
                    rec.state = S_DEAD
                    newly_dead.append(rec)
                elif silent >= self.suspect_after \
                        and rec.state in (S_ALIVE, S_REGISTERED):
                    rec.state = S_SUSPECT
        return newly_dead

    # ------------------------------------------------------------- queries
    def get(self, worker_id: str) -> Optional[WorkerRecord]:
        with self._lock:
            return self._workers.get(worker_id)

    def state(self, worker_id: str) -> Optional[str]:
        rec = self.get(worker_id)
        return rec.state if rec else None

    def workers(self, kind: Optional[str] = None) -> List[WorkerRecord]:
        with self._lock:
            return [r for r in self._workers.values()
                    if kind is None or r.kind == kind]

    def to_json(self) -> Dict[str, Any]:
        with self._lock:
            return {wid: r.to_json() for wid, r in self._workers.items()}
