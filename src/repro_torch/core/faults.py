"""Fault injection + recovery plumbing.

The scheduler already implements the recovery policies (retry, requeue on
preemption, speculative re-execution); this module provides deterministic
fault *injection* so those paths are testable without real node failures —
the same role chaos testing plays for the paper's Kubernetes deployment.

Two layers:

* trial-level (:func:`wrap_trial`, :class:`FaultPolicy`) — crash / NaN /
  straggler injection keyed by assignment hash;
* fleet-level (:class:`FaultPlan`) — a deterministic, tick-indexed
  schedule of *edge* faults (partition / drop / delay between named
  endpoints: ``worker-3 ↔ shard-1``, ``manager ↔ shard-0``), threaded
  through ``HTTPClient`` (``fault_gate=``), ``FleetClient``
  (``fault_plan=``) and the manager probe loop.  Injected partitions
  raise :class:`InjectedPartition` — a ``ConnectionRefusedError``
  subclass — so they traverse the *real* transport error-handling and
  retry paths, replacing wall-clock kill −9 races with reproducible
  partition schedules.
"""
from __future__ import annotations

import fnmatch
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cluster import Cluster


class InjectedCrash(RuntimeError):
    pass


class InjectedPartition(ConnectionRefusedError):
    """A fault-plan edge fault.  Subclasses ``ConnectionRefusedError`` so
    transport code treats an injected partition exactly like a refused
    connect (the message provably never reached the far side — safe to
    retry any verb)."""


class FaultPlan:
    """Deterministic, tick-indexed schedule of fleet edge faults.

    A rule is ``{op, src, dst, at, until, delay_s, p}``:

      op       ``partition`` (raise on every message), ``drop`` (raise
               with probability ``p``, seeded) or ``delay`` (sleep
               ``delay_s`` then pass).
      src/dst  endpoint labels; ``fnmatch`` patterns (``"*"``, ``"w*"``)
               are allowed and the rule matches either direction of the
               edge.
      at       first tick (inclusive) the rule is active.
      until    last tick (exclusive); ``None`` = until healed/forever.

    Ticks are a *logical* clock: the active FleetManager advances the
    plan once per probe tick (and tests drive :meth:`tick` directly), so
    a schedule replays identically regardless of wall-clock timing.
    Helpers (:meth:`partition`, :meth:`heal`) edit the schedule live —
    handy for test scripts that interleave faults with assertions.
    """

    def __init__(self, rules: Optional[List[Dict[str, Any]]] = None,
                 seed: int = 0):
        self._lock = threading.Lock()
        self.rules: List[Dict[str, Any]] = [dict(r) for r in (rules or [])]
        self.rng = np.random.default_rng(seed)
        self._tick = 0
        # observability: (src, dst) -> count of messages faulted
        self.dropped: Dict[Tuple[str, str], int] = {}
        self.delayed: Dict[Tuple[str, str], int] = {}

    # ------------------------------------------------------------- schedule
    def add(self, op: str, src: str, dst: str, at: int = 0,
            until: Optional[int] = None, delay_s: float = 0.0,
            p: float = 1.0) -> "FaultPlan":
        with self._lock:
            self.rules.append({"op": op, "src": src, "dst": dst, "at": at,
                               "until": until, "delay_s": delay_s, "p": p})
        return self

    def partition(self, src: str, dst: str, at: int = 0,
                  until: Optional[int] = None) -> "FaultPlan":
        return self.add("partition", src, dst, at=at, until=until)

    def heal(self, src: str = "*", dst: str = "*") -> "FaultPlan":
        """End every open-ended rule matching the edge at the current
        tick (rules with an explicit ``until`` keep their schedule)."""
        with self._lock:
            for r in self.rules:
                if (r["until"] is None
                        and self._edge_match(r, src, dst)):
                    r["until"] = self._tick
        return self

    # ------------------------------------------------------------- clock
    def tick(self) -> int:
        with self._lock:
            self._tick += 1
            return self._tick

    @property
    def now(self) -> int:
        return self._tick

    # ------------------------------------------------------------- gating
    @staticmethod
    def _edge_match(rule: Dict[str, Any], src: str, dst: str) -> bool:
        m = fnmatch.fnmatch
        return ((m(src, rule["src"]) and m(dst, rule["dst"]))
                or (m(src, rule["dst"]) and m(dst, rule["src"])))

    def gate(self, src: str, dst: str) -> None:
        """Consult the plan for one message on edge ``src -> dst``: raise
        :class:`InjectedPartition` (partition, or seeded drop) or sleep
        (delay) per the rules active at the current tick."""
        with self._lock:
            tick = self._tick
            active = [r for r in self.rules
                      if r["at"] <= tick
                      and (r["until"] is None or tick < r["until"])
                      and self._edge_match(r, src, dst)]
            delay = 0.0
            for r in active:
                if r["op"] == "partition" or (
                        r["op"] == "drop"
                        and self.rng.uniform() < r.get("p", 1.0)):
                    self.dropped[(src, dst)] = \
                        self.dropped.get((src, dst), 0) + 1
                    raise InjectedPartition(
                        f"injected partition {src} -> {dst} @tick {tick}")
                if r["op"] == "delay":
                    delay = max(delay, r.get("delay_s", 0.0))
        if delay > 0.0:
            self.delayed[(src, dst)] = self.delayed.get((src, dst), 0) + 1
            time.sleep(delay)

    def edge_gate(self, src: str, dst: str) -> Callable[[], None]:
        """Zero-arg closure for transports that only know their own edge
        (``HTTPClient(fault_gate=...)``)."""
        return lambda: self.gate(src, dst)


@dataclass
class FaultPolicy:
    p_crash: float = 0.0         # trial raises before finishing
    p_nan: float = 0.0           # trial returns NaN (diverged model)
    p_slow: float = 0.0          # trial becomes a straggler
    slow_factor: float = 5.0
    seed: int = 0


def wrap_trial(trial_fn: Callable, policy: FaultPolicy) -> Callable:
    """Deterministic per-trial fault injection keyed by assignment hash."""
    def wrapped(assignment: Dict[str, Any], ctx):
        h = abs(hash(tuple(sorted((k, repr(v)) for k, v in
                                  assignment.items())))) % (2 ** 32)
        rng = np.random.default_rng(policy.seed ^ h)
        roll = rng.uniform()
        if roll < policy.p_crash:
            ctx.log("fault-injection: crash")
            raise InjectedCrash("injected crash")
        if roll < policy.p_crash + policy.p_nan:
            ctx.log("fault-injection: nan")
            return float("nan")
        if roll < policy.p_crash + policy.p_nan + policy.p_slow:
            ctx.log(f"fault-injection: straggler x{policy.slow_factor}")
            t0 = time.time()
            out = trial_fn(assignment, ctx)
            time.sleep((time.time() - t0) * (policy.slow_factor - 1.0))
            return out
        return trial_fn(assignment, ctx)
    return wrapped


class ChaosMonkey:
    """Background node-killer against a Cluster (cluster-level fault
    tolerance: revoked leases -> scheduler requeues from checkpoints)."""

    def __init__(self, cluster: Cluster, pool: str, period_s: float,
                 heal_s: Optional[float] = None, seed: int = 0):
        self.cluster = cluster
        self.pool = pool
        self.period_s = period_s
        self.heal_s = heal_s
        self.rng = np.random.default_rng(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills = 0

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def _loop(self):
        # The FIRST kill is lease-triggered, not clock-triggered: a fixed
        # pre-kill sleep races the workload — a short run (warm caches)
        # can complete inside one period, the monkey never fires, and a
        # test asserting "chaos happened" (kills >= 1) flakes.  Poll
        # until the pool actually holds a lease, kill immediately, then
        # fall into the periodic cadence.
        poll = max(0.001, self.period_s / 10.0)
        while not self._stop.is_set():
            if self.cluster.status()["pools"][self.pool]["leases"] > 0:
                self._kill_one()
                break
            if self._stop.wait(poll):
                return
        while not self._stop.wait(self.period_s):
            self._kill_one()

    def _kill_one(self):
        before = self.cluster.status()["pools"][self.pool]["chips"]
        self.cluster.fail_nodes(self.pool, 1)
        self.kills += 1
        if self.heal_s is not None:
            time.sleep(self.heal_s)
            self.cluster.scale(self.pool, before)       # node replaced
