"""System-of-record persistence (the paper's SigOpt role, §3.5): experiment
metadata, parameters, and performance live here *in perpetuity* — destroying
a cluster never touches the store (paper §2.6 dissociates the lifecycles).

Layout (JSON/JSONL; append-only observation + metric logs are crash-safe):
  <root>/experiments/<id>/config.json
  <root>/experiments/<id>/status.json          (incl. 'rungs' snapshot)
  <root>/experiments/<id>/epoch.json           (ownership fence record)
  <root>/experiments/<id>/observations.jsonl
  <root>/experiments/<id>/metrics/<trial>.jsonl
  <root>/experiments/<id>/logs/<trial>.log
  <root>/clusters/<name>.json
  <root>/fleet/<name>.json | events.jsonl      (fleet control plane)

Fencing (API.md §Fleet): each experiment carries an *ownership epoch* —
a ``[term, seq]`` pair compared lexicographically — plus an *owner
token* (the serving process incarnation).  ``claim_fence`` installs a
new (epoch, owner) and refuses to move the epoch backwards;
``check_fence`` is the per-write guard a shard runs before every
durable append: a shard whose (epoch, owner) no longer matches the
record has been superseded and gets :class:`FencedError` instead of a
silent lost write.
"""
from __future__ import annotations

import collections
import json
import os
import pathlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, TextIO, Tuple

from repro_torch.core.experiment import ExperimentConfig
from repro_torch.core.suggest.base import Observation


def _tmp_path(p: pathlib.Path) -> pathlib.Path:
    """The temporary file one writer fills before ``os.replace`` onto
    ``p``: unique to the process and thread, because several ``Store``
    objects (fleet shards, other processes) share a root, each with its
    own lock, and two writers filling one shared temporary file at once
    would replace ``p`` with a torn mix of both."""
    return p.with_name(f"{p.name}.{os.getpid()}.{threading.get_ident()}"
                       ".tmp")


DEFAULT_ROOT = ".orchestrate"

LOG_HANDLE_CACHE = 64           # max simultaneously-open trial log files

EPOCH_ZERO = (0, 0)             # standalone services run at term 0


def _epoch(v) -> Tuple[int, int]:
    """Normalize a stored/wire epoch (2-list, tuple or None)."""
    if v is None:
        return EPOCH_ZERO
    term, seq = v
    return (int(term), int(seq))


class FencedError(Exception):
    """A write (or claim) carried a stale ownership epoch: a newer
    incarnation owns this experiment and the caller must stand down."""

    def __init__(self, exp_id: str, held, current, owner: str = ""):
        self.exp_id = exp_id
        self.held = _epoch(held)
        self.current = _epoch(current)
        self.owner = owner          # the incarnation that fenced us
        super().__init__(
            f"{exp_id}: epoch {list(self.held)} fenced by "
            f"{list(self.current)} (owner {owner or '?'})")


class Store:
    def __init__(self, root: str = DEFAULT_ROOT):
        self.root = pathlib.Path(root)
        (self.root / "experiments").mkdir(parents=True, exist_ok=True)
        (self.root / "clusters").mkdir(parents=True, exist_ok=True)
        (self.root / "fleet").mkdir(parents=True, exist_ok=True)
        self._lock = threading.RLock()
        # status fast path: cache the serialized status.json keyed by
        # (mtime_ns, size, inode) so repeated read-modify-writes skip disk
        # reads but still see writes from other processes sharing the
        # root — set_status os.replace()s a fresh tmp file, so the inode
        # changes even for same-size rewrites within mtime granularity
        self._status_cache: Dict[str, Tuple[Tuple[int, int, int], str]] = {}
        # fence fast path: same (mtime_ns, size, inode) idiom — the
        # per-write check_fence costs one os.stat() while still seeing a
        # concurrent claim from another process sharing the root
        self._fence_cache: Dict[str, Tuple[Tuple[int, int, int], str]] = {}
        # log fast path: bounded LRU of open append handles (one syscall
        # per line instead of an open/write/close triplet)
        self._log_lock = threading.Lock()
        self._log_handles: "collections.OrderedDict[pathlib.Path, TextIO]" \
            = collections.OrderedDict()

    # ----------------------------------------------------------- experiments
    def exp_dir(self, exp_id: str) -> pathlib.Path:
        return self.root / "experiments" / exp_id

    def create_experiment(self, exp_id: str, cfg: ExperimentConfig) -> None:
        d = self.exp_dir(exp_id)
        (d / "logs").mkdir(parents=True, exist_ok=True)
        (d / "metrics").mkdir(parents=True, exist_ok=True)
        (d / "config.json").write_text(json.dumps(cfg.to_json(), indent=1))
        self.set_status(exp_id, {"state": "pending", "created": time.time()})

    def load_config(self, exp_id: str) -> ExperimentConfig:
        return ExperimentConfig.from_json(
            json.loads((self.exp_dir(exp_id) / "config.json").read_text()))

    def set_status(self, exp_id: str, status: Dict[str, Any]) -> None:
        p = self.exp_dir(exp_id) / "status.json"
        tmp = _tmp_path(p)
        text = json.dumps(status, indent=1)
        with self._lock:
            tmp.write_text(text)
            try:
                # stat the tmp file BEFORE the rename: os.replace keeps
                # its inode/mtime/size, and stat-ing p afterwards could
                # pair our text with a concurrent process's newer file
                st = os.stat(tmp)
                self._status_cache[exp_id] = (
                    (st.st_mtime_ns, st.st_size, st.st_ino), text)
            except OSError:
                self._status_cache.pop(exp_id, None)
            os.replace(tmp, p)  # atomic

    def get_status(self, exp_id: str) -> Dict[str, Any]:
        p = self.exp_dir(exp_id) / "status.json"
        with self._lock:
            try:
                st = os.stat(p)
            except OSError:
                self._status_cache.pop(exp_id, None)
                return {}
            key = (st.st_mtime_ns, st.st_size, st.st_ino)
            cached = self._status_cache.get(exp_id)
            if cached is not None and cached[0] == key:
                return json.loads(cached[1])
            text = p.read_text()
            self._status_cache[exp_id] = (key, text)
            return json.loads(text)

    def update_status(self, exp_id: str, **fields) -> Dict[str, Any]:
        with self._lock:   # atomic read-modify-write across threads
            st = self.get_status(exp_id)
            st.update(fields)
            self.set_status(exp_id, st)
        return st

    def list_experiments(self) -> List[str]:
        return sorted(p.name for p in (self.root / "experiments").iterdir()
                      if p.is_dir())

    # ---------------------------------------------------------------- fencing
    def fence_path(self, exp_id: str) -> pathlib.Path:
        return self.exp_dir(exp_id) / "epoch.json"

    def read_fence(self, exp_id: str) -> Tuple[Tuple[int, int], str]:
        """Current ``((term, seq), owner)`` for the experiment.  A missing
        record (pre-fencing store, or experiment never claimed) reads as
        ``(EPOCH_ZERO, "")`` — unowned, any claim wins."""
        p = self.fence_path(exp_id)
        with self._lock:
            try:
                st = os.stat(p)
            except OSError:
                self._fence_cache.pop(exp_id, None)
                return (EPOCH_ZERO, "")
            key = (st.st_mtime_ns, st.st_size, st.st_ino)
            cached = self._fence_cache.get(exp_id)
            if cached is not None and cached[0] == key:
                text = cached[1]
            else:
                text = p.read_text()
                self._fence_cache[exp_id] = (key, text)
            rec = json.loads(text)
            return (_epoch(rec.get("epoch")), rec.get("owner", ""))

    def claim_fence(self, exp_id: str, epoch, owner: str
                    ) -> Tuple[int, int]:
        """Install ``(epoch, owner)`` as the experiment's fence record.

        The epoch may never move backwards: a claim below the stored
        epoch raises :class:`FencedError` (the claimant is a zombie
        acting on a stale map).  An *equal*-epoch claim succeeds and
        swaps the owner token — last adopter wins, which is exactly the
        config-less re-adoption path within one map version — and a
        higher epoch is a manager-granted handover.  Returns the epoch
        now in force."""
        epoch = _epoch(epoch)
        with self._lock:
            cur, cur_owner = self.read_fence(exp_id)
            if epoch < cur:
                raise FencedError(exp_id, epoch, cur, cur_owner)
            p = self.fence_path(exp_id)
            tmp = _tmp_path(p)
            text = json.dumps({"epoch": list(epoch), "owner": owner,
                               "time": time.time()})
            tmp.write_text(text)
            try:
                st = os.stat(tmp)
                self._fence_cache[exp_id] = (
                    (st.st_mtime_ns, st.st_size, st.st_ino), text)
            except OSError:
                self._fence_cache.pop(exp_id, None)
            os.replace(tmp, p)  # atomic
            return epoch

    def check_fence(self, exp_id: str, epoch, owner: str) -> None:
        """Per-write guard: raise :class:`FencedError` unless ``(epoch,
        owner)`` still matches the stored record.  One os.stat() on the
        hot path (cache idiom of :meth:`get_status`)."""
        epoch = _epoch(epoch)
        cur, cur_owner = self.read_fence(exp_id)
        if cur == EPOCH_ZERO and not cur_owner:
            return              # unowned / pre-fencing store: no fence
        if cur > epoch or (cur == epoch and cur_owner != owner):
            raise FencedError(exp_id, epoch, cur, cur_owner)

    # ------------------------------------------------------------ fleet state
    # Control-plane files for the FleetManager (leader lease, rebuildable
    # state snapshot, crash-safe rebalance journal, audit/event tail).
    # All snapshots use the same atomic tmp+replace discipline as
    # set_status so a reader never sees a torn file.

    def fleet_path(self, name: str) -> pathlib.Path:
        return self.root / "fleet" / name

    def write_fleet_state(self, name: str, state: Dict[str, Any]) -> None:
        p = self.fleet_path(f"{name}.json")
        tmp = _tmp_path(p)
        with self._lock:
            tmp.write_text(json.dumps(state, indent=1))
            os.replace(tmp, p)  # atomic

    def read_fleet_state(self, name: str) -> Optional[Dict[str, Any]]:
        p = self.fleet_path(f"{name}.json")
        try:
            return json.loads(p.read_text())
        except (OSError, ValueError):
            return None

    def clear_fleet_state(self, name: str) -> bool:
        p = self.fleet_path(f"{name}.json")
        try:
            p.unlink()
            return True
        except OSError:
            return False

    def append_fleet_event(self, record: Dict[str, Any]) -> None:
        """Append one record to the fleet event tail (``fleet/
        events.jsonl``) — the audit/replay stream a standby manager tails
        to rebuild worker holdings between state snapshots."""
        self._append_line(self.fleet_path("events.jsonl"),
                          json.dumps(record))

    def load_fleet_events(self, limit: int = 0) -> List[Dict[str, Any]]:
        p = self.fleet_path("events.jsonl")
        if not p.exists():
            return []
        out = []
        for line in p.read_text().splitlines():
            if line.strip():
                out.append(json.loads(line))
        return out[-limit:] if limit else out

    # ----------------------------------------------------------- observations
    def append_observation(self, exp_id: str, obs: Observation,
                           trial_id: str = "",
                           suggestion_id: str = "") -> None:
        rec = obs.to_json()
        rec["trial_id"] = trial_id
        if suggestion_id:
            # persisted so an adopting incarnation can rebuild its
            # duplicate-observe dedupe set from the log (fleet fencing:
            # exactly-once observes across ownership handovers)
            rec["suggestion_id"] = suggestion_id
        rec["time"] = time.time()
        with self._lock:
            with open(self.exp_dir(exp_id) / "observations.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")

    def load_observation_records(self, exp_id: str) -> List[Dict[str, Any]]:
        """Raw observation-log records (assignment/value plus trial_id,
        suggestion_id, time) in append order."""
        p = self.exp_dir(exp_id) / "observations.jsonl"
        if not p.exists():
            return []
        out = []
        for line in p.read_text().splitlines():
            if line.strip():
                out.append(json.loads(line))
        return out

    def load_observations(self, exp_id: str) -> List[Observation]:
        return [Observation.from_json(r)
                for r in self.load_observation_records(exp_id)]

    # ---------------------------------------------------------------- metrics
    def metric_path(self, exp_id: str, trial_id: str) -> pathlib.Path:
        return self.exp_dir(exp_id) / "metrics" / f"{trial_id}.jsonl"

    def append_metric(self, exp_id: str, trial_id: str,
                      record: Dict[str, Any]) -> None:
        """Append one progress record to the trial's metric stream (the
        service-side truth for early-stopping rung replay — same
        append-only contract as the observation log)."""
        p = self.metric_path(exp_id, trial_id)
        if not p.parent.exists():
            p.parent.mkdir(parents=True, exist_ok=True)
        self._append_line(p, json.dumps(record))

    def load_metrics(self, exp_id: str,
                     trial_id: Optional[str] = None) -> List[Dict[str, Any]]:
        """Metric records for one trial, or the whole experiment merged in
        ``seq`` order (the service-assigned stream position), so a restart
        replays rung history in the exact original interleaving."""
        mdir = self.exp_dir(exp_id) / "metrics"
        paths = ([self.metric_path(exp_id, trial_id)] if trial_id
                 else sorted(mdir.glob("*.jsonl")) if mdir.exists() else [])
        out: List[Dict[str, Any]] = []
        for p in paths:
            if not p.exists():
                continue
            for line in p.read_text().splitlines():
                if line.strip():
                    out.append(json.loads(line))
        out.sort(key=lambda r: r.get("seq", 0))
        return out

    # ----------------------------------------------------------------- logs
    def log_path(self, exp_id: str, trial_id: str) -> pathlib.Path:
        return self.exp_dir(exp_id) / "logs" / f"{trial_id}.log"

    def append_log(self, exp_id: str, trial_id: str, line: str) -> None:
        self._append_line(self.log_path(exp_id, trial_id),
                          line.rstrip("\n"))

    def _append_line(self, p: pathlib.Path, line: str) -> None:
        """One write+flush through the bounded LRU of open append handles
        (shared by trial logs and metric streams)."""
        with self._log_lock:
            f = self._log_handles.get(p)
            if f is None or f.closed:
                f = open(p, "a")
                self._log_handles[p] = f
                while len(self._log_handles) > LOG_HANDLE_CACHE:
                    _, old = self._log_handles.popitem(last=False)
                    try:
                        old.close()
                    except OSError:
                        pass
            else:
                self._log_handles.move_to_end(p)
            f.write(line + "\n")
            f.flush()   # tail/iter_logs readers must see every line

    def release_handle(self, p: pathlib.Path) -> bool:
        """Evict one cached append handle (a trial reached a terminal
        state and its metric/log stream will never grow again).  At fleet
        scale this is what keeps open-file count proportional to *live*
        trials instead of total trials; a later append transparently
        reopens.  Returns True when a handle was actually closed."""
        with self._log_lock:
            f = self._log_handles.pop(p, None)
        if f is None:
            return False
        try:
            f.close()
        except OSError:
            pass
        return True

    def open_handles(self) -> int:
        """Current size of the append-handle LRU (cap/eviction tests)."""
        with self._log_lock:
            return len(self._log_handles)

    def close_logs(self) -> None:
        """Flush and close all cached trial-log handles."""
        with self._log_lock:
            for f in self._log_handles.values():
                try:
                    f.close()
                except OSError:
                    pass
            self._log_handles.clear()

    def __del__(self):
        try:
            self.close_logs()
        except Exception:
            pass

    def iter_logs(self, exp_id: str, follow: bool = False,
                  poll: float = 0.2, stop=None) -> Iterator[str]:
        """Aggregate all trial logs of one experiment, tagged by trial —
        paper §2.4: 'recover all logs associated with a single experiment,
        irrespective of how parallel configurations were distributed'."""
        log_dir = self.exp_dir(exp_id) / "logs"
        offsets: Dict[str, int] = {}
        while True:
            emitted = False
            for p in sorted(log_dir.glob("*.log")):
                text = p.read_text()
                off = offsets.get(p.name, 0)
                if len(text) > off:
                    for line in text[off:].splitlines():
                        yield f"[{p.stem}] {line}"
                        emitted = True
                    offsets[p.name] = len(text)
            if not follow:
                return
            if stop is not None and stop() and not emitted:
                return
            time.sleep(poll)

    # -------------------------------------------------------------- clusters
    def save_cluster(self, name: str, state: Dict[str, Any]) -> None:
        p = self.root / "clusters" / f"{name}.json"
        p.write_text(json.dumps(state, indent=1))

    def load_cluster(self, name: str) -> Optional[Dict[str, Any]]:
        p = self.root / "clusters" / f"{name}.json"
        return json.loads(p.read_text()) if p.exists() else None

    def delete_cluster(self, name: str) -> bool:
        p = self.root / "clusters" / f"{name}.json"
        if p.exists():
            p.unlink()
            return True
        return False

    def list_clusters(self) -> List[str]:
        return sorted(p.stem for p in (self.root / "clusters").glob("*.json"))
