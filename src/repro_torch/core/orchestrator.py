"""Experiment/cluster lifecycle — the library behind the CLI verbs
(paper §3.1).  Cluster and experiment lifetimes are deliberately
dissociated (paper §2.6): destroying a cluster never deletes experiment
records from the store.

The orchestrator never holds a raw ``Optimizer`` and never reaches into
scheduler internals: all experiment state flows through a
``SuggestionClient`` (see API.md) — the in-process ``LocalClient`` by
default, or an ``HTTPClient`` when ``run(..., service=URL)`` drives the
experiment against a remote ``serve-api`` process (a ``FleetClient`` with
``fleet=URL``).  Trial lifecycle (intermediate metrics, early-stopping
decisions, pause/resume) is likewise service-owned: ``ctx.report`` flows
through ``SuggestionClient.report``, so N orchestrators on one experiment
share one rung table.

The orchestrator runs on the CUDA card unless ``device="cpu"`` is
passed: its ``LocalClient`` fits the GP there, and each of its clusters
hands that device's cards to trials through their leases.
"""
from __future__ import annotations

import importlib
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from repro_torch.api.client import SuggestionClient
from repro_torch.api.protocol import ApiError, CreateExperiment
from repro_torch.core.cluster import Cluster, ClusterConfig
from repro_torch.core.experiment import ExperimentConfig
from repro_torch.core.scheduler import Scheduler, TrialContext
from repro_torch.core.store import Store
from repro_torch.device import DeviceLike


def resolve_entrypoint(spec: str) -> Callable:
    """'pkg.module:function' -> callable (the model-agnostic hook that
    replaces the paper's container entrypoint)."""
    mod, _, attr = spec.partition(":")
    fn = getattr(importlib.import_module(mod), attr or "main")
    return fn


class Orchestrator:
    def __init__(self, store_root: str = ".orchestrate",
                 client: Optional[SuggestionClient] = None,
                 device: DeviceLike = None):
        # deferred import: repro_torch.api.local depends back on
        # repro_torch.core
        from repro_torch.api.local import LocalClient
        self.store = Store(store_root)
        self.device = device
        self.client = client or LocalClient(self.store, device=device)
        self._clusters: Dict[str, Cluster] = {}
        self._schedulers: Dict[str, Scheduler] = {}
        self._threads: Dict[str, threading.Thread] = {}
        self._exp_clients: Dict[str, SuggestionClient] = {}
        self._exp_clusters: Dict[str, str] = {}

    # ------------------------------------------------------------- clusters
    def cluster_create(self, config: Dict[str, Any]) -> Cluster:
        cc = ClusterConfig.from_json(config)
        if self.store.load_cluster(cc.cluster_name) is not None:
            raise ValueError(f"cluster {cc.cluster_name!r} already exists")
        cluster = Cluster(cc, device=self.device)
        self._clusters[cc.cluster_name] = cluster
        self.store.save_cluster(cc.cluster_name, cc.to_json())
        return cluster

    def cluster_get(self, name: str) -> Cluster:
        if name in self._clusters:
            return self._clusters[name]
        state = self.store.load_cluster(name)
        if state is None:
            raise KeyError(f"no cluster {name!r}")
        cluster = Cluster(ClusterConfig.from_json(state), device=self.device)
        self._clusters[name] = cluster
        return cluster

    def cluster_destroy(self, name: str) -> bool:
        """Tear down the cluster; experiment records remain in the store.
        Only experiments attached to *this* cluster are stopped — runs on
        other clusters (or cluster-less) keep going."""
        for exp_id, sched in list(self._schedulers.items()):
            if self._exp_clusters.get(exp_id) == name:
                sched.stop()
        self._clusters.pop(name, None)
        return self.store.delete_cluster(name)

    def cluster_status(self, name: str) -> Dict[str, Any]:
        return self.cluster_get(name).status()

    # ----------------------------------------------------------- experiments
    def _client_for(self, exp_id: str) -> SuggestionClient:
        return self._exp_clients.get(exp_id, self.client)

    def run(self, cfg: ExperimentConfig,
            trial_fn: Optional[Callable[[Dict[str, Any], TrialContext],
                                        float]] = None,
            cluster: Optional[str] = None, background: bool = False,
            exp_id: Optional[str] = None,
            service: Optional[str] = None,
            fleet: Optional[str] = None) -> str:
        """Start (or resume) an experiment.  Resuming an existing exp_id
        replays the observation log into the service's optimizer exactly
        once.  With ``service=URL`` the suggest/observe loop runs against
        a remote ``serve-api`` process; with ``fleet=URL`` it runs
        through a ``serve-fleet`` manager, which routes the experiment to
        its owning shard (API.md §Fleet).  Trial logs and checkpoints stay
        in this worker's local store either way."""
        if trial_fn is None:
            if not cfg.entrypoint:
                raise ValueError("need trial_fn or cfg.entrypoint")
            trial_fn = resolve_entrypoint(cfg.entrypoint)

        from repro_torch.api.http import HTTPClient
        if fleet:
            from repro_torch.fleet.router import FleetClient
            client = FleetClient(fleet)
        elif service:
            client = HTTPClient(service)
        else:
            client = self.client
        created = client.create_experiment(
            CreateExperiment(config=cfg.to_json(), exp_id=exp_id))
        exp_id = created.exp_id
        self._exp_clients[exp_id] = client
        if not (self.store.exp_dir(exp_id) / "config.json").exists():
            # remote service (or externally-stored client): local mirror
            # for trial logs / checkpoints / status
            self.store.create_experiment(exp_id, cfg)

        clu = self.cluster_get(cluster) if cluster else None
        sched = Scheduler(exp_id, cfg, client, clu, self.store, trial_fn)
        self._schedulers[exp_id] = sched
        if cluster:
            self._exp_clusters[exp_id] = cluster
        if background:
            th = threading.Thread(target=sched.run, daemon=True,
                                  name=f"sched-{exp_id}")
            th.start()
            self._threads[exp_id] = th
        else:
            sched.run()
        return exp_id

    def wait(self, exp_id: str, timeout: Optional[float] = None) -> None:
        th = self._threads.get(exp_id)
        if th:
            th.join(timeout)

    def status(self, exp_id: str) -> Dict[str, Any]:
        resp = self._client_for(exp_id).status(exp_id)
        st = dict(self.store.get_status(exp_id))   # local worker view
        remote = resp.to_json()
        remote.pop("exp_id", None)
        # the service owns observation truth; lifecycle state defers to a
        # local scheduler unless the service reached a terminal state
        local_state = st.get("state")
        terminal = ("complete", "stopped", "deleted", "failed")
        state = (remote["state"] if remote["state"] in terminal
                 or not local_state else local_state)
        st.update(remote)
        st["state"] = state
        sched = self._schedulers.get(exp_id)
        if sched:
            st["running_trials"] = sched.running_trials
            st["paused_trials"] = sched.paused_trials
        return st

    def logs(self, exp_id: str, follow: bool = False) -> Iterator[str]:
        stop = None
        sched = self._schedulers.get(exp_id)
        if sched is not None:
            stop = lambda: sched.finished
        return self.store.iter_logs(exp_id, follow=follow, stop=stop)

    def delete(self, exp_id: str) -> None:
        """Terminate all execution and free resources (paper §2.5)."""
        sched = self._schedulers.get(exp_id)
        if sched:
            sched.stop()
        try:
            self._client_for(exp_id).stop(exp_id, state="deleted")
        except ApiError:
            self.store.update_status(exp_id, state="deleted")
        self._exp_clients.pop(exp_id, None)
        self._exp_clusters.pop(exp_id, None)
