"""Cluster abstraction (paper §2.2/§2.3/§3.4.1).

A ``Cluster`` owns heterogeneous resource pools — the analogue of the
paper's mixed CPU/GPU EKS node groups.  Each pool has a capacity in
chips (plus min/max bounds for elastic scaling, mirroring the paper's
min_nodes/max_nodes YAML, Fig. 2) and an allocator that carves fixed-size
*slices* for trials.  Chips are capacity units; a lease's ``devices`` are
the first ``chips`` torch devices of the cluster's own (every CUDA card of
the process, or the CPU when the cluster is made with ``device="cpu"``),
so on one card every lease carries ``cuda:0`` and its trial trains there.

Fault model: ``fail_nodes`` removes capacity and revokes affected leases —
the scheduler sees the revocation callback and requeues the trial from its
checkpoint (cluster-level fault tolerance).
"""
from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.device import DeviceLike, resolve


@dataclass
class PoolConfig:
    name: str
    resource: str = "cpu"           # cpu | tpu
    chips: int = 4                  # current capacity
    min_chips: int = 0
    max_chips: int = 1 << 30
    chips_per_node: int = 1

    def to_json(self):
        return self.__dict__.copy()

    @classmethod
    def from_json(cls, d):
        return cls(**{k: d[k] for k in
                      ("name", "resource", "chips", "min_chips", "max_chips",
                       "chips_per_node") if k in d})


@dataclass
class ClusterConfig:
    cluster_name: str
    provider: str = "local"
    pools: List[PoolConfig] = field(default_factory=list)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ClusterConfig":
        pools = [PoolConfig.from_json(p) for p in d.get("pools", [])]
        if not pools:   # paper-style flat yaml: gpu/cpu sections
            for key in ("tpu", "gpu", "cpu"):
                if key in d:
                    sec = d[key]
                    pools.append(PoolConfig(
                        name=key, resource="tpu" if key != "cpu" else "cpu",
                        chips=int(sec.get("max_nodes", 1))
                        * int(sec.get("chips_per_node", 1)),
                        min_chips=int(sec.get("min_nodes", 0)),
                        max_chips=int(sec.get("max_nodes", 1))
                        * int(sec.get("chips_per_node", 1)),
                        chips_per_node=int(sec.get("chips_per_node", 1))))
        return cls(cluster_name=d.get("cluster_name", "cluster"),
                   provider=d.get("cloud_provider", d.get("provider",
                                                          "local")),
                   pools=pools)

    def to_json(self):
        return {"cluster_name": self.cluster_name, "provider": self.provider,
                "pools": [p.to_json() for p in self.pools]}


@dataclass
class SliceLease:
    lease_id: str
    pool: str
    chips: int
    devices: List[Any] = field(default_factory=list)
    revoked: bool = False
    on_revoke: Optional[Callable[["SliceLease"], None]] = None


class Cluster:
    def __init__(self, config: ClusterConfig, device: DeviceLike = None):
        self.config = config
        self.name = config.cluster_name
        self._lock = threading.Lock()
        self._free: Dict[str, int] = {p.name: p.chips for p in config.pools}
        self._caps: Dict[str, PoolConfig] = {p.name: p for p in config.pools}
        self._leases: Dict[str, SliceLease] = {}
        dev = resolve(device)
        self._devices = ([torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())]
                         if dev.type == "cuda" else [dev])

    # ------------------------------------------------------------ allocation
    def allocate(self, pool: str, chips: int,
                 on_revoke=None) -> Optional[SliceLease]:
        """Carve a slice; None if the pool lacks capacity (admission ctl)."""
        with self._lock:
            if pool not in self._free:
                raise KeyError(f"no pool {pool!r}; have {list(self._free)}")
            if self._free[pool] < chips:
                return None
            self._free[pool] -= chips
            lease = SliceLease(uuid.uuid4().hex[:8], pool, chips,
                               devices=self._devices[:max(1, min(
                                   chips, len(self._devices)))],
                               on_revoke=on_revoke)
            self._leases[lease.lease_id] = lease
            return lease

    def release(self, lease: SliceLease) -> None:
        with self._lock:
            if lease.lease_id in self._leases:
                del self._leases[lease.lease_id]
                if not lease.revoked:
                    self._free[lease.pool] += lease.chips

    # ------------------------------------------------------------- elasticity
    def scale(self, pool: str, chips: int) -> int:
        """Elastic resize within [min,max] (paper §2.2 on-demand cluster)."""
        with self._lock:
            cap = self._caps[pool]
            chips = max(cap.min_chips, min(chips, cap.max_chips))
            delta = chips - cap.chips
            cap.chips = chips
            self._free[pool] = max(0, self._free[pool] + delta)
            return chips

    # ------------------------------------------------------------- failures
    def fail_nodes(self, pool: str, n_nodes: int = 1) -> List[SliceLease]:
        """Simulate node loss: capacity shrinks, victim leases are revoked."""
        revoked = []
        with self._lock:
            cap = self._caps[pool]
            lost = min(n_nodes * cap.chips_per_node, cap.chips)
            cap.chips -= lost
            # take capacity from free first, then revoke leases
            from_free = min(lost, self._free[pool])
            self._free[pool] -= from_free
            lost -= from_free
            for lease in list(self._leases.values()):
                if lost <= 0:
                    break
                if lease.pool == pool and not lease.revoked:
                    lease.revoked = True
                    lost -= lease.chips
                    revoked.append(lease)
        for lease in revoked:
            if lease.on_revoke:
                lease.on_revoke(lease)
        return revoked

    # --------------------------------------------------------------- status
    def status(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "name": self.name,
                "pools": {
                    p.name: {"resource": p.resource, "chips": p.chips,
                             "free": self._free[p.name],
                             "leases": sum(1 for l in self._leases.values()
                                           if l.pool == p.name)}
                    for p in self._caps.values()},
            }
