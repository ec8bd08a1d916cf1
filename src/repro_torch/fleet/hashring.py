"""Consistent-hash ring for experiment→shard routing.

Experiments are pinned to shards by hashing the experiment id onto a ring
of virtual nodes (``replicas`` per shard), so adding or removing one shard
moves only ~1/N of the keyspace — the property that makes failover cheap:
when a shard dies, only *its* experiments re-home, everyone else's routes
are untouched.

The hash is ``blake2b`` (stable across processes and Python runs —
``hash()`` is salted per-process and useless for routing agreement).
"""
from __future__ import annotations

import bisect
import hashlib
from typing import Dict, List, Optional


def _h(key: str) -> int:
    return int.from_bytes(hashlib.blake2b(key.encode(),
                                          digest_size=8).digest(), "big")


class HashRing:
    """Classic consistent hashing with virtual nodes."""

    def __init__(self, nodes: Optional[List[str]] = None, replicas: int = 64):
        self.replicas = max(1, int(replicas))
        self._ring: List[int] = []          # sorted vnode hashes
        self._owner: Dict[int, str] = {}    # vnode hash -> node
        self._nodes: set = set()
        for n in nodes or []:
            self.add(n)

    def __len__(self) -> int:
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        return node in self._nodes

    @property
    def nodes(self) -> List[str]:
        return sorted(self._nodes)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        for i in range(self.replicas):
            h = _h(f"{node}#{i}")
            # blake2b collisions at 64 bits are ~impossible at fleet
            # sizes; last-add-wins keeps the ring consistent anyway
            if h not in self._owner:
                bisect.insort(self._ring, h)
            self._owner[h] = node

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        for i in range(self.replicas):
            h = _h(f"{node}#{i}")
            if self._owner.get(h) == node:
                del self._owner[h]
                idx = bisect.bisect_left(self._ring, h)
                if idx < len(self._ring) and self._ring[idx] == h:
                    self._ring.pop(idx)

    def owner(self, key: str) -> Optional[str]:
        """The shard owning ``key`` (clockwise successor vnode)."""
        if not self._ring:
            return None
        h = _h(key)
        idx = bisect.bisect(self._ring, h)
        if idx == len(self._ring):
            idx = 0
        return self._owner[self._ring[idx]]

    def moved_by_adding(self, node: str, keys) -> List[str]:
        """The minimal disruption set: the keys whose ownership would
        move if ``node`` joined the ring.  Consistent hashing guarantees
        a key only ever moves *to* the new node — everyone else's routes
        are untouched — so this is exactly the set a rebalance-on-add
        must hand over.  Non-destructive (simulates the add)."""
        if node in self._nodes or not self._ring:
            return []
        after = HashRing(nodes=list(self._nodes) + [node],
                         replicas=self.replicas)
        return [k for k in keys if after.owner(k) != self.owner(k)]

    def spread(self, keys) -> Dict[str, int]:
        """keys-per-node histogram (balance diagnostics/tests)."""
        out: Dict[str, int] = {n: 0 for n in self._nodes}
        for k in keys:
            o = self.owner(k)
            if o is not None:
                out[o] += 1
        return out
