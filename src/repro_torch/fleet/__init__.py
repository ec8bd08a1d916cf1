"""Fleet control plane: shard many experiments across N suggestion-service
processes (thousands of concurrent experiments).

Pieces, each at the JAX package's relative path:

* :mod:`~repro_torch.fleet.hashring`  — consistent-hash experiment→shard
  routing
* :mod:`~repro_torch.fleet.heartbeat` — worker liveness state machine
  (registered → alive → suspect → dead, monotonic-clock deadlines)
* :mod:`~repro_torch.fleet.manager`   — FleetManager: shard map +
  admission control + the event loop that detects dead workers/shards
  and requeues their pending suggestions
* :mod:`~repro_torch.fleet.router`    — FleetClient: a
  ``SuggestionClient`` that makes the whole fleet look like one service
* :mod:`~repro_torch.fleet.serve`     — the manager's HTTP surface +
  the ``serve-fleet`` verb

See API.md §Fleet for the protocol and failure-mode table.
"""
from repro_torch.fleet.hashring import HashRing
from repro_torch.fleet.heartbeat import (S_ALIVE, S_DEAD, S_REGISTERED,
                                         S_SUSPECT, WorkerRegistry)
from repro_torch.fleet.manager import FleetManager
from repro_torch.fleet.router import FleetClient
from repro_torch.fleet.serve import FleetServer, serve_fleet

__all__ = ["HashRing", "WorkerRegistry", "FleetManager", "FleetClient",
           "FleetServer", "serve_fleet",
           "S_REGISTERED", "S_ALIVE", "S_SUSPECT", "S_DEAD"]
