"""The fleet manager's HTTP surface (stdlib-only, like ``serve_api``).

Endpoint map (schemas in API.md §Fleet):
  POST /fleet/experiments   admission-controlled create/resume; responds
                            with the CreateResponse plus the chosen
                            ``shard_id``/``shard_url`` and ``map_version``
  GET  /fleet/map           versioned ShardMap (routing table)
  POST /fleet/heartbeat     worker liveness beat -> {state, map_version,
                            period}
  POST /fleet/shards        attach a running ``serve-api`` shard at
                            runtime ({url, shard_id?, rebalance?}); the
                            manager rebalances the minimal disruption
                            set onto it (drain → adopt at a bumped
                            epoch → transfer)
  GET  /fleet/status        manager status (shards, workers, stats,
                            role/term)
  GET  /fleet/healthz       manager liveness

``serve_fleet`` assembles the whole thing: a FleetManager over N
in-process shards (each a real ``serve_api`` HTTP process-in-a-thread
over the *shared* store root) and/or externally-launched shard URLs.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Union

from repro_torch.api.http import ApiServer, serve_api
from repro_torch.api.protocol import (ApiError, CreateExperiment,
                                      E_BAD_REQUEST, E_INTERNAL,
                                      HeartbeatRequest)
from repro_torch.core.store import Store
from repro_torch.device import DeviceLike
from repro_torch.fleet.manager import FleetManager


class _FleetHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    manager: FleetManager = None            # set by FleetServer

    def log_message(self, fmt, *args):      # noqa: D102
        pass

    def _take_body(self) -> bytes:
        if getattr(self, "_body", None) is None:
            n = int(self.headers.get("Content-Length") or 0)
            self._body = self.rfile.read(n) if n else b""
        return self._body

    def _read_body(self) -> dict:
        raw = self._take_body() or b"{}"
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ApiError(E_BAD_REQUEST, f"invalid JSON body: {e}")

    def _send(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _dispatch(self, method: str) -> None:
        self._body = None
        try:
            self._send(200, self._route(method))
        except ApiError as e:
            self._send(e.http_status, e.to_json())
        except Exception as e:  # noqa: the manager must answer, not die
            err = ApiError(E_INTERNAL, f"{type(e).__name__}: {e}")
            self._send(err.http_status, err.to_json())
        finally:
            self._take_body()   # drain for keep-alive reuse

    def _route(self, method: str) -> dict:
        m = self.manager
        path = self.path.split("?")[0].rstrip("/")
        if method == "GET" and path == "/fleet/healthz":
            return {"ok": True, "shards": len(m.ring)}
        if method == "GET" and path == "/fleet/map":
            return m.shard_map().to_json()
        if method == "GET" and path == "/fleet/status":
            return m.status()
        if method == "POST" and path == "/fleet/heartbeat":
            req = HeartbeatRequest.from_json(self._read_body())
            return m.heartbeat(req).to_json()
        if method == "POST" and path == "/fleet/shards":
            body = self._read_body()
            url = (body.get("url") or "").strip()
            if not url:
                raise ApiError(E_BAD_REQUEST, "shard url required")
            handle = m.add_shard(url, shard_id=body.get("shard_id"),
                                 rebalance=bool(body.get("rebalance", True)))
            out = handle.to_json()
            out["map_version"] = m.shard_map().version
            return out
        if method == "POST" and path == "/fleet/experiments":
            req = CreateExperiment.from_json(self._read_body())
            resp, shard_id, url, version = m.create_experiment(req)
            out = resp.to_json()
            out.update(shard_id=shard_id, shard_url=url,
                       map_version=version)
            return out
        raise ApiError(E_BAD_REQUEST, f"no route for {self.path!r}")

    def do_GET(self):   # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")


class FleetServer:
    """Owns the manager's HTTP listener, the FleetManager event loop, and
    any in-process shards ``serve_fleet`` spawned."""

    def __init__(self, manager: FleetManager, host: str = "127.0.0.1",
                 port: int = 0,
                 owned_shards: Optional[List[ApiServer]] = None):
        self.manager = manager
        self.owned_shards = list(owned_shards or [])
        handler = type("BoundFleetHandler", (_FleetHandler,),
                       {"manager": manager})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "FleetServer":
        self.manager.start()
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="fleet-api", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.manager.start()
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        """Graceful stop: listener first (no new work), then the event
        loop, then any shards this server owns."""
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self.manager.stop()
        for shard in self.owned_shards:
            try:
                shard.shutdown()
            except Exception:
                pass


def serve_fleet(store: Union[Store, str, None] = None, shards: int = 0,
                shard_urls: Sequence[str] = (), host: str = "127.0.0.1",
                port: int = 0, period: float = 1.0,
                device: DeviceLike = None,
                **manager_kwargs) -> FleetServer:
    """Build (but don't start) a fleet.  ``shards`` in-process
    ``serve_api`` servers are spawned over the shared ``store`` root (the
    config that makes failover a config-less resume), each fitting its GP
    on ``device`` (None: the CUDA card); ``shard_urls`` attaches
    externally-launched ``serve-api`` processes.  At least one shard is
    required."""
    if shards > 0 and store is None:
        raise ValueError("in-process shards need a store root")
    standby = bool(manager_kwargs.get("standby"))
    if shards <= 0 and not shard_urls and not standby:
        # a warm standby may start empty — it inherits the fleet from
        # the control snapshot at takeover
        raise ValueError("a fleet needs at least one shard "
                         "(shards=N or shard_urls=[...])")
    if standby and store is None:
        raise ValueError("a standby manager needs the shared store root")
    # the shared store doubles as the manager's control plane (leader
    # lease, snapshot, event tail, rebalance journal) — that is what
    # makes a warm standby and crash-safe rebalance possible
    manager_kwargs.setdefault("store", store)
    manager = FleetManager(period=period, **manager_kwargs)
    owned: List[ApiServer] = []
    for i in range(shards):
        srv = serve_api(store, host=host, device=device).start()
        owned.append(srv)
        manager.add_shard(srv.url, shard_id=f"shard-{i}")
    for url in shard_urls:
        manager.add_shard(url)
    return FleetServer(manager, host=host, port=port, owned_shards=owned)
