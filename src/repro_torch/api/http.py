"""HTTP backend for the suggestion service (stdlib-only).

``serve_api`` exposes a ``LocalClient`` as JSON endpoints under
``/v1/experiments/...`` so remote workers on other hosts can run the
suggest/observe loop against one service process (paper §3.5: workers are
thin clients of a central suggestion service).  ``HTTPClient`` is the
matching ``SuggestionClient`` — ``Scheduler`` runs unchanged against
either backend.  The wire is the JAX package's, byte for byte: either
package's client drives either package's server.  The service fits its
GP on the CUDA card unless ``serve_api(..., device="cpu")``; the device is
resolved when the server is built, before any handler thread runs.

Endpoint map (full schemas in API.md):
  POST /v1/experiments                          create / resume
  GET  /v1/experiments/{id}                     status
  POST /v1/experiments/{id}/suggestions         suggest   {count}
  POST /v1/experiments/{id}/observations        observe
  POST /v1/experiments/{id}/trials/{tid}/report report    {step, value}
  POST /v1/experiments/{id}/release             release   {suggestion_id}
  POST /v1/experiments/{id}/requeue             requeue   {suggestion_id}
  POST /v1/experiments/{id}/drain               drain (fleet handover)
  POST /v1/experiments/{id}/stop                stop      {state}
  GET  /v1/experiments/{id}/best                best
  POST /v1/batch                                batched ops (transport plane)
  GET  /v1/healthz                              liveness
  GET  /v1/load                                 shard load (fleet admission)
"""
from __future__ import annotations

import http.client
import json
import random
import socket
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Tuple, Union

from repro_torch.api.client import SuggestionClient
from repro_torch.api.local import LocalClient
from repro_torch.api.protocol import (ApiError, BatchRequest, BatchResponse,
                                      BestResponse, CreateExperiment,
                                      CreateResponse, Decision, DrainRequest,
                                      DrainResponse, E_BAD_REQUEST, E_INTERNAL,
                                      ObserveRequest, ObserveResponse,
                                      PROTOCOL_VERSION, ReleaseRequest,
                                      ReleaseResponse, ReportRequest,
                                      RequeueRequest, StatusResponse,
                                      StopRequest, SuggestBatch,
                                      SuggestRequest)
from repro_torch.api.transport import (FLUSH_DEADLINE_S, FLUSH_MAX_OPS,
                                       DecisionGate, OP_OBSERVE, OP_RELEASE,
                                       OP_REPORT, WriteBehind)
from repro_torch.core.store import Store
from repro_torch.device import DeviceLike, resolve


def _parse_path(path: str):
    """-> (exp_id | None, action | None, trial_id | None); raises ApiError
    on bad paths.  ``trial_id`` is only set for the nested trial-events
    route ``/v1/experiments/{id}/trials/{tid}/report``."""
    parts = [p for p in path.split("?")[0].split("/") if p]
    if parts == ["v1", "healthz"]:
        return None, "healthz", None
    if parts == ["v1", "load"]:
        return None, "load", None
    if parts == ["v1", "batch"]:
        return None, "batch", None
    if not parts or parts[0] != "v1" or len(parts) < 2 \
            or parts[1] != "experiments" or len(parts) > 6:
        raise ApiError(E_BAD_REQUEST, f"no route for {path!r}")
    exp_id = parts[2] if len(parts) > 2 else None
    if len(parts) > 4:
        if len(parts) != 6 or parts[3] != "trials" or parts[5] != "report":
            raise ApiError(E_BAD_REQUEST, f"no route for {path!r}")
        return exp_id, "report", parts[4]
    action = parts[3] if len(parts) > 3 else None
    if action not in (None, "suggestions", "observations", "release",
                      "requeue", "drain", "stop", "best"):
        raise ApiError(E_BAD_REQUEST, f"unknown action {action!r}")
    return exp_id, action, None


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # The response is written as two segments (headers, then body).  With
    # Nagle on, the second small write sits in the kernel until the
    # client's *delayed ACK* (~40 ms) releases it — which was the entire
    # observed cost of the small-RPC hot path (report p50 ≈ 43 ms).
    # TCP_NODELAY ships both segments immediately.
    disable_nagle_algorithm = True
    backend: LocalClient = None           # set by serve_api

    # silence per-request stderr lines
    def log_message(self, fmt, *args):    # noqa: D102
        pass

    def _read_body(self) -> dict:
        raw = self._take_body() or b"{}"
        try:
            return json.loads(raw)
        except json.JSONDecodeError as e:
            raise ApiError(E_BAD_REQUEST, f"invalid JSON body: {e}")

    def _take_body(self) -> bytes:
        """Consume the request body exactly once.  Every request must end
        up drained — an unread body would be parsed as the next request
        line on a keep-alive connection."""
        if getattr(self, "_body", None) is None:
            n = int(self.headers.get("Content-Length") or 0)
            self._body = self.rfile.read(n) if n else b""
        return self._body

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
            exp_id, action, trial_id = _parse_path(self.path)
            self._send(200, self._route(method, exp_id, action, trial_id))
        except ApiError as e:
            self._send(e.http_status, e.to_json())
        except Exception as e:  # noqa: service must answer, not die
            err = ApiError(E_INTERNAL, f"{type(e).__name__}: {e}")
            self._send(err.http_status, err.to_json())
        finally:
            self._take_body()   # drain for keep-alive reuse

    def _route(self, method: str, exp_id: Optional[str],
               action: Optional[str],
               trial_id: Optional[str] = None) -> dict:
        b = self.backend
        if action == "healthz":
            return {"ok": True, "version": PROTOCOL_VERSION}
        if action == "load":
            # shard saturation snapshot — the fleet manager's admission-
            # control probe (FitExecutor backlog + duty cycle)
            return b.load()
        if action == "batch":
            # transport plane: one POST carries an ordered op batch; the
            # backend applies it grouped per experiment (one lock
            # acquisition per group) with exactly-once replay by batch_id
            return b.apply_batch(
                BatchRequest.from_json(self._read_body())).to_json()
        if method == "POST" and exp_id is None and action is None:
            req = CreateExperiment.from_json(self._read_body())
            return b.create_experiment(req).to_json()
        if exp_id is None:
            raise ApiError(E_BAD_REQUEST, "experiment id required")
        if method == "GET" and action is None:
            return b.status(exp_id).to_json()
        if method == "GET" and action == "best":
            return b.best_response(exp_id).to_json()
        if method != "POST":
            raise ApiError(E_BAD_REQUEST, f"{method} not allowed here")
        body = self._read_body()
        body["exp_id"] = exp_id
        if action == "report":
            body["trial_id"] = trial_id
            return b.report(ReportRequest.from_json(body)).to_json()
        if action == "suggestions":
            req = SuggestRequest.from_json(body)
            return b.suggest(req.exp_id, req.count).to_json()
        if action == "observations":
            return b.observe(ObserveRequest.from_json(body)).to_json()
        if action == "release":
            req = ReleaseRequest.from_json(body)
            ok = b.release(req.exp_id, req.suggestion_id)
            return ReleaseResponse(released=ok).to_json()
        if action == "requeue":
            rq = RequeueRequest.from_json(body)
            return {"requeued": b.requeue(rq.exp_id, rq.suggestion_id,
                                          assignment=rq.assignment)}
        if action == "drain":
            req = DrainRequest.from_json(body)
            return b.drain(req.exp_id).to_json()
        if action == "stop":
            req = StopRequest.from_json(body)
            return b.stop(req.exp_id, req.state).to_json()
        raise ApiError(E_BAD_REQUEST, f"no route for {self.path!r}")

    def do_GET(self):   # noqa: N802
        self._dispatch("GET")

    def do_POST(self):  # noqa: N802
        self._dispatch("POST")


class ApiServer:
    """Owns the HTTP listener and the backing ``LocalClient``."""

    def __init__(self, backend: LocalClient, host: str, port: int):
        self.backend = backend
        handler = type("BoundHandler", (_Handler,), {"backend": backend})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ApiServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="suggestion-api", daemon=True)
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def shutdown(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
        # drain the suggestion pipeline: prefetch pumps must not keep
        # speculating (or hold optimizer locks) past the listener's death
        self.backend.close()


def serve_api(store: Union[Store, str, LocalClient],
              host: str = "127.0.0.1", port: int = 0,
              device: DeviceLike = None) -> ApiServer:
    """Build (but don't start) an API server over a store root, a
    ``Store``, or an existing ``LocalClient``.  ``port=0`` picks a free
    port; read it back from ``server.port``/``server.url``.  A new
    ``LocalClient`` fits on ``device`` (None: the CUDA card).  The
    backend's device is resolved here, on the constructing thread, with
    PyTorch's lazily loaded CUDA linear algebra: no handler thread is the
    first to reach it."""
    backend = (store if isinstance(store, LocalClient)
               else LocalClient(store, device=device))
    resolve(backend.device, linalg=True)
    return ApiServer(backend, host, port)


RETRY_BASE_S = 0.05      # first backoff upper bound
RETRY_CAP_S = 2.0        # backoff ceiling
RETRY_ATTEMPTS = 4       # max total attempts for a retryable failure


class HTTPClient(SuggestionClient):
    """Remote-worker side of the wire: a ``SuggestionClient`` that speaks
    the v1 JSON protocol against ``serve_api``.

    Transport: one persistent keep-alive ``http.client.HTTPConnection``
    per thread (the scheduler loop pays one TCP handshake total instead of
    one per request).  A request that fails on a *reused* connection —
    the server closed an idle keep-alive — transparently reconnects and
    retries immediately (the server never saw it).

    Beyond that, transient failures get **bounded exponential backoff
    with full jitter** (base 50 ms doubling to a 2 s cap, ≤4 attempts,
    ``sleep ~ U(0, min(cap, base·2^k))``): a send-phase failure or
    refused connect provably never reached the service, so any verb may
    retry; a *response*-phase failure is ambiguous (the server may have
    committed), so only idempotent verbs retry — a non-idempotent resend
    (suggest) would leak pending budget.  Per-client counters live in
    ``self.stats`` and ride along in ``StatusResponse.transport`` so
    tests assert retry behavior instead of sleeping.

    ``fault_gate`` (chaos harness, ``core.faults.FaultPlan.edge_gate``)
    is consulted before every attempt and raises ``InjectedPartition``
    — a ``ConnectionRefusedError`` — so injected faults exercise these
    exact retry paths.

    ``batch=True`` turns on the write-behind transport plane (API.md
    §Transport batching): observe/release become fire-and-forget
    enqueues, reports ride unless they can cross an ASHA rung
    (:class:`DecisionGate`), and any blocking verb first drains the
    queue.  Batches POST ``/v1/batch`` as idempotent requests — the
    backoff machinery above retries whole batches by ``batch_id`` and
    the server's dedupe window makes redelivery exactly-once."""

    def __init__(self, base_url: str, timeout: float = 30.0,
                 retry_attempts: int = RETRY_ATTEMPTS,
                 retry_base: float = RETRY_BASE_S,
                 retry_cap: float = RETRY_CAP_S,
                 retry_seed: Optional[int] = None,
                 fault_gate: Optional[Callable[[], None]] = None,
                 batch: bool = False,
                 batch_max: int = FLUSH_MAX_OPS,
                 batch_deadline: float = FLUSH_DEADLINE_S):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        u = urllib.parse.urlsplit(self.base_url)
        if u.scheme not in ("http", "https"):
            raise ValueError(f"unsupported scheme in {base_url!r}")
        self._conn_cls = (http.client.HTTPSConnection if u.scheme == "https"
                          else http.client.HTTPConnection)
        self._host = u.hostname or "127.0.0.1"
        self._port = u.port or (443 if u.scheme == "https" else 80)
        self._prefix = u.path.rstrip("/")
        self._local = threading.local()
        self.retry_attempts = max(1, retry_attempts)
        self.retry_base = retry_base
        self.retry_cap = retry_cap
        self.fault_gate = fault_gate
        self._rng = random.Random(retry_seed)
        self._stats_lock = threading.Lock()
        self.stats = {"retries": 0,      # re-sent requests (all causes)
                      "backoffs": 0,     # retries that slept first
                      "backoff_ms": 0.0,  # total time slept
                      "refused": 0,      # connection-refused failures seen
                      "gave_up": 0}      # requests failed after all attempts
        self._wb: Optional[WriteBehind] = None
        self._gate: Optional[DecisionGate] = None
        if batch:
            self._gate = DecisionGate()
            self._wb = WriteBehind(self._send_batch, max_ops=batch_max,
                                   deadline=batch_deadline,
                                   on_result=self._on_batch_result,
                                   name=f"wb-{self._host}:{self._port}")

    def _backoff(self, attempt: int) -> None:
        """Full-jitter sleep before retry ``attempt`` (0-based)."""
        delay = self._rng.uniform(
            0.0, min(self.retry_cap, self.retry_base * (2 ** attempt)))
        with self._stats_lock:
            self.stats["retries"] += 1
            self.stats["backoffs"] += 1
            self.stats["backoff_ms"] += delay * 1e3
        if delay > 0.0:
            time.sleep(delay)

    def _count(self, key: str) -> None:
        with self._stats_lock:
            self.stats[key] += 1

    # ------------------------------------------------------------ transport
    def _conn(self) -> Tuple[http.client.HTTPConnection, bool]:
        """-> (connection, fresh); fresh=True when newly established."""
        c = getattr(self._local, "conn", None)
        if c is not None:
            return c, False
        c = self._conn_cls(self._host, self._port, timeout=self.timeout)
        self._local.conn = c
        return c, True

    def _drop_conn(self) -> None:
        c = getattr(self._local, "conn", None)
        self._local.conn = None
        if c is not None:
            try:
                c.close()
            except OSError:
                pass

    def close(self) -> None:
        """Flush any write-behind queue, then close this thread's
        persistent connection (idempotent)."""
        if self._wb is not None:
            self._wb.close()
        self._drop_conn()

    def _call(self, method: str, path: str, payload: Optional[dict] = None,
              idempotent: bool = True) -> dict:
        body = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"}
        url = self._prefix + path
        attempt = 0                     # backoff retries consumed
        while True:
            conn, fresh = self._conn()
            try:
                if self.fault_gate is not None:
                    self.fault_gate()
                conn.request(method, url, body=body, headers=headers)
                if fresh and conn.sock is not None:
                    # belt-and-braces to the server-side Nagle disable:
                    # never let a small client segment wait on delayed ACK
                    try:
                        conn.sock.setsockopt(socket.IPPROTO_TCP,
                                             socket.TCP_NODELAY, 1)
                    except OSError:
                        pass
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                # send-phase failure: the socket rejected the write, so
                # the server never processed the request — safe to
                # reconnect and retry even for non-idempotent verbs
                self._drop_conn()
                refused = isinstance(e, ConnectionRefusedError)
                if refused:
                    self._count("refused")
                if not fresh:
                    # stale keep-alive: free immediate retry, next is fresh
                    self._count("retries")
                    continue
                if attempt + 1 >= self.retry_attempts:
                    self._count("gave_up")
                    raise ApiError(E_INTERNAL, f"service unreachable: {e}")
                self._backoff(attempt)
                attempt += 1
                continue
            try:
                resp = conn.getresponse()
                raw = resp.read()       # drain fully so the conn is reusable
                status = resp.status
                if resp.will_close:
                    self._drop_conn()
            except (http.client.HTTPException, ConnectionError, OSError) as e:
                self._drop_conn()
                if not idempotent:
                    # response-phase failure is ambiguous — the server may
                    # have committed the request.  Non-idempotent verbs
                    # (suggest) must not auto-retry here: a blind resend
                    # would leak pending budget — surface the error and
                    # let the caller decide
                    raise ApiError(E_INTERNAL, f"service unreachable: {e}")
                if not fresh:
                    self._count("retries")
                    continue            # stale keep-alive: retry once, fresh
                if attempt + 1 >= self.retry_attempts:
                    self._count("gave_up")
                    raise ApiError(E_INTERNAL, f"service unreachable: {e}")
                self._backoff(attempt)
                attempt += 1
                continue
            if status >= 400:
                try:
                    raise ApiError.from_json(json.loads(raw or b"{}"))
                except json.JSONDecodeError:
                    raise ApiError(E_INTERNAL,
                                   f"HTTP {status} from {self.base_url}{path}")
            return json.loads(raw or b"{}")

    # ------------------------------------------------------------- batching
    def _send_batch(self, lane, req: BatchRequest) -> BatchResponse:
        """WriteBehind transport: batches are idempotent by ``batch_id``
        (server dedupe window), so the full retry machinery — including
        ambiguous response-phase failures — may resend them whole."""
        return BatchResponse.from_json(
            self._call("POST", "/v1/batch", req.to_json()))

    def apply_batch(self, req: BatchRequest) -> BatchResponse:
        """Ship one pre-built batch (the ``FleetClient`` per-shard path
        uses this directly on HTTP shard transports)."""
        return self._send_batch(None, req)

    def _on_batch_result(self, lane, op, result, err) -> bool:
        if err is None and op.kind == OP_REPORT and self._gate is not None:
            # feed the decision cache so future reports from this trial
            # know their next rung (and stash any stop/pause for the
            # trial's next report)
            p = op.payload
            self._gate.note((p.get("exp_id"),
                             p.get("suggestion_id") or p.get("trial_id")),
                            Decision.from_json(result.result))
        return False    # default accounting for failures

    def flush(self) -> None:
        """Drain the write-behind queue (no-op when batching is off)."""
        if self._wb is not None:
            self._wb.flush()

    # -------------------------------------------------------------- protocol
    def create_experiment(self, req: CreateExperiment) -> CreateResponse:
        self.flush()
        return CreateResponse.from_json(
            self._call("POST", "/v1/experiments", req.to_json()))

    def suggest(self, exp_id: str, count: int = 1) -> SuggestBatch:
        self.flush()
        return SuggestBatch.from_json(
            self._call("POST", f"/v1/experiments/{exp_id}/suggestions",
                       {"count": count}, idempotent=False))

    def observe(self, req: ObserveRequest) -> ObserveResponse:
        if self._wb is not None:
            # fire-and-forget: the synthetic ack stands in for the wire
            # response; duplicates are resolved server-side on flush
            self._wb.enqueue(OP_OBSERVE, req.to_json())
            return ObserveResponse(accepted=True, duplicate=False,
                                   observations=-1)
        return ObserveResponse.from_json(
            self._call("POST",
                       f"/v1/experiments/{req.exp_id}/observations",
                       req.to_json()))

    def report(self, req: ReportRequest) -> Decision:
        # idempotent in the ways that matter: a retried report appends a
        # duplicate metric line (harmless — rung recording dedupes by
        # trial), so the keep-alive retry path stays enabled.  Reuses the
        # persistent connection: the trial-events hot path pays no TCP
        # handshake per report.
        if self._wb is not None:
            stashed = self._gate.take_stashed(req)
            if stashed is not None:
                return stashed      # stop/pause that arrived on a batch
            if not self._gate.blocking(req):
                self._wb.enqueue(OP_REPORT, req.to_json())
                return self._gate.ride_decision(req)
            self._wb.flush()        # ordering: queued ops land first
        d = Decision.from_json(
            self._call("POST",
                       f"/v1/experiments/{req.exp_id}/trials"
                       f"/{req.trial_id or req.suggestion_id}/report",
                       req.to_json()))
        if self._gate is not None:
            self._gate.note(self._gate.key(req), d)
            self._gate.take_stashed(req)    # delivered directly: unstash
        return d

    def release(self, exp_id: str, suggestion_id: str) -> bool:
        if self._wb is not None:
            self._wb.enqueue(OP_RELEASE,
                             {"exp_id": exp_id,
                              "suggestion_id": suggestion_id})
            return True
        resp = self._call("POST", f"/v1/experiments/{exp_id}/release",
                          {"suggestion_id": suggestion_id})
        return ReleaseResponse.from_json(resp).released

    def requeue(self, exp_id: str, suggestion_id: str,
                assignment: Optional[dict] = None) -> bool:
        self.flush()
        resp = self._call("POST", f"/v1/experiments/{exp_id}/requeue",
                          {"suggestion_id": suggestion_id,
                           "assignment": assignment})
        return bool(resp.get("requeued", False))

    def drain(self, exp_id: str) -> DrainResponse:
        """Quiesce the experiment on the serving shard ahead of a
        handover (``POST .../drain``) — fleet rebalance control plane."""
        self.flush()
        return DrainResponse.from_json(
            self._call("POST", f"/v1/experiments/{exp_id}/drain", {}))

    def load(self) -> dict:
        """Shard saturation snapshot (``GET /v1/load``) — consumed by the
        fleet manager's admission/probe loop."""
        return self._call("GET", "/v1/load")

    def status(self, exp_id: str) -> StatusResponse:
        self.flush()
        resp = StatusResponse.from_json(
            self._call("GET", f"/v1/experiments/{exp_id}"))
        # additive client-side view: this client's transport retry
        # counters ride along so harnesses can assert retry behavior
        with self._stats_lock:
            resp.transport = dict(self.stats)
        if self._wb is not None:
            resp.transport["batch"] = dict(self._wb.stats)
            resp.transport["batch"]["depth"] = self._wb.depth()
        return resp

    def stop(self, exp_id: str, state: str = "stopped") -> StatusResponse:
        self.flush()
        return StatusResponse.from_json(
            self._call("POST", f"/v1/experiments/{exp_id}/stop",
                       {"state": state}))

    def best_response(self, exp_id: str) -> BestResponse:
        self.flush()
        return BestResponse.from_json(
            self._call("GET", f"/v1/experiments/{exp_id}/best"))

    def healthz(self) -> dict:
        return self._call("GET", "/v1/healthz")
