"""The port's HTTP transport (``repro_torch.api.http``) against the JAX
package's (``repro.api.http``), the port's service on ``device="cpu"``.

Parity is on the wire: a scripted request sequence sent raw over
``http.client`` to a reference ``ApiServer`` and a port ``ApiServer``
gets equal JSON back, apart from the fields listed in ``MASKED`` (they
depend on time or load); either package's ``HTTPClient`` drives either
package's server to a completed budget; and the reference's
deterministic HTTP cases (``tests/test_api.py``, the transport counters
of ``tests/test_fleet.py``) run over both packages.

``pkg(name)`` also serves ``test_torch_transport.py`` and
``test_torch_fleet.py``: it names each package's entry points, with the
port's services pinned to the CPU."""
import http.client
import json
import re
import tempfile
import threading
import types
import urllib.parse

import pytest

PACKAGES = ("reference", "port")


def pkg(name: str) -> types.SimpleNamespace:
    """One package's entry points; the port's on ``device="cpu"``."""
    if name == "reference":
        import repro.api.http as http_mod
        import repro.api.local as local_mod
        import repro.api.protocol as protocol
        import repro.api.transport as transport
        import repro.core as core
        import repro.core.faults as faults
        import repro.core.store as store_mod
        import repro.fleet as fleet
        dev = {}
    else:
        import repro_torch.api.http as http_mod
        import repro_torch.api.local as local_mod
        import repro_torch.api.protocol as protocol
        import repro_torch.api.transport as transport
        import repro_torch.core as core
        import repro_torch.core.faults as faults
        import repro_torch.core.store as store_mod
        import repro_torch.fleet as fleet
        dev = {"device": "cpu"}
    return types.SimpleNamespace(
        name=name, protocol=protocol, transport=transport, faults=faults,
        fleet=fleet, Store=store_mod.Store,
        ExperimentConfig=core.ExperimentConfig, Param=core.Param,
        Space=core.Space, Resources=core.Resources,
        HTTPClient=http_mod.HTTPClient, FleetClient=fleet.FleetClient,
        FleetManager=fleet.FleetManager, HashRing=fleet.HashRing,
        WorkerRegistry=fleet.WorkerRegistry,
        LocalClient=lambda root: local_mod.LocalClient(root, **dev),
        serve_api=lambda store, **kw: http_mod.serve_api(store, **dev, **kw),
        serve_fleet=lambda store, **kw: fleet.serve_fleet(store, **dev,
                                                          **kw),
        Orchestrator=lambda root, **kw: core.Orchestrator(root, **dev, **kw))


def cfg_json(p, name, budget=6, **kw):
    kw.setdefault("optimizer", "random")
    kw.setdefault("space", p.Space([p.Param("x", "double", 0, 1)]))
    return dict(p.ExperimentConfig(name=name, budget=budget, **kw).to_json())


@pytest.fixture(params=PACKAGES)
def p(request):
    return pkg(request.param)


# ------------------------------------------------------------- wire bytes
#: response fields that depend on time or load, by dotted path: the
#: process-wide fit executor's state, which earlier work in the same
#: process sets; every other byte of every response must be equal
MASKED = {
    "load.duty",            # the executor's busy share over wall time
    "load.backlog",         # its queue at the instant
    "load.executor",        # its counters (null before its first job)
}


#: per-incarnation random token inside every suggestion id
#: (``s<nonce>-<seq>``, ``api/local.py next_suggestion_id``): replaced by
#: one placeholder in every response before the bytes are compared
NONCE = re.compile(rb'"s([0-9a-f]{6})-')


def _mask(obj, path: str):
    if isinstance(obj, dict):
        return {k: ("<masked>" if f"{path}.{k}" in MASKED
                    else _mask(v, f"{path}.{k}")) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_mask(v, path) for v in obj]
    return obj


def _script(url: str):
    """The scripted sequence, raw over one keep-alive connection:
    (label, status, body bytes) per request."""
    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port, timeout=30)
    out = []

    def call(label, method, path, body=None, raw=None):
        data = raw if raw is not None else (
            json.dumps(body).encode() if body is not None else None)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        payload = r.read()
        out.append((label, r.status, payload))
        return json.loads(payload)

    ex = "/v1/experiments/exp-wire"
    call("healthz", "GET", "/v1/healthz")
    call("create", "POST", "/v1/experiments", {
        "config": {"name": "wire", "budget": 5, "parallel": 3,
                   "optimizer": "random", "seed": 0,
                   "space": [{"name": "x", "type": "double",
                              "bounds": [0, 1]},
                             {"name": "n", "type": "int",
                              "bounds": [1, 9]}]},
        "exp_id": "exp-wire"})
    s = call("suggest", "POST", f"{ex}/suggestions", {"count": 3})
    s1, s2, s3 = s["suggestions"]
    call("observe", "POST", f"{ex}/observations", {
        "suggestion_id": s1["suggestion_id"], "assignment": s1["assignment"],
        "value": 0.25, "trial_id": "t1"})
    call("observe-duplicate", "POST", f"{ex}/observations", {
        "suggestion_id": s1["suggestion_id"], "assignment": s1["assignment"],
        "value": 0.5, "trial_id": "t1-spec"})
    call("report", "POST", f"{ex}/trials/t2/report", {
        "step": 1, "value": 0.5, "suggestion_id": s2["suggestion_id"]})
    batch = {"batch_id": "b-wire-1", "ops": [
        {"seq": 0, "op": "observe", "payload": {
            "exp_id": "exp-wire", "suggestion_id": s2["suggestion_id"],
            "assignment": s2["assignment"], "value": 0.75}},
        {"seq": 1, "op": "report", "payload": {
            "exp_id": "exp-wire", "trial_id": "t3", "step": 2,
            "value": 0.1, "suggestion_id": s3["suggestion_id"]}},
        {"seq": 2, "op": "release", "payload": {
            "exp_id": "exp-wire", "suggestion_id": s3["suggestion_id"]}}]}
    call("batch", "POST", "/v1/batch", batch)
    call("batch-replay", "POST", "/v1/batch", batch)
    call("suggest-rest", "POST", f"{ex}/suggestions", {"count": 5})
    call("status", "GET", ex)
    call("best", "GET", f"{ex}/best")
    call("load", "GET", "/v1/load")
    call("404-unknown", "POST", "/v1/experiments/nope/suggestions",
         {"count": 1})
    call("400-route", "POST", f"{ex}/bogus", {})
    call("400-count", "POST", f"{ex}/suggestions", {"count": -1})
    call("400-json", "POST", f"{ex}/observations", raw=b"{not json")
    call("400-no-config", "POST", "/v1/experiments", {})
    call("400-batch-id", "POST", "/v1/batch", {"ops": []})
    call("400-report", "POST", f"{ex}/trials/t2/report", {"step": 2})
    call("400-observe", "POST", f"{ex}/observations",
         {"suggestion_id": "s-x", "value": 1.0})
    call("stop", "POST", f"{ex}/stop", {"state": "stopped"})
    conn.close()
    return out


def test_scripted_requests_get_equal_json_from_both_servers():
    got = {}
    for name in PACKAGES:
        server = pkg(name).serve_api(tempfile.mkdtemp()).start()
        try:
            got[name] = _script(server.url)
        finally:
            server.shutdown()
    for name, out in got.items():
        nonces = {m for _, _, body in out for m in NONCE.findall(body)}
        assert len(nonces) == 1, nonces        # one service incarnation
        nonce = nonces.pop()
        got[name] = [(label, status, body.replace(b'"s' + nonce + b"-",
                                                  b'"s<nonce>-'))
                     for label, status, body in out]
    ref, port = got["reference"], got["port"]
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    statuses = {label: status for label, status, _ in ref}
    assert statuses["404-unknown"] == 404
    assert all(v == 400 for k, v in statuses.items() if k.startswith("400"))
    assert all(v == 200 for k, v in statuses.items()
               if not k[:3].isdigit())
    for (label, _, want), (_, _, have) in zip(ref, port):
        w, h = json.loads(want), json.loads(have)
        if any(m.startswith(f"{label}.") for m in MASKED):
            assert set(h) == set(w), label
            w, h = _mask(w, label), _mask(h, label)
            assert w == h, label
        else:
            assert have == want, (label, have, want)


# ----------------------------------------------- clients across packages
@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("reference", "port"), ("port", "reference"), ("port", "port")])
def test_http_client_drives_server_to_completed_budget(client_pkg,
                                                       server_pkg):
    """The paper's bare worker loop (suggest, evaluate, observe) with one
    package's ``HTTPClient`` against the other's server."""
    c, s = pkg(client_pkg), pkg(server_pkg)
    server = s.serve_api(tempfile.mkdtemp()).start()
    try:
        client = c.HTTPClient(server.url)
        assert client.healthz()["ok"]
        exp = client.create_experiment(c.protocol.CreateExperiment(
            config=cfg_json(c, "http", budget=10))).exp_id
        seen = set()
        for _ in range(100):
            batch = client.suggest(exp, 2)
            if not batch.suggestions:
                break
            for sg in batch.suggestions:
                assert sg.suggestion_id not in seen, "duplicate suggestion"
                seen.add(sg.suggestion_id)
                client.observe(c.protocol.ObserveRequest(
                    exp, sg.suggestion_id, sg.assignment,
                    value=-(sg.assignment["x"] - 0.25) ** 2))
        st = client.status(exp)
        assert st.observations == 10 and st.pending == 0
        assert st.state == "complete" and len(seen) == 10
        assert client.best(exp) is not None
        assert len(server.backend.store.load_observations(exp)) == 10
        client.close()
    finally:
        server.shutdown()


@pytest.mark.parametrize("client_pkg,server_pkg", [
    ("reference", "port"), ("port", "reference")])
def test_batched_client_across_packages(client_pkg, server_pkg):
    """The write-behind plane across packages: riding observes and
    reports land once, in order, and a replayed batch is not reapplied."""
    c, s = pkg(client_pkg), pkg(server_pkg)
    root = tempfile.mkdtemp()
    server = s.serve_api(root).start()
    client = c.HTTPClient(server.url, batch=True, batch_deadline=60.0)
    try:
        exp = client.create_experiment(c.protocol.CreateExperiment(
            config=cfg_json(c, "wb", budget=8))).exp_id
        got = client.suggest(exp, 4).suggestions
        client.report(c.protocol.ReportRequest(exp, "t0", 1, 0.1))
        for step in range(2, 6):
            client.report(c.protocol.ReportRequest(exp, "t0", step, 0.1))
        for sg in got:
            client.observe(c.protocol.ObserveRequest(
                exp, sg.suggestion_id, sg.assignment, value=0.5))
        client.flush()
        assert client._wb.stats["op_errors"] == 0
        st = client.status(exp)
        assert st.observations == 4 and st.pending == 0
        steps = [r["step"] for r in s.Store(root).load_metrics(exp)]
        assert steps == [1, 2, 3, 4, 5]
    finally:
        client.close()
        server.shutdown()


# ------------------------------------------------ the reference's HTTP cases
def test_scheduler_drives_remote_service(p):
    server = p.serve_api(tempfile.mkdtemp()).start()
    try:
        orch = p.Orchestrator(tempfile.mkdtemp())   # worker-local store
        cfg = p.ExperimentConfig.from_json(
            cfg_json(p, "remote", budget=6, parallel=2))
        exp = orch.run(cfg, trial_fn=lambda a, ctx: a["x"],
                       service=server.url)
        st = orch.status(exp)
        assert st["observations"] == 6 and st["state"] == "complete"
        # the observation log lives on the service; logs with the worker
        assert len(server.backend.store.load_observations(exp)) == 6
        assert orch.store.load_observations(exp) == []
        assert list(orch.store.iter_logs(exp))
    finally:
        server.shutdown()


def test_two_schedulers_share_one_http_experiment(p):
    """Several workers drive ONE experiment through the service; the
    budget is honoured globally."""
    server = p.serve_api(tempfile.mkdtemp()).start()
    try:
        client = p.HTTPClient(server.url)
        cfg = p.ExperimentConfig.from_json(
            cfg_json(p, "shared", budget=12, parallel=2))
        exp = client.create_experiment(p.protocol.CreateExperiment(
            config=cfg.to_json())).exp_id
        errors = []

        def run_worker():
            try:
                p.Orchestrator(tempfile.mkdtemp()).run(
                    cfg, trial_fn=lambda a, ctx: a["x"], exp_id=exp,
                    service=server.url)
            except Exception as e:     # asserted below, after the join
                errors.append(e)

        workers = [threading.Thread(target=run_worker) for _ in range(2)]
        for t in workers:
            t.start()
        for t in workers:
            t.join(60)
        assert not any(t.is_alive() for t in workers) and not errors
        st = client.status(exp)
        assert st.observations == 12 and st.pending == 0
        assert len(server.backend.store.load_observations(exp)) == 12
    finally:
        server.shutdown()


def test_http_error_codes_over_the_wire(p):
    server = p.serve_api(tempfile.mkdtemp()).start()
    try:
        client = p.HTTPClient(server.url)
        ApiError = p.protocol.ApiError
        with pytest.raises(ApiError) as ei:
            client.suggest("missing", 1)
        assert ei.value.code == "unknown_experiment"
        with pytest.raises(ApiError) as ei:
            client._call("POST", "/v1/experiments/x/bogus", {})
        assert ei.value.code == "bad_request"
        with pytest.raises(ApiError) as ei:
            client._call("POST", "/v1/experiments", {})   # no config
        assert ei.value.code == "bad_request"
    finally:
        server.shutdown()


def test_http_client_backoff_counters_on_refused_connect(p):
    """Bounded full-jitter backoff: a refused connect retries up to
    ``retry_attempts`` times for any verb, then surfaces ``service
    unreachable``; every step lands in the client's counters."""
    c = p.HTTPClient("http://127.0.0.1:9", retry_attempts=3,
                     retry_base=0.001, retry_cap=0.002, retry_seed=0)
    with pytest.raises(p.protocol.ApiError) as ei:
        c.load()
    assert ei.value.code == p.protocol.E_INTERNAL
    assert "unreachable" in str(ei.value)
    assert c.stats["refused"] == 3 and c.stats["backoffs"] == 2
    assert c.stats["gave_up"] == 1
    with pytest.raises(p.protocol.ApiError):
        c.suggest("exp-x", 1)
    assert c.stats["refused"] == 6 and c.stats["gave_up"] == 2
    c.close()


def test_http_status_carries_transport_counters(p):
    srv = p.serve_api(tempfile.mkdtemp()).start()
    try:
        c = p.HTTPClient(srv.url, retry_seed=0)
        eid = c.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, "transport", budget=2))).exp_id
        st = c.status(eid)
        assert {"retries", "backoffs", "backoff_ms", "refused",
                "gave_up"} <= set(st.transport)
        assert st.transport["gave_up"] == 0
        c.close()
    finally:
        srv.shutdown()


def test_fault_gate_partition_reaches_the_retry_path():
    """``HTTPClient.fault_gate`` takes the port's ``FaultPlan.edge_gate``:
    an injected partition is a refused connect, retried and counted."""
    p = pkg("port")
    srv = p.serve_api(tempfile.mkdtemp()).start()
    try:
        plan = p.faults.FaultPlan(seed=0)
        plan.partition("w-0", "shard-0", at=0)
        plan.tick()
        c = p.HTTPClient(srv.url, retry_attempts=2, retry_base=0.001,
                         retry_cap=0.001,
                         fault_gate=plan.edge_gate("w-0", "shard-0"))
        with pytest.raises(p.protocol.ApiError, match="unreachable"):
            c.healthz()
        assert c.stats["refused"] == 2 and c.stats["gave_up"] == 1
        c.close()
    finally:
        srv.shutdown()
