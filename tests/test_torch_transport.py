"""The write-behind transport plane (``api/transport.py``) of both
packages: ``WriteBehind``'s size and deadline triggers under a fake
clock, its synchronous flush and failure accounting, ``DecisionGate``,
and the reference's transport cases (``tests/test_transport.py``: replay
after a mid-response kill, per-experiment order, the rung gate, fenced
batches, one lane per shard), each run over the JAX package and the port
(its service on ``device="cpu"``)."""
import tempfile
import threading
import time
import types

import pytest

from test_torch_http import PACKAGES, cfg_json, pkg

#: how long a test waits for the flusher thread before it fails
WAIT_S = 5.0


@pytest.fixture(params=PACKAGES)
def p(request):
    return pkg(request.param)


class FakeClock:
    """``time.monotonic`` for the transport module, moved by the test."""

    def __init__(self, now: float = 100.0):
        self.now = now

    def monotonic(self) -> float:
        return self.now


class Recorder:
    """A ``WriteBehind`` send: records (lane, batch) and answers every op
    ok, or fails the whole batch when ``fail`` is set."""

    def __init__(self, protocol, fail=None):
        self.protocol, self.fail = protocol, fail
        self.sent = []
        self.shipped = threading.Event()

    def __call__(self, lane, req):
        if self.fail is not None:
            raise self.fail
        self.sent.append((lane, req))
        self.shipped.set()
        pr = self.protocol
        return pr.BatchResponse(req.batch_id, [
            pr.BatchOpResult.success(op.seq, {"accepted": True})
            for op in req.ops])


def _fake_clock(monkeypatch, p) -> FakeClock:
    clock = FakeClock()
    monkeypatch.setattr(p.transport, "time",
                        types.SimpleNamespace(monotonic=clock.monotonic))
    return clock


# ----------------------------------------------------- WriteBehind, alone
def test_write_behind_size_trigger_ships_a_full_lane(p, monkeypatch):
    _fake_clock(monkeypatch, p)         # frozen: no op ever ages
    send = Recorder(p.protocol)
    wb = p.transport.WriteBehind(send, max_ops=3, deadline=1.0)
    try:
        for i in range(2):
            wb.enqueue("observe", {"exp_id": "e", "i": i}, lane="A")
        time.sleep(0.1)
        assert send.sent == [] and wb.depth("A") == 2
        wb.enqueue("observe", {"exp_id": "e", "i": 2}, lane="A")
        assert send.shipped.wait(WAIT_S), "a full lane was not shipped"
        (lane, req), = send.sent
        assert lane == "A" and req.batch_id.endswith("-1")
        assert [(o.seq, o.op, o.payload["i"]) for o in req.ops] == \
            [(0, "observe", 0), (1, "observe", 1), (2, "observe", 2)]
        assert wb.depth() == 0
        assert wb.stats["batches"] == 1 and wb.stats["ops"] == 3
    finally:
        wb.close()


def test_write_behind_deadline_trigger_follows_the_clock(p, monkeypatch):
    clock = _fake_clock(monkeypatch, p)
    send = Recorder(p.protocol)
    wb = p.transport.WriteBehind(send, max_ops=64, deadline=0.010)
    try:
        wb.enqueue("release", {"exp_id": "e1"}, lane="A")
        wb.enqueue("release", {"exp_id": "e2"}, lane="B")
        time.sleep(0.1)                 # real time passes, the clock not
        assert send.sent == [] and wb.depth() == 2
        clock.now += 0.011              # both oldest ops past the deadline
        deadline = time.monotonic() + WAIT_S
        while len(send.sent) < 2 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sorted(lane for lane, _ in send.sent) == ["A", "B"]
        assert all(len(req.ops) == 1 for _, req in send.sent)
    finally:
        wb.close()


def test_write_behind_flush_close_and_failure_accounting(p, monkeypatch):
    _fake_clock(monkeypatch, p)
    ApiError = p.protocol.ApiError
    send = Recorder(p.protocol)
    wb = p.transport.WriteBehind(send, max_ops=2, deadline=60.0)
    for i in range(5):
        wb.enqueue("observe", {"exp_id": "e", "i": i}, lane=i % 2)
    wb.flush()                          # synchronous: every lane drained
    assert wb.depth() == 0
    shipped = sorted(o.payload["i"] for _, req in send.sent for o in req.ops)
    assert shipped == [0, 1, 2, 3, 4]
    assert all(len(req.ops) <= 2 for _, req in send.sent)

    # a whole batch that never got an answer: each op is an op error
    send.fail = OSError("wire down")
    wb.enqueue("observe", {"exp_id": "e-lost"}, lane="A")
    wb.flush("A")
    assert wb.stats["send_failures"] == 1 and wb.stats["op_errors"] == 1
    assert wb.op_errors[-1]["exp_id"] == "e-lost"
    assert wb.op_errors[-1]["code"] == p.protocol.E_INTERNAL
    wb.close()
    with pytest.raises(ApiError):
        wb.enqueue("observe", {"exp_id": "e"})

    # a per-op failure the owner's hook handles is not counted
    handled = []

    def send_err(lane, req):
        pr = p.protocol
        return pr.BatchResponse(req.batch_id, [
            pr.BatchOpResult.failure(op.seq, ApiError(pr.E_WRONG_SHARD, "x"))
            for op in req.ops])

    def on_result(lane, op, result, err):
        handled.append(err.code)
        return op.payload.get("mine", False)

    wb2 = p.transport.WriteBehind(send_err, on_result=on_result)
    wb2.enqueue("observe", {"exp_id": "e", "mine": True})
    wb2.enqueue("observe", {"exp_id": "e"})
    wb2.close()
    assert handled == [p.protocol.E_WRONG_SHARD] * 2
    assert wb2.stats["op_errors"] == 1


def test_decision_gate_blocks_only_at_unknown_or_crossing_rungs(p):
    pr = p.protocol
    gate = p.transport.DecisionGate()
    req = pr.ReportRequest("e", "t0", 1, 0.5)
    assert gate.blocking(req)                       # rung unknown
    gate.note(gate.key(req), pr.Decision(pr.DECISION_CONTINUE,
                                         next_rung=3, seq=7))
    assert not gate.blocking(pr.ReportRequest("e", "t0", 2, 0.5))
    assert gate.blocking(pr.ReportRequest("e", "t0", 3, 0.5))
    ride = gate.ride_decision(pr.ReportRequest("e", "t0", 2, 0.5))
    assert (ride.decision, ride.next_rung, ride.seq) == ("continue", 3, 0)
    # no early stopping: never blocks after the first report
    other = pr.ReportRequest("e", "t1", 1, 0.5)
    gate.note(gate.key(other), pr.Decision(pr.DECISION_CONTINUE, None, 1))
    assert not gate.blocking(pr.ReportRequest("e", "t1", 10 ** 6, 0.5))
    # a stop arriving on a batched result is delivered once, next report
    gate.note(gate.key(req), pr.Decision(pr.DECISION_STOP, None, 9))
    assert gate.take_stashed(req).decision == pr.DECISION_STOP
    assert gate.take_stashed(req) is None
    # bounded: the oldest trial keys are evicted
    for i in range(gate.MAX_TRIALS + 5):
        gate.note(("e", f"k{i}"), pr.Decision(pr.DECISION_CONTINUE, 2, i))
    assert len(gate._rungs) == gate.MAX_TRIALS
    assert gate.blocking(req)                       # evicted: unknown again


def test_flush_constants_match_the_reference():
    import repro.api.transport as ref
    import repro_torch.api.transport as port
    assert (port.FLUSH_MAX_OPS, port.FLUSH_DEADLINE_S, port.MAX_OP_ERRORS) \
        == (ref.FLUSH_MAX_OPS, ref.FLUSH_DEADLINE_S, ref.MAX_OP_ERRORS)
    assert (port.OP_OBSERVE, port.OP_REPORT, port.OP_RELEASE,
            port.OP_REQUEUE) == (ref.OP_OBSERVE, ref.OP_REPORT,
                                 ref.OP_RELEASE, ref.OP_REQUEUE)


# ------------------------------------------- the reference's transport cases
def test_batch_replay_after_mid_response_kill_applies_exactly_once(p):
    """The connection dies after the server applied the batch and before
    the client read the answer: the idempotent resend hits the dedupe
    window and replays instead of applying twice."""
    root = tempfile.mkdtemp()
    server = p.serve_api(root).start()
    client = p.HTTPClient(server.url, batch=True, batch_deadline=60.0,
                          retry_seed=0)
    try:
        exp = client.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, "replay", budget=64))).exp_id
        client.status(exp)              # this thread's keep-alive conn
        conn = client._local.conn
        real = conn.getresponse
        armed = [True]

        def mid_response_kill():
            if armed[0]:
                armed[0] = False
                r = real()
                r.read(1)
                raise OSError("injected mid-response connection kill")
            return real()

        conn.getresponse = mid_response_kill
        n = 6
        for j in range(n):
            client.observe(p.protocol.ObserveRequest(
                exp, f"sid-{j:03d}", {"x": 0.5}, value=float(j)))
        client.flush()
        assert not armed[0], "injected fault never fired"
        assert client._wb.stats["replayed"] == 1
        assert client._wb.stats["batches"] == 1
        assert client._wb.stats["op_errors"] == 0
        records = p.Store(root).load_observation_records(exp)
        assert len(records) == n, "a replayed batch must not double-apply"
        assert len({r["suggestion_id"] for r in records}) == n
        assert client.status(exp).observations == n
    finally:
        client.close()
        server.shutdown()


def test_per_experiment_op_order_survives_interleaved_flushes(p):
    root = tempfile.mkdtemp()
    server = p.serve_api(root).start()
    client = p.HTTPClient(server.url, batch=True, batch_max=4,
                          batch_deadline=60.0)
    try:
        exps = [client.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, f"order-{i}", budget=64))).exp_id
            for i in range(2)]
        for e in exps:
            client.report(p.protocol.ReportRequest(e, "t0", 1, 0.1))
        for step in range(2, 14):
            for e in exps:
                client.report(p.protocol.ReportRequest(e, "t0", step,
                                                       step / 100.0))
        client.flush()
        assert client._wb.stats["batches"] >= 3
        for e in exps:
            recs = p.Store(root).load_metrics(e)
            steps = [r["step"] for r in recs]
            assert steps == sorted(steps) == list(range(1, 14))
            seqs = [r["seq"] for r in recs]
            assert seqs == sorted(seqs)
    finally:
        client.close()
        server.shutdown()


def test_rung_crossing_report_blocks_while_below_rung_reports_ride(p):
    root = tempfile.mkdtemp()
    server = p.serve_api(root).start()
    client = p.HTTPClient(server.url, batch=True, batch_deadline=60.0)
    try:
        exp = client.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, "gate", budget=64,
                            early_stop={"min_steps": 1, "eta": 3}))).exp_id
        d1 = client.report(p.protocol.ReportRequest(exp, "t0", 1, 0.5))
        assert d1.seq != 0
        nr = d1.next_rung
        assert nr is not None and nr > 1
        for step in range(2, nr):
            d = client.report(p.protocol.ReportRequest(exp, "t0", step, 0.5))
            assert d.seq == 0 and d.decision == "continue"
        assert client._wb.depth() == max(0, nr - 2)
        dr = client.report(p.protocol.ReportRequest(exp, "t0", nr, 0.5))
        assert dr.seq != 0
        assert client._wb.depth() == 0
        recs = p.Store(root).load_metrics(exp)
        assert [r["step"] for r in recs] == list(range(1, nr + 1))
    finally:
        client.close()
        server.shutdown()


def test_fenced_zombie_batch_rejected_item_by_item_with_zero_log_entries(p):
    pr = p.protocol
    root = tempfile.mkdtemp()
    zombie = p.LocalClient(root)
    eid = zombie.create_experiment(pr.CreateExperiment(
        config=cfg_json(p, "fence-batch", budget=6),
        exp_id="exp-fence-batch", epoch=[1, 1])).exp_id
    held = zombie.suggest(eid, 2).suggestions
    owner = p.LocalClient(root)
    owner.create_experiment(pr.CreateExperiment(config={}, exp_id=eid,
                                                epoch=[1, 2]))
    req = pr.BatchRequest("bz-fence-1", [
        pr.BatchOp(0, "observe", pr.ObserveRequest(
            eid, held[0].suggestion_id, held[0].assignment,
            value=0.9).to_json()),
        pr.BatchOp(1, "report", pr.ReportRequest(eid, "t0", 1,
                                                 0.9).to_json()),
        pr.BatchOp(2, "observe", pr.ObserveRequest(
            eid, held[1].suggestion_id, held[1].assignment,
            value=0.8).to_json()),
        pr.BatchOp(3, "release", {"exp_id": eid,
                                  "suggestion_id": held[1].suggestion_id}),
    ])
    resp = zombie.apply_batch(req)
    assert len(resp.results) == 4
    for r in resp.results:
        assert not r.ok and r.error["code"] == pr.E_FENCED
    assert owner.store.load_observation_records(eid) == []
    assert owner.store.load_metrics(eid) == []
    again = zombie.apply_batch(req)
    assert again.replayed
    assert [r.error["code"] for r in again.results] == [pr.E_FENCED] * 4


def test_fleet_client_keeps_one_lane_per_shard_and_rehomes_wrong_shard(p):
    pr = p.protocol
    root = tempfile.mkdtemp()
    manager = p.FleetManager()
    for i in range(2):
        manager.add_shard(p.LocalClient(root), shard_id=f"shard-{i}")
    client = p.FleetClient(manager, heartbeat=False, batch=True,
                           batch_deadline=60.0)
    try:
        ring = manager.ring
        moved = next(f"exp-lane-{i:03d}" for i in range(256)
                     if ring.moved_by_adding("shard-late",
                                             [f"exp-lane-{i:03d}"]))
        kept = next(f"exp-keep-{i:03d}" for i in range(256)
                    if ring.owner(f"exp-keep-{i:03d}") != ring.owner(moved)
                    and not ring.moved_by_adding("shard-late",
                                                 [f"exp-keep-{i:03d}"]))
        eids, owners = [moved, kept], {ring.owner(moved), ring.owner(kept)}
        sugg = {}
        for eid in eids:
            client.create_experiment(pr.CreateExperiment(
                config=cfg_json(p, eid, budget=8), exp_id=eid))
            sugg[eid] = client.suggest(eid, 1).suggestions[0]
        for eid in eids:
            s = sugg[eid]
            client.observe(pr.ObserveRequest(eid, s.suggestion_id,
                                             s.assignment, value=0.5))
        with client._wb._cv:
            lanes = [lane for lane, q in client._wb._lanes.items() if q]
        assert sorted(lanes) == sorted(owners)
        client.flush()
        for eid in eids:
            assert client.status(eid).observations == 1
        assert client._holdings == {}

        sm = client.suggest(moved, 1).suggestions[0]
        sk = client.suggest(kept, 1).suggestions[0]
        client.observe(pr.ObserveRequest(moved, sm.suggestion_id,
                                         sm.assignment, value=0.7))
        client.observe(pr.ObserveRequest(kept, sk.suggestion_id,
                                         sk.assignment, value=0.7))
        manager.add_shard(p.LocalClient(root), shard_id="shard-late")
        client.flush()      # stale lane -> wrong_shard -> re-home -> apply
        assert client.status(moved).observations == 2
        assert client.status(kept).observations == 2
        assert client._wb.stats["op_errors"] == 0
        assert client._holdings == {}
        assert client._owner(moved) == "shard-late"
    finally:
        client.close()
