"""The port's fleet (``repro_torch.fleet``) against the JAX package's.

``HashRing`` gives the reference's owner for every key and moves the
same keys on add and remove; the reference's deterministic fleet cases
(``tests/test_fleet.py`` but its kill −9 shard chaos test, and the
fencing and rebalance cases of ``tests/test_fencing.py``) run over both
packages, the port's shards on ``device="cpu"``; a reference
``FleetClient`` drives a port fleet and the other way round; and a
store written by a reference fleet is adopted by a port fleet exactly
once.  Every wait has a deadline."""
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from test_torch_http import PACKAGES, cfg_json, pkg

SRC = str(pathlib.Path(__file__).resolve().parent.parent / "src")


@pytest.fixture(params=PACKAGES)
def p(request):
    return pkg(request.param)


def _inproc_fleet(p, n=3, root=None, **kw):
    """Manager over n in-process LocalClient shards sharing one store."""
    root = root or tempfile.mkdtemp()
    manager = p.FleetManager(**kw)
    for i in range(n):
        manager.add_shard(p.LocalClient(root), shard_id=f"shard-{i}")
    return manager, root


def _wait(cond, what: str, timeout: float = 10.0) -> None:
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting: {what}"
        time.sleep(0.05)


def _drive(client, protocol, eid, budget, value=0.5, timeout=30.0):
    """Suggest and observe until ``eid`` has its budget; returns the
    suggestion ids served (each must be new)."""
    seen = set()
    deadline = time.monotonic() + timeout
    while client.status(eid).observations < budget:
        assert time.monotonic() < deadline, f"{eid} never completed"
        for s in client.suggest(eid, 4).suggestions:
            assert s.suggestion_id not in seen, "id served twice"
            seen.add(s.suggestion_id)
            r = client.observe(protocol.ObserveRequest(
                eid, s.suggestion_id, s.assignment, value=value))
            assert r.accepted and not r.duplicate
    return seen


# ------------------------------------------------------------------ hashring
@pytest.mark.parametrize("n", [3, 5])
def test_hashring_owner_and_moved_sets_match_the_reference(n):
    ref, port = pkg("reference").HashRing, pkg("port").HashRing
    nodes = [f"shard-{i}" for i in range(n)]
    keys = [f"exp-{i:04d}" for i in range(1000)]
    r, q = ref(nodes), port(nodes)
    assert [q.owner(k) for k in keys] == [r.owner(k) for k in keys]
    assert q.spread(keys) == r.spread(keys)
    assert q.moved_by_adding("shard-new", keys) == \
        r.moved_by_adding("shard-new", keys)
    for ring in (r, q):
        ring.add("shard-new")
    assert [q.owner(k) for k in keys] == [r.owner(k) for k in keys]
    for ring in (r, q):
        ring.remove("shard-1")
    assert [q.owner(k) for k in keys] == [r.owner(k) for k in keys]


def test_hashring_owner_is_stable_and_minimally_disrupted(p):
    keys = [f"exp-{i}" for i in range(200)]
    r1 = p.HashRing(["a", "b", "c"])
    r2 = p.HashRing(["a", "b", "c"])
    assert [r1.owner(k) for k in keys] == [r2.owner(k) for k in keys]
    before = {k: r1.owner(k) for k in keys}
    r1.remove("b")
    after = {k: r1.owner(k) for k in keys}
    moved = [k for k in keys if before[k] != after[k]]
    assert all(before[k] == "b" for k in moved)
    assert all(after[k] in ("a", "c") for k in keys)
    spread = p.HashRing(["a", "b", "c", "d"]).spread(keys)
    assert all(v > len(keys) / 16 for v in spread.values()), spread


def test_hashring_add_remove_roundtrip(p):
    ring = p.HashRing(["a", "b"])
    assert "a" in ring and len(ring) == 2
    ring.add("a")
    assert len(ring) == 2
    ring.remove("missing")
    ring.remove("a")
    assert "a" not in ring
    assert all(ring.owner(f"k{i}") == "b" for i in range(20))
    ring.remove("b")
    assert ring.owner("k") is None


# ------------------------------------------------------------------ registry
def test_registry_state_machine_with_fake_clock(p):
    F = p.fleet
    reg = p.WorkerRegistry(period=1.0)
    reg.register("w1", now=0.0)
    assert reg.state("w1") == F.S_REGISTERED
    assert reg.beat("w1", now=0.5) == F.S_ALIVE
    assert reg.sweep(now=1.0) == []
    assert reg.state("w1") == F.S_ALIVE
    reg.sweep(now=1.8)
    assert reg.state("w1") == F.S_SUSPECT
    assert reg.beat("w1", now=2.0) == F.S_ALIVE
    dead = reg.sweep(now=4.5)
    assert [r.worker_id for r in dead] == ["w1"]
    assert reg.state("w1") == F.S_DEAD
    assert reg.sweep(now=5.0) == []
    reg.get("w1").holdings = {"e": ["s1"]}
    rec = reg.register("w1", now=6.0)
    assert rec.state == F.S_REGISTERED and rec.holdings == {}


def test_registry_beat_autoregisters_and_carries_holdings(p):
    reg = p.WorkerRegistry(period=1.0)
    assert reg.beat("w9", holdings={"e1": ["sA", "sB"]}, now=0.0) == \
        p.fleet.S_ALIVE
    assert reg.get("w9").holdings == {"e1": ["sA", "sB"]}
    dead = reg.sweep(now=10.0)
    assert [r.worker_id for r in dead] == ["w9"]
    assert dead[0].holdings == {"e1": ["sA", "sB"]}


# ------------------------------------------------------------------- routing
def test_fleet_routes_and_spreads_experiments_across_shards(p):
    manager, _ = _inproc_fleet(p, 3)
    client = p.FleetClient(manager, heartbeat=False)
    owners = set()
    for i in range(8):
        eid = client.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, f"route-{i}", budget=2),
            exp_id=f"exp-route-{i:02d}")).exp_id
        owners.add(manager.owner_of(eid).shard_id)
        s = client.suggest(eid, 1).suggestions[0]
        assert client.observe(p.protocol.ObserveRequest(
            eid, s.suggestion_id, s.assignment, value=0.5)).accepted
        assert client.status(eid).observations == 1
    assert len(owners) > 1
    eid = "exp-route-00"
    owner = manager.owner_of(eid).shard_id
    for sid, handle in manager._shards.items():
        assert (eid in handle.client._exps) == (sid == owner)
    client.close()


def test_fleet_map_versioning_on_membership_change(p):
    manager, root = _inproc_fleet(p, 2)
    v0 = manager.shard_map().version
    manager.add_shard(p.LocalClient(root), shard_id="shard-late")
    m = manager.shard_map()
    assert m.version == v0 + 1 and "shard-late" in m.shards
    manager.remove_shard("shard-late")
    assert manager.shard_map().version == v0 + 2
    client = p.FleetClient(manager, heartbeat=False)
    assert client.map_version == v0 + 2
    client.close()


# ----------------------------------------------------------------- admission
def test_admission_redirects_create_away_from_saturated_owner(p):
    manager, _ = _inproc_fleet(p, 3, admit_backlog=4)
    exp_id = "exp-sat-1"
    owner = manager.owner_of(exp_id)
    owner.load = {"backlog": 9, "duty": 0.0, "live": 5}   # saturated
    client = p.FleetClient(manager, heartbeat=False)
    resp = client.create_experiment(p.protocol.CreateExperiment(
        config=cfg_json(p, "sat", budget=4), exp_id=exp_id))
    m = manager.shard_map()
    assert m.overrides.get(exp_id) not in (None, owner.shard_id)
    assert manager.stats["redirects"] == 1
    assert len(client.suggest(resp.exp_id, 1)) == 1
    target = manager._shards[m.overrides[exp_id]]
    assert exp_id in target.client._exps
    assert exp_id not in owner.client._exps
    client.close()


def test_admission_busy_when_every_shard_is_saturated(p):
    manager, _ = _inproc_fleet(p, 2, admit_duty=0.5)
    for handle in manager._shards.values():
        handle.load = {"backlog": 0, "duty": 0.9, "live": 4}
    with pytest.raises(p.protocol.ApiError) as ei:
        manager.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, "busy"), exp_id="exp-busy"))
    assert ei.value.code == p.protocol.E_FLEET_BUSY
    assert manager.stats["busy_rejections"] == 1
    assert all("exp-busy" not in h.client._exps
               for h in manager._shards.values())


def test_shard_load_probe_reports_executor_signal(p):
    manager, _ = _inproc_fleet(p, 1)
    handle = next(iter(manager._shards.values()))
    assert handle.probe()
    assert {"experiments", "live", "pending", "backlog", "duty"} \
        <= set(handle.load)


# --------------------------------------------------------------- fault paths
def test_dead_worker_holdings_requeued_and_served_exactly_once(p):
    manager, _ = _inproc_fleet(p, 2)
    client = p.FleetClient(manager, heartbeat=False)
    eid = client.create_experiment(p.protocol.CreateExperiment(
        config=cfg_json(p, "dw", budget=6), exp_id="exp-dw")).exp_id
    taken = {s.suggestion_id for s in client.suggest(eid, 3).suggestions}
    assert len(taken) == 3
    reg = manager.registry
    reg.beat("w-dead", holdings=client.holdings(), now=0.0)
    for rec in reg.sweep(now=10.0):
        manager._on_dead_worker(rec)
    assert manager.stats["requeued"] == 3
    survivor = p.FleetClient(manager, heartbeat=False)
    got = survivor.suggest(eid, 6)
    ids = [s.suggestion_id for s in got.suggestions]
    assert set(ids[:3]) == taken            # orphans first, same ids
    assert len(ids) == len(set(ids)) == 6
    assert len(survivor.suggest(eid, 6)) == 0
    for s in got.suggestions:
        r = survivor.observe(p.protocol.ObserveRequest(
            eid, s.suggestion_id, s.assignment, value=0.5))
        assert r.accepted and not r.duplicate
    st = survivor.status(eid)
    assert st.observations == 6 and st.pending == 0
    state = manager.owner_of(eid).client._exps[eid]
    assert state.pending == {}
    assert not getattr(state.optimizer, "_pending", {})
    client.close()
    survivor.close()


def test_requeue_tolerates_observed_and_unknown_suggestions(p):
    manager, _ = _inproc_fleet(p, 1)
    client = p.FleetClient(manager, heartbeat=False)
    eid = client.create_experiment(p.protocol.CreateExperiment(
        config=cfg_json(p, "rq", budget=3), exp_id="exp-rq")).exp_id
    s = client.suggest(eid, 1).suggestions[0]
    assert client.requeue(eid, s.suggestion_id) is True
    assert client.requeue(eid, s.suggestion_id) is True
    got = client.suggest(eid, 3)
    assert [x.suggestion_id for x in got.suggestions][0] == s.suggestion_id
    assert len({x.suggestion_id for x in got.suggestions}) == len(got)
    assert client.observe(p.protocol.ObserveRequest(
        eid, s.suggestion_id, s.assignment, value=1.0)).accepted
    assert client.requeue(eid, s.suggestion_id) is False
    assert client.requeue(eid, "s-never-existed") is False
    client.close()


def test_scheduler_crash_mid_report_through_router_leaves_no_orphans(p):
    manager, root = _inproc_fleet(p, 2)
    fleet_client = p.FleetClient(manager, heartbeat=False)
    orch = p.Orchestrator(root, client=fleet_client)

    def trial(a, ctx):
        ctx.report(1, a["x"])
        raise p.faults.InjectedCrash("mid-report crash")

    cfg = p.ExperimentConfig.from_json(cfg_json(
        p, "fleet-midreport", budget=4, parallel=2, max_retries=0))
    exp = orch.run(cfg, trial_fn=trial)
    for handle in manager._shards.values():
        state = handle.client._exps.get(exp)
        if state is None:
            continue
        assert state.pending == {}
        assert not getattr(state.optimizer, "_pending", {})
    obs = orch.store.load_observations(exp)
    assert len(obs) == 4 and all(o.failed for o in obs)
    assert fleet_client.holdings() == {}
    fleet_client.close()


def test_dead_shard_failover_adopts_from_shared_store_and_fences(p):
    """Shut a shard's listener: the manager drops it from the ring, the
    ring successor adopts the experiment out of the shared store at a new
    epoch, the router re-homes, and the old shard's late write (its
    service still holds the experiment) is fenced off the log."""
    root = tempfile.mkdtemp()
    srv = p.serve_fleet(root, shards=3, period=0.2).start()
    try:
        client = p.FleetClient(srv.url, heartbeat=True)
        eid = client.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, "failover", budget=8),
            exp_id="exp-failover")).exp_id
        pre = client.suggest(eid, 3)
        for s in pre.suggestions[:2]:
            assert client.observe(p.protocol.ObserveRequest(
                eid, s.suggestion_id, s.assignment, value=0.7)).accepted
        owner = srv.manager.owner_of(eid).shard_id
        victim = next(s for i, s in enumerate(srv.owned_shards)
                      if f"shard-{i}" == owner)
        victim._httpd.shutdown()
        victim._httpd.server_close()
        _wait(lambda: srv.manager.stats["dead_shards"] >= 1, "shard death")
        assert srv.manager.stats["dead_shards"] == 1
        assert owner not in srv.manager.shard_map().shards
        client.beat()
        post = client.suggest(eid, 2)
        assert len(post) == 2
        pre_ids = {s.suggestion_id for s in pre.suggestions}
        assert not (pre_ids & {s.suggestion_id for s in post.suggestions})
        for s in post.suggestions:
            r = client.observe(p.protocol.ObserveRequest(
                eid, s.suggestion_id, s.assignment, value=0.6))
            assert r.accepted and not r.duplicate
        late = pre.suggestions[2]
        with pytest.raises(p.protocol.ApiError) as ei:
            victim.backend.observe(p.protocol.ObserveRequest(
                eid, late.suggestion_id, late.assignment, value=0.1))
        assert ei.value.code == p.protocol.E_FENCED
        st = client.status(eid)
        assert st.observations == 4
        recs = p.Store(root).load_observation_records(eid)
        assert late.suggestion_id not in {r["suggestion_id"] for r in recs}
        client.close()
    finally:
        srv.shutdown()


def test_zombie_incarnation_fenced_after_higher_epoch_adoption(p):
    pr = p.protocol
    root = tempfile.mkdtemp()
    zombie = p.LocalClient(root)
    eid = zombie.create_experiment(pr.CreateExperiment(
        config=cfg_json(p, "fence", budget=6), exp_id="exp-fence",
        epoch=[1, 1])).exp_id
    held = zombie.suggest(eid, 2).suggestions
    owner = p.LocalClient(root)
    owner.create_experiment(pr.CreateExperiment(config={}, exp_id=eid,
                                                epoch=[1, 2]))
    for call in (lambda: zombie.observe(pr.ObserveRequest(
            eid, held[0].suggestion_id, held[0].assignment, value=0.9)),
                 lambda: zombie.suggest(eid, 1)):
        with pytest.raises(pr.ApiError) as ei:
            call()
        assert ei.value.code == pr.E_FENCED
    assert owner.store.load_observation_records(eid) == []
    r = owner.observe(pr.ObserveRequest(eid, held[0].suggestion_id,
                                        held[0].assignment, value=0.4))
    assert r.accepted and not r.duplicate
    r2 = owner.observe(pr.ObserveRequest(eid, held[0].suggestion_id,
                                         held[0].assignment, value=0.4))
    assert r2.duplicate and not r2.accepted
    assert owner.status(eid).epoch == [1, 2]


def test_rebalance_on_add_moves_minimal_set_and_transfers_pendings(p):
    root = tempfile.mkdtemp()
    manager = p.FleetManager(store=root)
    for i in range(3):
        manager.add_shard(p.LocalClient(root), shard_id=f"shard-{i}")
    client = p.FleetClient(manager, heartbeat=False)
    exp_ids, pendings = [], {}
    for i in range(8):
        eid = client.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, f"rb-{i}", budget=4),
            exp_id=f"exp-rb-{i:02d}")).exp_id
        exp_ids.append(eid)
        pendings[eid] = {s.suggestion_id: s.assignment
                         for s in client.suggest(eid, 2).suggestions}
    new_sid = next(s for s in (f"shard-new-{i}" for i in range(64))
                   if manager.ring.moved_by_adding(s, exp_ids))
    predicted = set(manager.ring.moved_by_adding(new_sid, exp_ids))
    new_client = p.LocalClient(root)
    manager.add_shard(new_client, shard_id=new_sid)
    moved = {ev["exp_id"] for ev in manager.events
             if ev["event"] == "handover"}
    assert moved == predicted
    assert manager.stats["rebalanced"] == len(predicted)
    for eid in exp_ids:
        assert (eid in new_client._exps) == (eid in predicted)
    probe = sorted(predicted)[0]
    got = client.suggest(probe, 2)
    assert {s.suggestion_id for s in got.suggestions} == set(pendings[probe])
    for eid in exp_ids:
        for sid, asg in pendings[eid].items():
            r = client.observe(p.protocol.ObserveRequest(eid, sid, asg,
                                                         value=0.5))
            assert r.accepted and not r.duplicate
        _drive(client, p.protocol, eid, 4)
        ids = [r["suggestion_id"]
               for r in p.Store(root).load_observation_records(eid)]
        assert len(ids) == 4 and len(set(ids)) == 4
    client.close()


def test_probe_deadline_counts_wedged_shard_toward_death(p):
    class WedgedClient:
        def __init__(self):
            self.block = threading.Event()

        def load(self):
            self.block.wait(30)
            return {}

    manager = p.FleetManager(period=0.05, probe_timeout=0.1)
    wedged = WedgedClient()
    manager.add_shard(wedged, shard_id="shard-wedge")
    handle = manager._shards["shard-wedge"]
    try:
        t0 = time.monotonic()
        manager.tick()
        assert time.monotonic() - t0 < 5.0
        assert handle.probe_timeouts >= 1 and handle.probe_failures >= 1
        assert manager.stats["probe_timeouts"] >= 1
        deadline = time.monotonic() + 10
        while manager.stats["dead_shards"] < 1:
            assert time.monotonic() < deadline, "wedged shard never died"
            time.sleep(0.05)
            manager.tick()
        assert manager.registry.state("shard-wedge") == p.fleet.S_DEAD
    finally:
        wedged.block.set()


def test_heartbeat_errors_audited_with_bounded_dedupe(p):
    manager, _ = _inproc_fleet(p, 1)
    fc = p.FleetClient(manager, heartbeat=False)
    for _ in range(64):
        fc._audit_beat_error(RuntimeError("boom"))
    assert fc.beat_errors() == {"RuntimeError: boom": 64}
    audited = [e for e in fc.events if e["event"] == "beat_error"]
    assert [e["count"] for e in audited] == [1, 32, 64]
    for i in range(40):
        fc._audit_beat_error(ValueError(f"e{i}"))
    assert len(fc.beat_errors()) <= 32
    t0 = time.monotonic()
    fc.close()
    assert time.monotonic() - t0 < 5.0
    plan = p.faults.FaultPlan(seed=1)
    plan.partition("w-audit", "manager", at=0)
    plan.tick()
    fc2 = p.FleetClient(manager, worker_id="w-audit", heartbeat=False,
                        fault_plan=plan)
    with pytest.raises(Exception):
        fc2.beat()
    fc2._hb_thread = threading.Thread(target=fc2._beat_loop, daemon=True)
    fc2._period = 0.02
    fc2._hb_thread.start()
    _wait(lambda: fc2.beat_errors(), "beat error audited", timeout=5)
    assert any("InjectedPartition" in k or "unreachable" in k
               for k in fc2.beat_errors())
    fc2.close()


def test_stores_sharing_a_root_never_tear_a_status_file():
    """Shards in one process each hold a ``Store`` of the shared root,
    each with its own lock: concurrent status writes through two of them
    must leave a whole ``status.json`` for every reader (the JAX
    package's store fills one shared temporary file and can tear it)."""
    p = pkg("port")
    root = tempfile.mkdtemp()
    stores = [p.Store(root) for _ in range(3)]
    stores[0].create_experiment("exp-tear", p.ExperimentConfig.from_json(
        cfg_json(p, "tear")))
    errors = []

    def write(store, tag):
        try:
            for i in range(200):
                store.update_status("exp-tear", **{tag: "x" * (i % 97),
                                                   "n": i})
        except Exception as e:          # asserted below, after the join
            errors.append(e)

    def read():
        try:
            for _ in range(400):
                stores[2].get_status("exp-tear")
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=write, args=(stores[i % 2], f"w{i}"))
               for i in range(4)] + [threading.Thread(target=read)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert stores[2].get_status("exp-tear")["n"] == 199


# ------------------------------------------------------ across the packages
@pytest.mark.parametrize("client_pkg,fleet_pkg", [
    ("reference", "port"), ("port", "reference")])
def test_fleet_client_drives_the_other_packages_fleet(client_pkg, fleet_pkg):
    c, f = pkg(client_pkg), pkg(fleet_pkg)
    root = tempfile.mkdtemp()
    srv = f.serve_fleet(root, shards=2, period=0.2).start()
    try:
        client = c.FleetClient(srv.url, heartbeat=True)
        eids = [client.create_experiment(c.protocol.CreateExperiment(
            config=cfg_json(c, f"x-{i}", budget=6),
            exp_id=f"exp-x-{i}")).exp_id for i in range(4)]
        owners = {srv.manager.owner_of(e).shard_id for e in eids}
        assert owners == {"shard-0", "shard-1"}
        for eid in eids:
            _drive(client, c.protocol, eid, 6)
            st = client.status(eid)
            assert st.observations == 6 and st.pending == 0
            assert st.state == "complete"
        assert client.holdings() == {}
        client.close()
    finally:
        srv.shutdown()


def test_store_of_a_reference_fleet_adopted_by_a_port_fleet_once():
    """A reference fleet writes observations and leaves suggestions
    pending; a port fleet over the same store adopts each experiment
    (config-less resume), replays the log once, keeps dedupe across the
    handover and completes every budget."""
    ref, port = pkg("reference"), pkg("port")
    root = tempfile.mkdtemp()
    srv = ref.serve_fleet(root, shards=2, period=0.2).start()
    done, stale = {}, {}
    try:
        rc = ref.FleetClient(srv.url, heartbeat=False)
        for i in range(3):
            eid = rc.create_experiment(ref.protocol.CreateExperiment(
                config=cfg_json(ref, f"adopt-{i}", budget=6),
                exp_id=f"exp-adopt-{i}")).exp_id
            got = rc.suggest(eid, 3).suggestions
            for s in got[:2]:
                assert rc.observe(ref.protocol.ObserveRequest(
                    eid, s.suggestion_id, s.assignment, value=0.3)).accepted
            done[eid], stale[eid] = got[0], got[2]
        rc.close()
    finally:
        srv.shutdown()
    srv = port.serve_fleet(root, shards=2, period=0.2).start()
    try:
        pc = port.FleetClient(srv.url, heartbeat=False)
        pr = port.protocol
        for eid in done:
            resp = pc.create_experiment(pr.CreateExperiment(config={},
                                                            exp_id=eid))
            assert resp.resumed and resp.observations == 2
            again = pc.create_experiment(pr.CreateExperiment(config={},
                                                             exp_id=eid))
            assert again.observations == 2       # restore is idempotent
            s = done[eid]
            dup = pc.observe(pr.ObserveRequest(eid, s.suggestion_id,
                                               s.assignment, value=0.3))
            assert dup.duplicate and not dup.accepted
            s = stale[eid]      # handed out by the reference, never seen
            assert pc.observe(pr.ObserveRequest(
                eid, s.suggestion_id, s.assignment, value=0.4)).accepted
            _drive(pc, pr, eid, 6)
            recs = port.Store(root).load_observation_records(eid)
            ids = [r["suggestion_id"] for r in recs]
            assert len(ids) == 6 and len(set(ids)) == 6
            assert pc.status(eid).state == "complete"
            shard = int(srv.manager.owner_of(eid).shard_id.split("-")[1])
            state = srv.owned_shards[shard].backend._exps[eid]
            assert len(state.optimizer.history) == 6   # each replayed once
        pc.close()
    finally:
        srv.shutdown()


# ---------------------------------------------------------------- kill -9
_WORKER_SCRIPT = """
import sys, time
sys.path.insert(0, {src!r})
from {package}.fleet import FleetClient
client = FleetClient({fleet_url!r}, worker_id="victim", heartbeat=True)
held = []
for eid in {exp_ids!r}:
    held += [s.suggestion_id for s in client.suggest(eid, 1).suggestions]
client.beat()
print("HELD " + " ".join(held), flush=True)
time.sleep(120)
"""


def test_kill9_scheduler_requeues_within_two_periods():
    """A port ``FleetClient`` in its own process holds one suggestion of
    each of 8 experiments on a port fleet and is killed −9: every held
    suggestion is requeued within ~2 heartbeat periods and served to a
    survivor exactly once."""
    p = pkg("port")
    root = tempfile.mkdtemp()
    period = 0.5
    srv = p.serve_fleet(root, shards=2, period=period).start()
    worker = None
    try:
        boss = p.FleetClient(srv.url, heartbeat=False)
        exp_ids = [boss.create_experiment(p.protocol.CreateExperiment(
            config=cfg_json(p, f"k9-{i}", budget=3),
            exp_id=f"exp-k9-{i}")).exp_id for i in range(8)]
        script = _WORKER_SCRIPT.format(src=SRC, package="repro_torch",
                                       fleet_url=srv.url, exp_ids=exp_ids)
        worker = subprocess.Popen([sys.executable, "-c", script],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
        line = []
        reader = threading.Thread(
            target=lambda: line.append(worker.stdout.readline()),
            daemon=True)
        reader.start()
        reader.join(60)
        assert line and line[0].startswith("HELD"), "worker never held"
        held = set(line[0].split()[1:])
        assert len(held) == 8
        t_kill = time.monotonic()
        os.kill(worker.pid, signal.SIGKILL)
        _wait(lambda: srv.manager.stats["requeued"] >= 8, "requeue",
              timeout=30)
        assert srv.manager.stats["requeued"] == 8, srv.manager.stats
        assert time.monotonic() - t_kill < 2 * period + 3.0
        survivor = p.FleetClient(srv.url, heartbeat=False)
        served = []
        for eid in exp_ids:
            got = survivor.suggest(eid, 3)
            ids = [s.suggestion_id for s in got.suggestions]
            assert len(set(ids)) == len(ids)
            served += [(eid, s) for s in got.suggestions]
        assert held <= {s.suggestion_id for _, s in served}
        for eid, s in served:
            r = survivor.observe(p.protocol.ObserveRequest(
                eid, s.suggestion_id, s.assignment, value=0.5))
            assert r.accepted and not r.duplicate
        for eid in exp_ids:
            st = survivor.status(eid)
            assert st.observations == 3 and st.pending == 0
        boss.close()
        survivor.close()
    finally:
        if worker is not None and worker.poll() is None:
            worker.kill()
            worker.wait(timeout=10)
        srv.shutdown()
