"""The port's cluster, scheduler, fault injection and orchestrator on the
CPU (``repro_torch.core``), against the JAX reference.

The reference's own tests of these modules (``test_cluster.py``,
``test_scheduler.py``, ``test_faults.py``) run here over the port, each
with its own objective; then the two packages side by side: the same
experiment (``optimizer: random``, parallel 1, no prefetch, a fixed seed)
and the same objective give the same (assignment, value) sequence in
``observations.jsonl``; an experiment the reference orchestrator ran
resumes in the port's with each logged observation replayed exactly
once; and two background ``gp`` experiments on one port orchestrator
complete their budgets with a co-batched refit (``gp_nll``'s path).
"""
import json
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import ExperimentConfig as RefConfig
from repro.core import Orchestrator as RefOrchestrator
from repro.core import Param as RefParam
from repro.core import Space as RefSpace
from repro_torch.api import pipeline
from repro_torch.core import (Cluster, ClusterConfig, ExperimentConfig,
                              Orchestrator, Param, PoolConfig, Resources,
                              Space)
from repro_torch.core.faults import (ChaosMonkey, FaultPlan, FaultPolicy,
                                     InjectedCrash, InjectedPartition,
                                     wrap_trial)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is enough, and the suite runs
    beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _orch():
    return Orchestrator(tempfile.mkdtemp(), device="cpu")


def _space(P=Param, S=Space):
    return S([P("x", "double", 0, 1)])


def _cfg(**kw):
    kw.setdefault("optimizer", "random")
    kw.setdefault("space", _space())
    return ExperimentConfig(**kw)


# ------------------------------------------------------------- cluster
def _cluster(device="cpu"):
    return Cluster(ClusterConfig("c", pools=[
        PoolConfig("cpu", "cpu", chips=8),
        PoolConfig("tpu", "tpu", chips=16, min_chips=4, max_chips=32,
                   chips_per_node=4)]), device=device)


def test_allocate_release():
    c = _cluster()
    leases = [c.allocate("tpu", 4) for _ in range(4)]
    assert all(lease is not None for lease in leases)
    assert c.allocate("tpu", 4) is None            # full
    c.release(leases[0])
    assert c.allocate("tpu", 4) is not None
    assert leases[1].devices == [torch.device("cpu")]


def test_heterogeneous_pools_isolated():
    c = _cluster()
    assert c.allocate("cpu", 8) is not None
    assert c.allocate("cpu", 1) is None
    assert c.allocate("tpu", 8) is not None        # unaffected


def test_unknown_pool_raises():
    with pytest.raises(KeyError):
        _cluster().allocate("gpu", 1)


def test_elastic_scale_clamped():
    c = _cluster()
    assert c.scale("tpu", 64) == 32                # max_chips
    assert c.scale("tpu", 0) == 4                  # min_chips
    st = c.status()
    assert st["pools"]["tpu"]["chips"] == 4


def test_fail_nodes_revokes_leases():
    c = _cluster()
    revoked_cb = []
    l1 = c.allocate("tpu", 12,
                    on_revoke=lambda lease: revoked_cb.append(lease.lease_id))
    assert c.status()["pools"]["tpu"]["free"] == 4
    victims = c.fail_nodes("tpu", 2)               # lose 8 chips: 4 free + 4
    assert victims and victims[0].revoked
    assert revoked_cb == [l1.lease_id]
    # released revoked lease does not return capacity
    c.release(l1)
    assert c.status()["pools"]["tpu"]["free"] == 0


def test_cluster_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _cluster(device=None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Orchestrator(tempfile.mkdtemp())


def test_cuda_leases_carry_the_cards(monkeypatch):
    """On the card every lease carries the process's CUDA devices, sliced
    as the reference slices ``jax.devices()`` (one card: ``cuda:0``)."""
    import repro_torch.core.cluster as C
    monkeypatch.setattr(C, "resolve", lambda device: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    c = _cluster(device=None)
    assert c.allocate("tpu", 4).devices == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
    assert c.allocate("cpu", 1).devices == [torch.device("cuda", 0)]


def test_flat_yaml_and_store_json_match_reference():
    """The paper's flat YAML maps to the same pools, and a cluster the
    reference saved loads in the port (the store's cluster JSON)."""
    from repro.core.cluster import ClusterConfig as RefClusterConfig
    flat = {"cluster_name": "flat", "cloud_provider": "aws",
            "cpu": {"max_nodes": 2, "min_nodes": 1},
            "gpu": {"max_nodes": 3, "chips_per_node": 4}}
    want = RefClusterConfig.from_json(flat).to_json()
    assert ClusterConfig.from_json(flat).to_json() == want
    root = tempfile.mkdtemp()
    ref = RefOrchestrator(root)
    ref.cluster_create(flat)
    port = Orchestrator(root, device="cpu")
    assert port.cluster_status("flat") == ref.cluster_status("flat")


# ------------------------------------------------------------ scheduler
def test_parallel_bound_respected():
    orch = _orch()
    in_flight, peak = [0], [0]
    lock = threading.Lock()

    def trial(a, ctx):
        with lock:
            in_flight[0] += 1
            peak[0] = max(peak[0], in_flight[0])
        time.sleep(0.03)
        with lock:
            in_flight[0] -= 1
        return a["x"]

    orch.run(_cfg(name="p", budget=12, parallel=3), trial_fn=trial)
    assert peak[0] <= 3
    assert peak[0] >= 2          # actually ran concurrently


def test_crash_retry_then_fail():
    orch = _orch()
    attempts = {}

    def trial(a, ctx):
        key = round(a["x"], 6)
        attempts[key] = attempts.get(key, 0) + 1
        raise RuntimeError("boom")

    exp = orch.run(_cfg(name="c", budget=4, parallel=2, max_retries=1),
                   trial_fn=trial)
    st = orch.status(exp)
    assert st["failures"] == 4
    assert all(v == 2 for v in attempts.values())   # retried exactly once


def test_admission_control_queues_when_full():
    orch = _orch()
    orch.cluster_create({"cluster_name": "small",
                         "pools": [{"name": "gpu", "resource": "gpu",
                                    "chips": 4}]})
    devices = []

    def trial(a, ctx):
        devices.append(ctx.lease.devices[0])
        time.sleep(0.02)
        return 1.0

    exp = orch.run(_cfg(name="a", budget=6, parallel=4,
                        resources=Resources(pool="gpu", chips=4)),
                   trial_fn=trial, cluster="small")
    st = orch.status(exp)
    assert st["observations"] == 6     # all ran, just serialized by capacity
    c = orch.cluster_status("small")
    assert c["pools"]["gpu"]["free"] == 4
    assert devices == [torch.device("cpu")] * 6


def test_asha_prunes():
    orch = _orch()

    def trial(a, ctx):
        v = a["x"]
        for step in (1, 3, 9):
            ctx.report(step, v)
            time.sleep(0.002)
        return v

    exp = orch.run(_cfg(name="asha", budget=18, parallel=6,
                        early_stop={"min_steps": 1, "eta": 3}),
                   trial_fn=trial)
    obs = orch.store.load_observations(exp)
    pruned = [o for o in obs if o.metadata.get("pruned")]
    full = [o for o in obs if not o.metadata.get("pruned") and not o.failed]
    assert pruned, "ASHA should prune someone"
    # survivors are better on average than the pruned
    assert (np.mean([o.value for o in full])
            > np.mean([o.value for o in pruned]))


def test_straggler_speculation_wins():
    orch = _orch()
    calls = {"n": 0}
    lock = threading.Lock()

    def trial(a, ctx):
        with lock:
            calls["n"] += 1
            first = calls["n"] <= 4
        # trials 1-4 are fast; the 5th's FIRST attempt hangs (straggler)
        if not first and not ctx.trial_id.endswith("-spec1"):
            for _ in range(400):
                time.sleep(0.01)
                ctx.report(1, 0.0)    # lets the loser get cancelled
        time.sleep(0.01)
        return a["x"]

    t0 = time.time()
    exp = orch.run(_cfg(name="s", budget=5, parallel=2,
                        straggler_factor=3.0, max_retries=0),
                   trial_fn=trial)
    took = time.time() - t0
    assert orch.status(exp)["observations"] == 5
    assert took < 3.0, f"speculation should beat the 4s straggler ({took=})"


def test_delete_stops_execution():
    orch = _orch()
    started = threading.Event()

    def trial(a, ctx):
        started.set()
        for _ in range(1000):
            time.sleep(0.005)
            ctx.report(1, 0.0)
        return 1.0

    exp = orch.run(_cfg(name="d", budget=50, parallel=2), trial_fn=trial,
                   background=True)
    assert started.wait(5.0)
    orch.delete(exp)
    orch.wait(exp, timeout=10)
    assert orch.status(exp).get("state") in ("deleted", "stopped")


def test_node_failure_requeues_and_completes():
    orch = _orch()
    orch.cluster_create({"cluster_name": "chaos",
                         "pools": [{"name": "gpu", "resource": "gpu",
                                    "chips": 8, "chips_per_node": 2}]})
    cluster = orch.cluster_get("chaos")

    def trial(a, ctx):
        for _ in range(10):
            time.sleep(0.005)
            ctx.report(1, a["x"])
        return a["x"]

    monkey = ChaosMonkey(cluster, "gpu", period_s=0.05, heal_s=0.02).start()
    try:
        exp = orch.run(_cfg(name="n", budget=10, parallel=3,
                            resources=Resources(pool="gpu", chips=2),
                            max_retries=3),
                       trial_fn=trial, cluster="chaos")
    finally:
        monkey.stop()
    assert monkey.kills >= 1
    assert orch.status(exp)["observations"] == 10   # survived node failures


def test_fault_injection_paths():
    orch = _orch()
    wrapped = wrap_trial(lambda a, ctx: a["x"],
                         FaultPolicy(p_crash=0.3, p_nan=0.2, seed=3))
    exp = orch.run(_cfg(name="f", budget=20, parallel=4, max_retries=0),
                   trial_fn=wrapped)
    obs = orch.store.load_observations(exp)
    assert [o for o in obs if o.failed], "some crashes expected"
    assert len(obs) == 20


# --------------------------------------------------------------- faults
def test_wrap_trial_crash_branch_respects_retry_policy():
    orch = _orch()
    attempts = {}

    def trial(a, ctx):
        attempts[round(a["x"], 6)] = attempts.get(round(a["x"], 6), 0) + 1
        return a["x"]

    wrapped = wrap_trial(trial, FaultPolicy(p_crash=1.0, seed=1))
    exp = orch.run(_cfg(name="crash", budget=3, parallel=2, max_retries=2),
                   trial_fn=wrapped)
    obs = orch.store.load_observations(exp)
    assert len(obs) == 3 and all(o.failed for o in obs)
    assert attempts == {}          # crashed before the user fn each time
    assert orch.status(exp)["failures"] == 3


def test_wrap_trial_nan_branch_is_not_a_failure():
    orch = _orch()
    wrapped = wrap_trial(lambda a, ctx: a["x"],
                         FaultPolicy(p_nan=1.0, seed=2))
    exp = orch.run(_cfg(name="nan", budget=4, parallel=2, max_retries=0),
                   trial_fn=wrapped)
    obs = orch.store.load_observations(exp)
    assert len(obs) == 4
    assert all(not o.failed and np.isnan(o.value) for o in obs)


def test_wrap_trial_straggler_branch_slows_but_completes():
    orch = _orch()
    seen = []

    def trial(a, ctx):
        seen.append(a["x"])
        return a["x"]

    wrapped = wrap_trial(trial, FaultPolicy(p_slow=1.0, slow_factor=1.5,
                                            seed=3))
    exp = orch.run(_cfg(name="slow", budget=3, parallel=3, max_retries=0),
                   trial_fn=wrapped)
    obs = orch.store.load_observations(exp)
    assert len(obs) == 3 and len(seen) == 3
    assert all(not o.failed for o in obs)
    assert any("fault-injection: straggler" in ln
               for ln in orch.store.iter_logs(exp))


def test_wrap_trial_mixed_policy_under_retries():
    orch = _orch()
    wrapped = wrap_trial(lambda a, ctx: a["x"],
                         FaultPolicy(p_crash=0.4, p_nan=0.2, seed=5))
    exp = orch.run(_cfg(name="mix", budget=16, parallel=4, max_retries=1),
                   trial_fn=wrapped)
    obs = orch.store.load_observations(exp)
    assert len(obs) == 16
    assert [o for o in obs if o.failed], "some crashes expected"
    assert orch.status(exp)["observations"] == 16


def test_crash_mid_report_leaves_no_orphaned_pending():
    """A trial that crashes after streaming progress reports leaks no
    pending suggestion, and the GP's constant-liar lie is retired."""
    orch = _orch()

    def trial(a, ctx):
        ctx.report(1, a["x"])
        raise InjectedCrash("mid-report crash")

    cfg = _cfg(name="midreport", budget=5, parallel=2, max_retries=0,
               optimizer="gp",
               optimizer_options={"n_init": 2, "fit_steps": 20},
               early_stop={"min_steps": 1, "eta": 2})
    exp = orch.run(cfg, trial_fn=trial)
    state = orch.client._exps[exp]
    assert state.pending == {}, "crashed trials must not hold pending"
    assert not getattr(state.optimizer, "_pending", {})
    obs = orch.store.load_observations(exp)
    assert len(obs) == 5
    assert all(o.failed or o.metadata.get("pruned") for o in obs)
    assert any(o.failed for o in obs), "some crashes expected"
    assert orch.client.store.load_metrics(exp), "pre-crash reports persisted"


def test_delete_mid_run_releases_and_forgets_pending():
    orch = _orch()
    started = threading.Event()

    def trial(a, ctx):
        started.set()
        ctx.report(1, a["x"])
        raise InjectedCrash("boom")

    cfg = _cfg(name="reclaim", budget=30, parallel=2, max_retries=5,
               optimizer="gp",
               optimizer_options={"n_init": 2, "fit_steps": 20})
    exp = orch.run(cfg, trial_fn=trial, background=True)
    assert started.wait(10.0)
    orch.delete(exp)
    orch.wait(exp, timeout=20)
    state = orch.client._exps[exp]
    assert state.pending == {}
    assert not getattr(state.optimizer, "_pending", {})


def test_fault_plan_partitions_by_tick():
    """The fleet-level plan (kept for the transport, ROADMAP §1 item 3):
    a tick-indexed partition raises on both directions of its edge until
    healed, and a seeded drop replays identically."""
    plan = FaultPlan().partition("w*", "shard-1", at=1)
    plan.gate("w0", "shard-1")                      # tick 0: not yet
    plan.tick()
    for src, dst in (("w0", "shard-1"), ("shard-1", "w3")):
        with pytest.raises(InjectedPartition):
            plan.gate(src, dst)
    plan.gate("w0", "shard-0")                      # other edges pass
    plan.heal("w0", "shard-1")
    plan.gate("w0", "shard-1")
    assert plan.dropped == {("w0", "shard-1"): 1, ("shard-1", "w3"): 1}

    def drops(seed):
        p = FaultPlan([{"op": "drop", "src": "a", "dst": "b", "at": 0,
                        "until": None, "p": 0.5}], seed=seed)
        out = []
        for _ in range(32):
            try:
                p.gate("a", "b")
                out.append(0)
            except InjectedPartition:
                out.append(1)
        return out
    assert drops(7) == drops(7) and 0 < sum(drops(7)) < 32


# ----------------------------------------------- against the reference
def _objective(a, ctx):
    ctx.log(f"x={a['x']}")
    return -(a["x"] - 0.25) ** 2


def _sequence(store, exp):
    recs = store.load_observation_records(exp)
    return [(r["assignment"], r["value"]) for r in recs]


def test_observation_sequence_matches_reference():
    """One worker (parallel 1) and no prefetch pump: the suggestions are
    drawn one at a time in order, so the sequence itself is compared, not
    a multiset."""
    kw = dict(name="seq", budget=8, parallel=1, optimizer="random",
              seed=11, prefetch=0)
    ref = RefOrchestrator(tempfile.mkdtemp())
    ref_exp = ref.run(RefConfig(space=_space(RefParam, RefSpace), **kw),
                      trial_fn=_objective)
    port = _orch()
    exp = port.run(ExperimentConfig(space=_space(), **kw),
                   trial_fn=_objective)
    want = _sequence(ref.store, ref_exp)
    assert len(want) == 8
    assert _sequence(port.store, exp) == want


def test_port_resumes_reference_orchestrator_run():
    """The reference orchestrator runs 6 trials; the port's orchestrator
    resumes the experiment with its budget raised to 10 and replays each
    of the 6 exactly once."""
    root = tempfile.mkdtemp()
    kw = dict(name="resume", parallel=2, optimizer="random", seed=3)
    ref = RefOrchestrator(root)
    exp = ref.run(RefConfig(space=_space(RefParam, RefSpace), budget=6,
                            **kw), trial_fn=_objective)
    ref.client.close()
    logged = _sequence(ref.store, exp)
    port = Orchestrator(root, device="cpu")
    assert port.status(exp)["observations"] == 6
    again = port.run(ExperimentConfig(space=_space(), budget=10, **kw),
                     trial_fn=_objective, exp_id=exp)
    assert again == exp
    state = port.client._state(exp)
    assert len(state.optimizer.history) == 10
    seq = _sequence(port.store, exp)
    assert len(seq) == 10 and seq[:6] == logged
    assert port.status(exp)["observations"] == 10
    cfg = json.loads((port.store.exp_dir(exp) / "config.json").read_text())
    assert cfg["budget"] == 10
    port.client.close()


def test_two_gp_experiments_cobatch_through_orchestrator(monkeypatch):
    """The paper's loop on the port, on the CPU: two background ``gp``
    experiments on one orchestrator (one shared ``LocalClient``) complete
    their budgets, hand out no suggestion twice, and at least one refit
    dispatch carries both experiments' lanes — the co-batched path that
    runs ``gp_nll`` on the card.  Each experiment runs one trial at a
    time, and a barrier pairs the two experiments' k-th trials, so their
    refits fall due together (the pump's timing alone would leave
    co-batching to chance at this small budget)."""
    monkeypatch.setattr(pipeline.FitExecutor, "MAX_LANES", 2)
    monkeypatch.setattr(pipeline.FitExecutor, "GATHER_WINDOW", 0.2)
    before = dict(pipeline.fit_executor().snapshot())
    orch = _orch()
    orch.cluster_create({"cluster_name": "cpu", "pools": [
        {"name": "gpu", "resource": "gpu", "chips": 2}]})
    pair = threading.Barrier(2, timeout=30)
    budget = 16

    def trial(a, ctx):
        pair.wait()
        time.sleep(0.1)     # leaves the pumps time to refill their queues
        return -((a["x"] - 0.62) ** 2 + (np.log10(a["y"]) + 2.0) ** 2)

    space = Space([Param("x", "double", 0, 1),
                   Param("y", "double", 1e-4, 1e0, log=True)])
    exps = [orch.run(ExperimentConfig(
        name=f"gp-{i}", budget=budget, parallel=1, optimizer="gp",
        goal="max", space=space, seed=i,
        resources=Resources(pool="gpu", chips=1),
        optimizer_options=dict(n_init=4, candidates=64, fit_steps=20,
                               warm_fit_steps=8, refit_every=2)),
        trial_fn=trial, cluster="cpu", background=True) for i in range(2)]
    for exp in exps:
        orch.wait(exp, timeout=120)
    assert not any(orch._threads[e].is_alive() for e in exps)
    after = pipeline.fit_executor().snapshot()
    for exp in exps:
        st = orch.status(exp)
        assert st["state"] == "complete" and st["observations"] == budget
        assert st["failures"] == 0
        ids = [r["suggestion_id"]
               for r in orch.store.load_observation_records(exp)]
        assert len(ids) == budget and len(set(ids)) == budget
        assert "pump_error" not in orch.client.status(exp).pump
    lanes = after["lanes"] - before.get("lanes", 0)
    batched = after["batched"] - before.get("batched", 0)
    assert lanes > batched, (before, after)
    assert after.get("failed", 0) == before.get("failed", 0)
    orch.client.close()
