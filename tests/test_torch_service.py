"""The port's suggestion service (``repro_torch.api.local.LocalClient``)
on the CPU: budgets complete exactly with and without the prefetch pump,
two experiments' refits co-batch into one lane-batched fit, and an experiment the
JAX reference service wrote to a store resumes in the port with every
observation replayed exactly once."""
import json
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from repro.api import CreateExperiment as RefCreate
from repro.api import LocalClient as RefClient
from repro.api import ObserveRequest as RefObserve
from repro.core.experiment import ExperimentConfig as RefConfig
from repro.core.space import Param as RefParam
from repro.core.space import Space as RefSpace
from repro_torch.api import CreateExperiment, LocalClient, ObserveRequest
from repro_torch.api import pipeline
from repro_torch.core.experiment import ExperimentConfig
from repro_torch.core.space import Param, Space, strip_internal
from repro_torch.core.suggest import Observation, make_optimizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is enough, and the suite runs
    beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(P=Param, S=Space):
    return S([P("x", "double", 0, 1), P("y", "double", 1e-4, 1e0, log=True)])


def _f(a):
    return -((a["x"] - 0.62) ** 2 + (np.log10(a["y"]) + 2.0) ** 2)


def _cfg(name, budget, parallel, prefetch, **opts):
    return ExperimentConfig(
        name=name, budget=budget, parallel=parallel, optimizer="gp",
        space=_space(), prefetch=prefetch,
        optimizer_options=dict(n_init=4, candidates=64, fit_steps=20,
                               warm_fit_steps=8, **opts))


def _drive(client, exp, parallel, timeout=120.0):
    """``parallel`` worker threads: suggest one, evaluate, observe, until
    the budget is spent.  Returns the suggestion ids handed out."""
    ids, lock, errors = [], threading.Lock(), []

    def worker():
        try:
            deadline = time.time() + timeout
            while time.time() < deadline:
                batch = client.suggest(exp, 1)
                if not batch.suggestions:
                    if batch.remaining == 0 and \
                            client.status(exp).observations >= \
                            client.status(exp).budget:
                        return
                    time.sleep(0.01)
                    continue
                s = batch.suggestions[0]
                with lock:
                    ids.append(s.suggestion_id)
                client.observe(ObserveRequest(
                    exp, s.suggestion_id, s.assignment,
                    value=_f(strip_internal(s.assignment))))
        except Exception as e:  # surfaced by the caller's assert
            errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(parallel)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout + 10)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    return ids


def _check_complete(client, exp, budget, ids):
    st = client.status(exp)
    assert st.observations == budget
    assert len(ids) == budget and len(set(ids)) == budget
    log = client.store.exp_dir(exp) / "observations.jsonl"
    assert len(log.read_text().strip().splitlines()) == budget


def test_gp_budget_completes_without_pump():
    client = LocalClient(tempfile.mkdtemp(), device="cpu")
    exp = client.create_experiment(CreateExperiment(
        config=_cfg("nopump", 16, 2, prefetch=0).to_json())).exp_id
    ids = _drive(client, exp, 2)
    _check_complete(client, exp, 16, ids)
    client.close()


def test_gp_budget_completes_with_pump():
    client = LocalClient(tempfile.mkdtemp(), device="cpu")
    exp = client.create_experiment(CreateExperiment(
        config=_cfg("pump", 16, 2, prefetch=None).to_json())).exp_id
    ids = _drive(client, exp, 2)
    _check_complete(client, exp, 16, ids)
    st = client.status(exp)
    # the pump ran: it prewarms every bucket up to its goal at start
    assert st.pump["depth"] > 0 and st.pump["prewarmed"] >= 1
    client.close()


def test_two_experiments_cobatch_refits():
    """Two gp experiments' owed refits, queued on the shared executor
    together, run as ONE lane-batched dispatch of two lanes (through
    ``batched_fit`` and ``ops.gp_fit_grads``) and each installs."""
    opts = []
    for i in range(2):
        opt = make_optimizer("gp", _space(), seed=i, device="cpu",
                             n_init=4, candidates=64, fit_steps=20,
                             warm_fit_steps=8)
        pts = opt.ask(12)                   # random phase
        opt.tell([Observation(a, _f(strip_internal(a))) for a in pts])
        opt.defer_fits = True
        opts.append(opt)

    def job(opt):
        def snapshot():
            spec = opt.fit_spec()
            return None if spec is None else pipeline.FitLane(
                spec, spec.install)
        return pipeline.BatchableFit(snapshot)

    old_window = pipeline.FitExecutor.GATHER_WINDOW
    pipeline.FitExecutor.GATHER_WINDOW = 0.5    # both jobs are queued
    ex = pipeline.FitExecutor(workers=1)
    try:
        for i, opt in enumerate(opts):
            ex.submit(("fit", i), job(opt), pipeline.PRIO_IDLE)
        deadline = time.time() + 60
        while ex.snapshot()["executed"] < 2 and time.time() < deadline:
            time.sleep(0.01)
        stats = ex.snapshot()
        assert stats["batched"] == 1 and stats["lanes"] == 2, stats
        assert all(opt._fits == 1 and opt._params is not None
                   for opt in opts)
        assert all(opt.fit_spec() is None for opt in opts)   # debt paid
    finally:
        ex.stop()
        pipeline.FitExecutor.GATHER_WINDOW = old_window


def _fake_job(dispatches, kind="fit"):
    """A batchable executor job whose runner records its lane count."""
    spec = types.SimpleNamespace(
        kind=kind, group_key=kind,
        runner=lambda specs: (dispatches.append(len(specs))
                              or [None] * len(specs), 0.0))
    lane = pipeline.FitLane(spec, lambda params, seconds: None)
    cls = pipeline.BatchableAsk if kind == "ask" else pipeline.BatchableFit
    return cls(lambda: lane)


def test_gathering_worker_keeps_late_peers():
    """With two workers, a fit that arrives while one worker gathers
    peers joins that worker's batch instead of being dispatched alone by
    the idle worker, and a queued refill ask is never taken as a fit
    peer (nor a fit as an ask peer)."""
    fits, asks = [], []
    old_window = pipeline.FitExecutor.GATHER_WINDOW
    pipeline.FitExecutor.GATHER_WINDOW = 0.5
    ex = pipeline.FitExecutor(workers=2)
    try:
        ex.submit(("fit", 0), _fake_job(fits), pipeline.PRIO_IDLE)
        time.sleep(0.05)        # one worker pops it and starts gathering
        ex.submit(("fit", 1), _fake_job(fits), pipeline.PRIO_IDLE)
        time.sleep(0.05)        # the idle worker has seen it
        ex.submit(("ask", 0), _fake_job(asks, "ask"), pipeline.PRIO_REFILL)
        deadline = time.time() + 30
        while ex.snapshot()["executed"] < 3 and time.time() < deadline:
            time.sleep(0.01)
        stats = ex.snapshot()
        assert fits == [2] and asks == [1], (fits, asks)
        assert (stats["batched"], stats["lanes"]) == (1, 2), stats
        assert (stats["batched_asks"], stats["ask_lanes"]) == (1, 1), stats
        assert stats.get("failed", 0) == 0, stats
    finally:
        ex.stop()
        pipeline.FitExecutor.GATHER_WINDOW = old_window


def test_port_resumes_reference_store_exactly_once():
    """The JAX service writes an experiment; the port adopts the same
    store and replays each logged observation exactly once."""
    root = tempfile.mkdtemp()
    ref = RefClient(root)
    cfg = RefConfig(name="resume", budget=12, parallel=2, optimizer="gp",
                    space=_space(RefParam, RefSpace), prefetch=0,
                    optimizer_options=dict(n_init=4, candidates=64,
                                           fit_steps=10, warm_fit_steps=5))
    exp = ref.create_experiment(RefCreate(config=cfg.to_json())).exp_id
    for _ in range(6):      # random phase only: no JAX compile here
        s = ref.suggest(exp, 1).suggestions[0]
        ref.observe(RefObserve(exp, s.suggestion_id, s.assignment,
                               value=_f(strip_internal(s.assignment))))
    ref.close()
    stored = json.loads((ref.store.exp_dir(exp) / "config.json").read_text())

    port = LocalClient(root, device="cpu")
    resp = port.create_experiment(CreateExperiment(config={}, exp_id=exp))
    assert resp.resumed and resp.observations == 6
    state = port._state(exp)
    assert len(state.optimizer.history) == 6
    assert len(state.optimizer._ys) == 6
    # the persisted config is untouched by the device
    again = json.loads((port.store.exp_dir(exp) / "config.json").read_text())
    assert again == stored and "device" not in json.dumps(again)
    # a re-create is idempotent: nothing is replayed twice
    port.create_experiment(CreateExperiment(config={}, exp_id=exp))
    assert len(state.optimizer.history) == 6
    ids = _drive(port, exp, 2)
    assert port.status(exp).observations == 12 and len(set(ids)) == 6
    port.close()
