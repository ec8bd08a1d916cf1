"""The GP's card work stays on a fixed set of threads
(``repro_torch.card_pool``): the fit executor's workers and the pool's
own threads, on the CPU as on the card.

* 16 client threads suggest and observe concurrently against a seeded
  ``LocalClient`` with its prefetch pump on; a spy on the GP's numerics
  (the posterior Cholesky, ``ops.gp_ei`` and the batched fit's
  gradients) records the thread of every call: each ran on the set, and
  no more distinct threads ran it than the set has;
* ``confined``: an exception is raised again in the caller, a confined
  call made inside another runs inline (so saturating the pool's threads
  with nested calls cannot deadlock), and the caller's grad mode holds;
* ``stats``: one hand-off counted for a call handed over (none for the
  nested one), its queued seconds within its waited seconds;
* every public function of ``core/suggest/gp.py`` is ``confined`` but
  those that take no library handle on the card.

Every join has a timeout that the test asserts on, so a deadlock fails
the test instead of hanging the suite.
"""
import inspect
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import card_pool
from repro_torch.api import CreateExperiment, LocalClient, ObserveRequest
from repro_torch.api import pipeline
from repro_torch.core.experiment import ExperimentConfig
from repro_torch.core.space import Param, Space, strip_internal
from repro_torch.kernels import ops, ref

CLIENTS = 16
BUDGET = 64
JOIN_S = 120.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _objective(a) -> float:
    return -((a["x"] - 0.62) ** 2 + (np.log10(a["y"]) + 2.0) ** 2)


def _spy(monkeypatch, names: list):
    """Record the thread of every call of the GP's numerics."""
    for mod, attr in ((ref, "cholesky"), (ops, "gp_ei"),
                      (ops, "gp_fit_grads")):
        inner = getattr(mod, attr)

        def spied(*a, _inner=inner, _attr=attr, **k):
            names.append((_attr, threading.current_thread().name))
            return _inner(*a, **k)
        monkeypatch.setattr(mod, attr, spied)


def _pool_names(workers: int) -> set:
    return ({f"fit-exec-{i}" for i in range(workers)}
            | {f"{card_pool.PREFIX}_{i}" for i in range(card_pool.THREADS)})


def test_gp_numerics_run_on_the_fixed_pool(monkeypatch):
    calls: list = []
    _spy(monkeypatch, calls)
    workers = pipeline.fit_executor().workers
    client = LocalClient(tempfile.mkdtemp(), device="cpu")
    space = Space([Param("x", "double", 0, 1),
                   Param("y", "double", 1e-4, 1e0, log=True)])
    exp = client.create_experiment(CreateExperiment(config=ExperimentConfig(
        name="confined", budget=BUDGET, parallel=CLIENTS, optimizer="gp",
        space=space, seed=3, prefetch=None,
        optimizer_options=dict(n_init=4, candidates=64, fit_steps=20,
                               warm_fit_steps=8)).to_json())).exp_id
    errors, ids, lock = [], [], threading.Lock()
    deadline = time.monotonic() + JOIN_S

    def client_thread():
        try:
            while time.monotonic() < deadline:
                batch = client.suggest(exp, 1)
                if not batch.suggestions:
                    if batch.remaining == 0 and \
                            client.status(exp).observations >= BUDGET:
                        return
                    time.sleep(0.005)
                    continue
                s = batch.suggestions[0]
                with lock:
                    ids.append(s.suggestion_id)
                client.observe(ObserveRequest(
                    exp, s.suggestion_id, s.assignment,
                    value=_objective(strip_internal(s.assignment))))
        except Exception as e:  # asserted on after the join
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client_thread, name=f"client-{i}")
               for i in range(CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(0.1, deadline + 10 - time.monotonic()))
    alive = [t.name for t in threads if t.is_alive()]
    status = client.status(exp)
    client.close()
    assert not alive, f"client threads still running: {alive}"
    assert not errors, errors
    assert status.observations == BUDGET
    assert len(ids) == BUDGET and len(set(ids)) == BUDGET
    assert "pump_error" not in status.pump
    ran = {name for _, name in calls}
    assert {op for op, _ in calls} >= {"cholesky", "gp_ei"}, calls[:5]
    allowed = _pool_names(workers)
    assert ran <= allowed, f"GP numerics ran on {sorted(ran - allowed)}"
    assert len(ran) <= workers + card_pool.THREADS


def test_confined_reraises_in_the_caller():
    @card_pool.confined
    def boom():
        raise ValueError(threading.current_thread().name)

    with pytest.raises(ValueError, match=card_pool.PREFIX):
        boom()


def test_nested_confined_calls_run_inline_without_deadlock():
    @card_pool.confined
    def inner():
        return threading.current_thread().name

    @card_pool.confined
    def outer():
        time.sleep(0.01)
        return threading.current_thread().name, inner()

    got, errors = [], []

    def call():
        try:
            got.append(outer())
        except Exception as e:  # asserted on after the join
            errors.append(e)

    threads = [threading.Thread(target=call)
               for _ in range(4 * card_pool.THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30.0)
    assert not any(t.is_alive() for t in threads), "confined calls hung"
    assert not errors, errors
    assert len(got) == len(threads)
    for outer_name, inner_name in got:
        assert outer_name == inner_name
        assert outer_name.startswith(card_pool.PREFIX + "_")


def test_confined_keeps_the_callers_grad_mode():
    @card_pool.confined
    def grad_on():
        return torch.is_grad_enabled()

    with torch.no_grad():
        assert grad_on() is False
    assert grad_on() is True


def test_enrolled_thread_runs_inline():
    out = []

    def worker():
        card_pool.enroll()
        out.append(card_pool.run(
            lambda: threading.current_thread().name))

    t = threading.Thread(target=worker, name="enrolled-worker")
    t.start()
    t.join(30.0)
    assert not t.is_alive()
    assert out == ["enrolled-worker"]


def test_stats_count_each_handoff_once():
    @card_pool.confined
    def inner():
        time.sleep(0.01)
        return threading.current_thread().name

    @card_pool.confined
    def outer():
        return inner()

    before = card_pool.stats()
    assert outer().startswith(card_pool.PREFIX + "_")
    after = card_pool.stats()
    # the nested call ran inline on the pool's thread: one hand-off
    assert after["handoffs"] - before["handoffs"] == 1
    waited = after["waited_s"] - before["waited_s"]
    queued = after["queued_s"] - before["queued_s"]
    assert 0.0 <= queued <= waited
    assert waited >= 0.01


#: public functions of ``core/suggest/gp.py`` that take no cuBLAS or
#: cuSOLVER handle: sizes, subsets, and tensors moved to and from the card
NO_LIBRARY_HANDLE = {"bucket_size", "lane_pad", "sparse_subset", "to_numpy",
                     "params_from_numpy", "posterior_from_numpy"}


def test_every_gp_function_that_computes_is_confined():
    from repro_torch.core.suggest import gp
    public = {name for name, fn in vars(gp).items()
              if inspect.isfunction(fn) and not name.startswith("_")
              and fn.__module__ == gp.__name__}
    assert NO_LIBRARY_HANDLE <= public
    loose = sorted(name for name in public - NO_LIBRARY_HANDLE
                   if not getattr(vars(gp)[name], "confined", False))
    assert not loose, f"gp.py functions outside the fixed set: {loose}"
