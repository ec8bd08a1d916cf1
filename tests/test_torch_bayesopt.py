"""The port's optimizers against the JAX reference's on the CPU: the
numpy random streams stay identical (random-phase suggestions, candidate
pools, the numpy-only optimizers), and with the same hyperparameters
installed both ``BayesOpt``s pick the same points."""
import copy

import numpy as np
import torch
import pytest

from repro.core.space import Param as RefParam
from repro.core.space import Space as RefSpace
from repro.core.suggest import Observation as RefObservation
from repro.core.suggest import make_optimizer as ref_make
from repro.core.suggest.bayesopt import LIE_KEY
from repro_torch.core.space import Param, Space, strip_internal
from repro_torch.core.suggest import Observation, gp, make_optimizer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is enough, and the suite runs
    beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _space(P=Param, S=Space):
    return S([P("lr", "double", 1e-4, 3e-1, log=True),
              P("momentum", "double", 0.0, 0.99),
              P("fc_width", "int", 32, 256)])


def _f(a):
    return -((np.log10(a["lr"]) + 1.5) ** 2 + (a["momentum"] - 0.9) ** 2
             + ((a["fc_width"] - 160) / 160.0) ** 2)


def _clean(points):
    return [strip_internal(a) for a in points]


OPTS = dict(n_init=6, candidates=64, fit_steps=20, warm_fit_steps=8)


def _pair(name="gp", seed=3, **opts):
    port = make_optimizer(name, _space(), seed=seed, device="cpu", **opts)
    ref = ref_make(name, _space(RefParam, RefSpace), seed=seed, **opts)
    return port, ref


def _tell_both(port, ref, points):
    port.tell([Observation(a, _f(strip_internal(a))) for a in points])
    ref.tell([RefObservation(a, _f(strip_internal(a))) for a in points])


@pytest.mark.parametrize("name", ["random", "sobol", "grid", "evolution",
                                  "pso"])
def test_numpy_optimizers_stream_identically(name):
    """The numpy-only optimizers are copies: the same seed gives the
    same suggestion stream, observations included.  ``device`` is
    accepted and ignored."""
    port, ref = _pair(name, seed=5)
    for _ in range(3):
        a, b = port.ask(4), ref.ask(4)
        assert _clean(a) == _clean(b)
        port.tell([Observation(x, _f(strip_internal(x))) for x in a])
        ref.tell([RefObservation(x, _f(strip_internal(x))) for x in b])


def test_random_phase_and_candidate_pools_identical():
    port, ref = _pair(**OPTS)
    a, b = port.ask(6), ref.ask(6)
    assert _clean(a) == _clean(b)
    _tell_both(port, ref, a)
    np.testing.assert_array_equal(port._candidates(), ref._candidates())


def test_same_hyperparameters_give_same_picks():
    """Both optimizers get the same history and the reference's fitted
    hyperparameters installed through the deferred-fit hook, then ask
    exactly (recondition at those hyperparameters, q-EI over an
    identical pool).  Picks must be equal — or, where float32 round-off
    splits a near-tie, the reference's EI at the port's pick must be
    within 1e-5 relative of its maximum."""
    from repro.core.suggest import gp as jgp
    port, ref = _pair(**OPTS)
    for a, b in zip(port.ask(6), ref.ask(6)):     # the random phase
        port.tell([Observation(a, _f(strip_internal(a)))])
        ref.tell([RefObservation(b, _f(strip_internal(b)))])
    # the first model-phase batch: both observe the reference's points
    # (the port's own picks are retired), so the histories stay equal
    points = ref.ask(4)
    for a in port.ask(4):
        port.forget(a)
    port.tell([Observation(strip_internal(a), _f(strip_internal(a)))
               for a in points])
    ref.tell([RefObservation(a, _f(strip_internal(a))) for a in points])
    for opt in (port, ref):
        opt.defer_fits = True
    rspec, pspec = ref.fit_spec(), port.fit_spec()
    rparams = jgp.fit_gp(rspec.x, rspec.y, steps=20).params
    rspec.install(rparams, 0.0)
    pspec.install(gp.params_from_numpy(*map(np.asarray, rparams),
                                       device="cpu"), 0.0)
    before = copy.deepcopy(ref)
    got, want = port.ask(5), ref.ask(5)
    if _clean(got) == _clean(want):
        return
    # a near-tie: replay the reference's ask and score the port's pick
    before._recondition(extra=5)
    cand = before._candidates()
    best = np.float32(max(before._ys))

    def index(opt, assignment):
        u = opt._pending[assignment[LIE_KEY]]
        return int(np.argmin(np.abs(cand - u).sum(1)))
    picks = [index(port, g) for g in got]
    wants = [index(ref, w) for w in want]
    i = int(np.argmax(np.asarray(picks) != np.asarray(wants)))
    post = before._post
    for j in wants[:i]:
        post = jgp.append_lie(post, cand[j])
    ei = np.array(jgp.expected_improvement(post, cand, best))
    ei[wants[:i]] = -np.inf
    assert ei[picks[i]] >= ei.max() - 1e-5 * abs(ei.max()), (picks, wants)


def test_lie_tokens_and_pending_retire_like_reference():
    port, ref = _pair(**OPTS)
    a = port.ask(3)
    ref.ask(3)
    assert all(LIE_KEY in x for x in a)
    assert len(port._pending) == 3
    port.tell([Observation(a[0], 0.5)])
    port.forget(a[1])
    assert len(port._pending) == 1
