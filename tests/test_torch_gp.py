"""The port's GP numerics (``repro_torch.core.suggest.gp``) against the
JAX reference (``repro.core.suggest.gp``) on the CPU, float32 on both
sides, plus the reference's own invariants re-asserted on the port.

Inputs are made with numpy and fed to both packages; posteriors and
parameters cross between them as numpy arrays (``posterior_from_numpy``,
``params_from_numpy``, ``to_numpy``)."""
import jax
import numpy as np
import pytest
import torch

from repro.core.suggest import gp as jgp
from repro_torch.core.suggest import gp

CPU = "cpu"
D = 3
BUCKET = 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is enough, and the suite runs
    beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.random((14, D))
    y = np.sin(3.0 * x @ rng.random(D)) + 0.1 * rng.standard_normal(14)
    # a pool size no reference test uses: the JAX side's jit caches are
    # process-wide, and reference tests count their own compiles
    cand = rng.random((48, D)).astype(np.float32)
    return x, y, cand


@pytest.fixture(scope="module")
def ref_post(data):
    """A fitted reference posterior (the fixture every comparison shares,
    so the JAX side compiles once)."""
    x, y, _ = data
    return jgp.fit_gp(x, y, steps=40, bucket=BUCKET)


@pytest.fixture(scope="module")
def port_post(ref_post):
    """The reference posterior carried into the port."""
    return gp.posterior_from_numpy(
        jax.tree.map(np.asarray, ref_post._asdict()), device=CPU)


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
                      else t)


def test_bucket_and_lane_pads_match_reference():
    for n in (1, 15, 16, 17, 100, 300, 513):
        assert gp.bucket_size(n) == jgp.bucket_size(n)
    for k in (1, 2, 3, 5, 16, 17):
        assert gp.lane_pad(k) == jgp.lane_pad(k)
    for n, best, m in ((10, 3, 64), (300, 17, 64), (300, 299, 16)):
        np.testing.assert_array_equal(gp.sparse_subset(n, best, m),
                                      jgp.sparse_subset(n, best, m))


def test_posterior_leaves_match_reference_at_fixed_params(ref_post, data):
    """``make_posterior`` at the reference's fitted hyperparameters: one
    float32 Cholesky and solve apart (atol 1e-4)."""
    x, y, _ = data
    params = gp.params_from_numpy(*map(np.asarray, ref_post.params),
                                  device=CPU)
    got = gp.make_posterior(params, x, y, bucket=BUCKET)
    want = jgp.make_posterior(ref_post.params, x, y, bucket=BUCKET)
    for f in ("x", "mask", "y", "chol", "alpha", "y_mean", "y_std"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=1e-4)


def test_fit_gp_matches_reference(ref_post, data):
    """40 Adam steps through autograd of the torch neg-MLL against 40
    through jax.grad: float32 gradient round-off compounds through the
    optimizer, so the fitted parameters agree to atol 1e-3."""
    x, y, _ = data
    got = gp.fit_gp(x, y, steps=40, bucket=BUCKET, device=CPU)
    for g, w in zip(got.params, ref_post.params):
        np.testing.assert_allclose(_np(g), np.asarray(w), atol=1e-3)
    np.testing.assert_allclose(_np(got.chol), np.asarray(ref_post.chol),
                               atol=1e-3)


def test_predict_and_ei_on_carried_posterior(port_post, ref_post, data):
    """Same posterior leaves in: predict and expected_improvement (the
    latter through ``ops.gp_ei``'s one-lane plain path) agree with the
    reference to float32 round-off (atol 1e-5)."""
    _, y, cand = data
    mu, sd = gp.predict(port_post, cand)
    jmu, jsd = jgp.predict(ref_post, cand)
    np.testing.assert_allclose(_np(mu), np.asarray(jmu), atol=1e-5)
    np.testing.assert_allclose(_np(sd), np.asarray(jsd), atol=1e-5)
    best = np.float32(np.max(y))
    np.testing.assert_allclose(
        _np(gp.expected_improvement(port_post, cand, best)),
        np.asarray(jgp.expected_improvement(ref_post, cand, best)),
        atol=1e-5)


def test_to_numpy_round_trip(port_post):
    back = gp.posterior_from_numpy(gp.to_numpy(port_post), device=CPU)
    for a, b in zip(jax.tree.leaves(tuple(back)),
                    jax.tree.leaves(tuple(port_post))):
        assert torch.equal(a, b)


def _assert_tie(ref_post, cand, best, picks, want):
    """Picks must equal the reference's; where they differ, the
    reference's own EI at the port's pick (after the agreed prefix of
    lies) is within 1e-5 relative of its maximum — a tie, not a wrong
    pick."""
    picks, want = np.asarray(picks), np.asarray(want)
    if np.array_equal(picks, want):
        return
    i = int(np.argmax(picks != want))
    post = ref_post
    for j in want[:i]:
        post = jgp.append_lie(post, cand[int(j)])
    ei = np.array(jgp.expected_improvement(post, cand, best))
    ei[want[:i]] = -np.inf
    assert ei[picks[i]] >= ei.max() - 1e-5 * abs(ei.max()), (picks, want)


def test_select_batch_picks_match_reference(port_post, ref_post, data):
    _, y, cand = data
    best = np.float32(np.max(y))
    picks, post = gp.select_batch(port_post, cand, best, 5)
    jpicks, jpost = jgp.select_batch(ref_post, cand, best, 5)
    _assert_tie(ref_post, cand, best, picks, jpicks)
    assert int(_np(post.mask).sum()) == int(np.asarray(jpost.mask).sum())


def test_batched_select_picks_match_reference(port_post, ref_post, data):
    _, y, cand = data
    best = float(np.max(y))
    items = [(port_post, cand, best, 5), (port_post, cand, best, 3)]
    jitems = [(ref_post, cand, best, 5), (ref_post, cand, best, 3)]
    for (picks, _), (jpicks, _) in zip(gp.batched_select(items),
                                       jgp.batched_select(jitems)):
        _assert_tie(ref_post, cand, np.float32(best), picks, jpicks)


def test_batched_select_matches_serial_select(port_post, data):
    """Within the port: the lane-batched scan with its incremental
    factor carry picks exactly what the serial scan picks, and lands on
    the same lie-folded posterior to atol 1e-4."""
    _, y, cand = data
    best = float(np.max(y))
    out = gp.batched_select([(port_post, cand, best, k) for k in (2, 5, 8)])
    for k, (picks, post) in zip((2, 5, 8), out):
        solo_picks, solo = gp.select_batch(port_post, cand, best, k)
        np.testing.assert_array_equal(picks, solo_picks)
        for a, b in zip(jax.tree.leaves(tuple(post)),
                        jax.tree.leaves(tuple(solo))):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4)


def _experiments(k, n=20, seed=0):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(k):
        x = rng.random((n, D))
        y = np.sin(3.0 * x @ rng.random(D)) + 0.1 * rng.standard_normal(n)
        items.append((x, y, None))
    return items


def test_batched_fit_matches_serial_fits():
    """k lanes through one lane-batched loop land on the same
    hyperparameters as k serial fit_gp calls (atol 1e-4): the batched
    analytic adjoint and autograd through the Cholesky are two float32
    derivations of one gradient."""
    items = _experiments(3)
    batched = gp.batched_fit(items, steps=25, bucket=BUCKET, device=CPU)
    for (x, y, _), bp in zip(items, batched):
        post = gp.fit_gp(x, y, steps=25, bucket=BUCKET, device=CPU)
        for a, b in zip(bp, post.params):
            np.testing.assert_allclose(_np(a), _np(b), atol=1e-4)


def test_batched_fit_matches_reference_batched_fit():
    items = _experiments(2, seed=4)
    got = gp.batched_fit(items, steps=[10, 20], bucket=BUCKET, device=CPU)
    want = jgp.batched_fit(items, steps=[10, 20], bucket=BUCKET)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-4)


def test_frozen_lane_is_bit_identical():
    """A lane frozen at its own step budget inside a longer mixed loop
    holds exactly the parameters a uniform run at that budget gives at
    the same lane pad."""
    items = _experiments(2, n=12, seed=1)
    mixed = gp.batched_fit(items, steps=[6, 15], bucket=16, device=CPU)
    lo = gp.batched_fit(items, steps=[6, 6], bucket=16, device=CPU)
    hi = gp.batched_fit(items, steps=[15, 15], bucket=16, device=CPU)
    for got, want in ((mixed[0], lo[0]), (mixed[1], hi[1])):
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_rank1_append_matches_full_cholesky(port_post, data):
    """Folding points one at a time by bordered Cholesky equals a fresh
    posterior over the grown set at the same hyperparameters (≤ 1e-3)."""
    x, y, _ = data
    rng = np.random.default_rng(5)
    xs = rng.random((3, D))
    ys = rng.standard_normal(3)
    post = port_post
    for xn, yn in zip(xs, ys):
        post = gp.append_point(post, xn.astype(np.float32), np.float32(yn))
    full = gp.make_posterior(port_post.params, np.vstack([x, xs]),
                             np.concatenate([y, ys]),
                             y_mean=float(_np(port_post.y_mean)),
                             y_std=float(_np(port_post.y_std)),
                             bucket=BUCKET)
    for f in ("chol", "alpha", "mask", "y"):
        np.testing.assert_allclose(_np(getattr(post, f)),
                                   _np(getattr(full, f)), atol=1e-3)


def test_append_lie_matches_reference(port_post, ref_post):
    xn = np.array([0.3, 0.6, 0.2], np.float32)
    got = gp.append_lie(port_post, xn)
    want = jgp.append_lie(ref_post, xn)
    for f in ("chol", "alpha", "mask", "y", "x"):
        np.testing.assert_allclose(_np(getattr(got, f)),
                                   np.asarray(getattr(want, f)), atol=1e-4)


def test_padding_does_not_change_the_posterior(data):
    """Bucket invariance: the same data padded to 16 or 64 slots predicts
    the same means and deviations."""
    x, y, cand = data
    params = gp.GPParams(torch.full((D,), -0.7), torch.tensor(0.1),
                         torch.tensor(-2.0))
    small = gp.make_posterior(params, x, y, bucket=16)
    big = gp.make_posterior(params, x, y, bucket=64)
    for a, b in zip(gp.predict(small, cand), gp.predict(big, cand)):
        np.testing.assert_allclose(_np(a), _np(b), atol=5e-4)


def test_sparse_posterior_matches_reference(ref_post):
    rng = np.random.default_rng(3)
    x = rng.random((80, D))
    y = np.cos(x.sum(1))
    params = gp.params_from_numpy(*map(np.asarray, ref_post.params),
                                  device=CPU)
    post, idx = gp.sparse_posterior(params, x, y, m=32, extra=4)
    jpost, jidx = jgp.sparse_posterior(ref_post.params, x, y, m=32, extra=4)
    np.testing.assert_array_equal(idx, jidx)
    assert post.capacity == jpost.capacity
    np.testing.assert_allclose(_np(post.alpha), np.asarray(jpost.alpha),
                               atol=1e-4)


def test_gp_functions_resolve_device():
    """numpy-input functions take ``device=``; with none they need CUDA
    (no silent CPU fall-back), the rest follow their tensors."""
    x = np.random.default_rng(0).random((4, D))
    y = np.arange(4.0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            gp.fit_gp(x, y, steps=1)
    post = gp.fit_gp(x, y, steps=1, device=CPU)
    assert post.chol.device.type == "cpu"
    assert gp.append_lie(post, x[0]).chol.device.type == "cpu"
    gp.prewarm_bucket(D, 16, fit_steps=(5,), k_pads=(1, 2), n_cand=8,
                      fit_lanes=(1, 2), select_lanes=(1, 2), device=CPU)
