"""The port's GP kernel layer against the JAX reference's oracles.

The torch oracles in ``repro_torch.kernels.ref`` are held against
``repro.kernels.ref`` on the same float32 inputs (made with numpy), on the
reference kernel tests' ``_gp_case`` shapes (b = 16) and on b = 64; the
port's autograd ``gp_nll`` (forward plain on the CPU, analytic backward)
is held against autograd through the oracle.  The CUDA kernels themselves
run only on the card: their test skips here and runs under
``python3 chip_smoke.py`` / pytest on a machine with one.  The blocked
``gp_nll`` kernel's order of operations (32-column panels, the diagonal
block, the panel rows, the trailing update) is emulated in plain torch
and held against the Pallas kernel in interpret mode and the JAX oracle,
and so is the ``gp_ei`` kernel's (8-candidate tiles, 32-row panels, each
panel's update split over the lanes and summed in a reduce-scatter, the
diagonal blocks' inverses), and its one-panel kernel's for b <= 32 (one
candidate a thread, substituting row by row).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import gp as jgp
from repro.kernels import ref as jref
from repro_torch.kernels import gp as kgp
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is enough, and the suite runs
    beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gp_case(k=3, b=16, d=3, seed=0):
    """k lanes over a b-bucket with distinct masked sizes (incl. one
    nearly-empty lane) — hyperparams spread across the clamp range."""
    rng = np.random.default_rng(seed)
    x = rng.random((k, b, d)).astype(np.float32)
    y = rng.standard_normal((k, b)).astype(np.float32)
    ns = [b, max(2, b // 2), 2][:k] + [b] * max(0, k - 3)
    mask = np.zeros((k, b), np.float32)
    for i, n in enumerate(ns):
        mask[i, :n] = 1.0
    log_ls = rng.uniform(-1.5, 0.5, (k, d)).astype(np.float32)
    log_amp = rng.uniform(-0.5, 0.5, (k,)).astype(np.float32)
    log_noise = rng.uniform(-3.0, -1.0, (k,)).astype(np.float32)
    return log_ls, log_amp, log_noise, x, y, mask


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _posterior_factors(ll, la, ln, x, y, mask, seed=2):
    """Each lane's chol/alpha as the optimizer builds them (numpy f32),
    plus (y_mean, y_std, cand, best)."""
    k, b, d = x.shape
    cov = jax.vmap(jref._matern52)(x, x, ll, la)
    noise2 = np.exp(2.0 * ln) + 1e-5
    eye = np.eye(b, dtype=np.float32)
    mm = mask[:, :, None] * mask[:, None, :]
    cov = (np.asarray(cov) + noise2[:, None, None] * eye) * mm \
        + (1.0 - mask)[:, :, None] * eye
    chol = np.asarray(jnp.linalg.cholesky(jnp.asarray(cov, jnp.float32)))
    alpha = np.asarray(jax.vmap(
        lambda L, v: jax.scipy.linalg.cho_solve((L, True), v))(
            chol, y * mask))
    rng = np.random.default_rng(seed)
    y_mean = rng.standard_normal(k).astype(np.float32)
    y_std = rng.uniform(0.5, 2.0, k).astype(np.float32)
    cand = rng.random((k, 8, d)).astype(np.float32)
    best = rng.standard_normal(k).astype(np.float32)
    return chol, alpha, y_mean, y_std, cand, best


@pytest.mark.parametrize("b", [16, 64])
def test_gp_nll_ref_matches_jax(b):
    """float32 Cholesky round-off over a b-long factorization; the NLL is
    O(10-100), so rtol 1e-5 with atol 1e-4 for the near-empty lane."""
    case = _gp_case(b=b)
    got = ref.gp_nll_ref(*_t(*case)).numpy()
    want = np.asarray(jref.gp_nll_ref(*case))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("b", [16, 64])
def test_gp_nll_grads_ref_matches_jax(b):
    """Two float32 programs of the same adjoint (K⁻¹ assembled from an
    explicit triangular inverse): agreement to 1e-4 of the gradient."""
    case = _gp_case(b=b)
    got = ref.gp_nll_grads_ref(*_t(*case))
    want = jref.gp_nll_grads_ref(*case)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("b", [16, 64])
def test_gp_ei_ref_matches_jax(b):
    """Same factors in, same closed form out: one triangular solve of
    float32 round-off apart (atol/rtol 1e-5)."""
    ll, la, ln, x, y, mask = _gp_case(b=b)
    factors = _posterior_factors(ll, la, ln, x, y, mask)
    args = (ll, la, x, mask) + factors
    got = ref.gp_ei_ref(*_t(*args)).numpy()
    want = np.asarray(jref.gp_ei_ref(*args))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b", [16, 64])
def test_gp_nll_autograd_backward_matches_autodiff(b):
    """The port's ``gp_nll`` autograd Function (analytic backward from
    the forward's L and z residuals) against torch.autograd through the
    plain oracle: two derivations of one gradient in float32, atol/rtol
    1e-3 (the reference holds its Pallas backward to 1e-2)."""
    ll, la, ln, x, y, mask = _t(*_gp_case(b=b, seed=1))
    got = ops.gp_fit_grads(ll, la, ln, x, y, mask, force_kernel=True)
    leaves = [t.clone().requires_grad_() for t in (ll, la, ln)]
    want = torch.autograd.grad(
        ref.gp_nll_ref(*leaves, x, y, mask).sum(), leaves)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                   atol=1e-3)
    # the forward value through the Function equals the oracle's
    np.testing.assert_allclose(
        ops.gp_neg_mll(ll, la, ln, x, y, mask, force_kernel=True).numpy(),
        ref.gp_nll_ref(ll, la, ln, x, y, mask).numpy(), rtol=1e-5,
        atol=1e-4)


def test_gp_nll_backward_y_cotangent():
    """dNLL/dy from the analytic backward is K⁻¹(y·m)·m — autograd
    through the oracle gives the same (y is the one data input with an
    exact cotangent)."""
    ll, la, ln, x, y, mask = _t(*_gp_case(seed=3))
    yg = y.clone().requires_grad_()
    got, = torch.autograd.grad(kgp.gp_nll(ll, la, ln, x, yg, mask).sum(),
                               yg)
    yw = y.clone().requires_grad_()
    want, = torch.autograd.grad(ref.gp_nll_ref(ll, la, ln, x, yw,
                                               mask).sum(), yw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("path", ["oracle", "autograd"])
def test_inert_lane_has_zero_gradients(path):
    """All-zero-mask lanes (batch padding) must contribute exactly zero
    gradient, through both gradient implementations of
    ``ops.gp_fit_grads``."""
    ll, la, ln, x, y, mask = _t(*_gp_case())
    mask[1] = 0.0
    g_ll, g_la, g_ln = ops.gp_fit_grads(ll, la, ln, x, y, mask,
                                        force_kernel=(path == "autograd"))
    assert float(g_ll[1].abs().max()) == 0.0
    assert float(g_la[1]) == 0.0
    assert float(g_ln[1]) == 0.0


def test_plain_nll_chol_residuals():
    """``gp_nll_chol_plain`` (what the CUDA kernel is held against):
    L is the lower factor of the masked covariance with exact zeros above
    the diagonal and identity rows at the padding, and z = L⁻¹(y·m)."""
    ll, la, ln, x, y, mask = _t(*_gp_case())
    nll, L, z = kgp.gp_nll_chol_plain(ll, la, ln, x, y, mask)
    cov = ref.masked_cov(ll, la, ln, x, mask)
    np.testing.assert_allclose((L @ L.transpose(1, 2)).numpy(), cov.numpy(),
                               atol=1e-5)
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    pad = mask[2] == 0
    assert torch.equal(L[2][pad][:, pad], torch.eye(int(pad.sum())))
    np.testing.assert_allclose((L @ z[..., None])[..., 0].numpy(),
                               (y * mask).numpy(), atol=1e-5)
    np.testing.assert_allclose(nll.numpy(),
                               ref.gp_nll_ref(ll, la, ln, x, y, mask).numpy(),
                               rtol=1e-5, atol=1e-4)


def test_kernel_wrappers_reject_bad_inputs():
    """On a CUDA tensor a wrapper launches or raises; on a device with
    no kernel it raises instead of quietly falling back."""
    ll, la, ln, x, y, mask = _t(*_gp_case())
    meta = [t.to("meta") for t in (ll, la, ln, x, y, mask)]
    with pytest.raises(ValueError, match="no kernel"):
        kgp.gp_nll_chol(*meta)
    with pytest.raises(TypeError):
        kgp._check("x", x.double(), x.shape, x.device)
    with pytest.raises(ValueError, match="contiguous"):
        kgp._check("x", x.transpose(1, 2).contiguous().transpose(1, 2),
                   x.shape, x.device)


def test_cuda_kernels_match_oracles():
    """The hand-written CUDA kernels against their plain versions on the
    card (b = 16 and 64, ragged masks): rtol 1e-4 of the max-norm; gp_ei
    also at b = 32 (its one-panel kernel), 37 and 100 (1e-3 past b = 64),
    and at b = 6016, where V's tile is in global scratch: there both
    float32 substitutions drift from the float64 one by more than 1e-3,
    so the kernel is held to it, no further than 1e-3 or twice the plain
    version, as chip_smoke.py holds it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for b in (16, 64):
        ll, la, ln, x, y, mask = (t.to(dev) for t in _t(*_gp_case(b=b)))
        got = kgp.gp_nll_chol(ll, la, ln, x, y, mask)
        want = kgp.gp_nll_chol_plain(ll, la, ln, x, y, mask)
        for g, w in zip(got, want):
            assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
        case = _gp_case(b=b)
        factors = _posterior_factors(*case)
        args = [t.to(dev) for t in _t(case[0], case[1], case[3], case[5],
                                      *factors)]
        ei, ei_ref = kgp.gp_ei(*args), ref.gp_ei_ref(*args)
        assert float((ei - ei_ref).abs().max()) <= \
            1e-4 * float(ei_ref.abs().max())
    # gp_ei's panel edges: a 5-row last panel with rows not 16-byte
    # aligned, a 4-row one, 13 candidates (a last tile of 5), a zero lane
    for b in (32, 37, 100):
        args = [t.to(dev) for t in _t(*_ei_case(b, seed=3))]
        ei, ei_ref = kgp.gp_ei(*args), ref.gp_ei_ref(*args)
        assert float((ei - ei_ref).abs().max()) <= \
            (1e-4 if b <= 64 else 1e-3) * float(ei_ref.abs().max())
    # the first bucket past what shared memory holds of V's tile at d = 3
    ll, la, ln, x, y, mask = (t.to(dev) for t in _t(*_gp_case(k=1, b=6016)))
    chol = ref.cholesky(ref.masked_cov(ll, la, ln, x, mask))
    alpha = torch.cholesky_solve((y * mask)[..., None], chol)[..., 0]
    rng = np.random.default_rng(4)
    y_mean, y_std, cand, best = (t.to(dev) for t in _t(
        np.float32([0.3]), np.float32([1.5]),
        rng.random((1, 200, 3)).astype(np.float32), np.float32([-0.2])))
    args = (ll, la, x, mask, chol, alpha.contiguous(), y_mean, y_std, cand,
            best)
    ei, ei_ref = kgp.gp_ei(*args), ref.gp_ei_ref(*args)
    o64 = ref.gp_ei_ref(*(a.double() for a in args))
    scale = float(o64.abs().max())
    err = float((ei.double() - o64).abs().max()) / scale
    p_err = float((ei_ref.double() - o64).abs().max()) / scale
    assert err <= max(1e-3, 2.0 * p_err)


# ------------------------------------------- the blocked kernel's arithmetic
def _blocked_nll_chol(log_ls, log_amp, log_noise, x, y, mask, nb=32):
    """Plain-torch emulation of the blocked ``gp_nll`` kernel's order
    (``csrc/gp_nll.cu``): per panel of nb columns, the diagonal block
    factored column by column with its part of the forward solve, the
    panel rows below it solved against it (each column scaled by
    sqrt(max(pivot, 1e-10)), as the reference's column loop) with the
    right-hand side's update, then the rank-nb update of the trailing
    lower triangle.  The panel rows are swept column by column, each
    scaled column taken at once out of the columns right of it, as the
    kernel's threads do.  Returns (nll, L, z) in float32."""
    A = ref.masked_cov(log_ls, log_amp, log_noise, x, mask).clone()
    k, b, _ = x.shape
    z = y * mask
    quad = torch.zeros(k)
    logdet = torch.zeros(k)
    for j0 in range(0, b, nb):
        j1 = min(j0 + nb, b)
        sd = torch.zeros(k, j1 - j0)
        for c in range(j0, j1):            # the diagonal block
            a = A[:, c, c].clone()
            s = torch.sqrt(torch.clamp(a, min=1e-10))
            sd[:, c - j0] = s
            A[:, c, c] = a / s
            z[:, c] = z[:, c] / A[:, c, c]
            A[:, c + 1:j1, c] = A[:, c + 1:j1, c] / s[:, None]
            z[:, c + 1:j1] -= A[:, c + 1:j1, c] * z[:, c:c + 1]
            A[:, c + 1:j1, c + 1:j1] -= (A[:, c + 1:j1, c, None]
                                         * A[:, None, c + 1:j1, c])
        quad += (z[:, j0:j1] ** 2).sum(-1)
        logdet += torch.log(torch.diagonal(A[:, j0:j1, j0:j1], 0, 1,
                                           2)).sum(-1)
        for c in range(j0, j1):            # the panel rows below (TRSM)
            A[:, j1:, c] /= sd[:, c - j0, None]
            z[:, j1:] -= A[:, j1:, c] * z[:, c:c + 1]
            A[:, j1:, c + 1:j1] -= A[:, j1:, c, None] * A[:, None, c + 1:j1, c]
        A[:, j1:, j1:] -= A[:, j1:, j0:j1] @ A[:, j1:, j0:j1].transpose(1, 2)
    L = torch.tril(A)
    nll = 0.5 * quad + logdet + 0.5 * mask.sum(-1) * ref._LOG_2PI
    return nll, L, z


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("b", [16, 48, 64])
def test_blocked_cholesky_matches_pallas_kernel(b):
    """The blocked kernel's order against the reference Pallas kernel
    (interpret mode) on the same ragged lanes: b = 16 is a single panel
    narrower than nb, b = 48 ends in a half panel.  Held to chip_smoke's
    phase-2 limit for b <= 64: 1e-4 of the max-norm, for nll, L and z."""
    case = _gp_case(k=3, b=b, seed=b)
    got = _blocked_nll_chol(*_t(*case))
    want = jgp.gp_nll_chol(*(jnp.asarray(a) for a in case), interpret=True)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= 1e-4


@pytest.mark.parametrize("b,nb", [(256, 32), (200, 32), (256, 64)])
def test_blocked_cholesky_matches_reference_at_a_larger_bucket(b, nb):
    """Several panels and a trailing update that spans many 64-wide
    tiles, against the JAX oracle's NLL and its factor
    (``jnp.linalg.cholesky`` of the same masked covariance): phase 2's
    limit for b > 64, 1e-3 of the max-norm."""
    case = _gp_case(k=3, b=b, seed=b + nb)
    nll, L, z = _blocked_nll_chol(*_t(*case), nb=nb)
    assert _rel(nll.numpy(), np.asarray(jref.gp_nll_ref(*case))) <= 1e-3
    ll, la, ln, x, y, mask = case
    cov = np.asarray(ref.masked_cov(*_t(ll, la, ln, x, mask)))
    want_L = np.asarray(jnp.linalg.cholesky(jnp.asarray(cov)))
    assert _rel(L.numpy(), want_L) <= 1e-3
    want_z = np.stack([np.asarray(jax.scipy.linalg.solve_triangular(
        want_L[i], y[i] * mask[i], lower=True)) for i in range(len(y))])
    assert _rel(z.numpy(), want_z) <= 1e-3


# ------------------------------------------------ the gp_ei kernel's order
def _diag_inverses(L, b, nb):
    """Each nb x nb diagonal block of L inverted as the kernel's first
    kernel does it: column j by substitution against e_j, dividing by the
    pivot; rows past b are identity.  L (k, bp, bp) -> (k, bp/nb, nb, nb)."""
    k, bp, _ = L.shape
    out = torch.zeros(k, bp // nb, nb, nb)
    for p in range(bp // nb):
        r0 = p * nb
        A = L[:, r0:r0 + nb, r0:r0 + nb].clone()
        pad = torch.arange(r0, r0 + nb) >= b
        A[:, pad, :] = 0.0
        A[:, pad, pad] = 1.0
        s = torch.eye(nb).expand(k, nb, nb).clone()   # s[:, i, j]: column j
        for t in range(nb):
            s[:, t] = s[:, t] / A[:, t, t, None]
            s[:, t + 1:] -= A[:, t + 1:, t, None] * s[:, t, None, :]
        out[:, p] = s
    return out


def _scaled_kq(log_ls, log_amp, x, mask, cand):
    """kq (k, m, b) as both ``gp_ei`` kernels build it: the points scaled
    by exp(log_ls) once, |c|² − 2c·x + |x|² summed over the dimensions in
    order, then the Matérn-5/2 polynomial times the mask."""
    k, b, d = x.shape
    ls = torch.exp(log_ls)[:, None, :]
    cs, xs = cand / ls, x / ls
    cc = torch.zeros(k, cand.shape[1])
    xx = torch.zeros(k, b)
    cx = torch.zeros(k, cand.shape[1], b)
    for u in range(d):
        cc = cc + cs[..., u] * cs[..., u]
        xx = xx + xs[..., u] * xs[..., u]
        cx = cx + cs[:, :, None, u] * xs[:, None, :, u]
    sq = torch.clamp(cc[:, :, None] - 2.0 * cx + xx[:, None, :], min=0.0)
    r = torch.sqrt(sq + 1e-12)
    s5r = 5.0 ** 0.5 * r
    amp2 = torch.exp(2.0 * log_amp)
    return (amp2[:, None, None] * (1.0 + s5r + (5.0 / 3.0) * r * r)
            * torch.exp(-s5r) * mask[:, None, :])


def _row_ei(log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std, cand,
            best, xi=0.01):
    """Plain-torch emulation of the one-panel kernel's order
    (``csrc/gp_ei.cu`` small_kernel, b <= 32): each candidate alone, μ
    summed row by row, then V = L⁻¹kqᵀ substituted row by row, row i's
    sum over j < i in order and divided by the pivot.  Returns ei (k, m)
    in float32."""
    k, b, _ = x.shape
    kq = _scaled_kq(log_ls, log_amp, x, mask, cand)      # (k, m, b)
    mu = torch.zeros(kq.shape[:2])
    for j in range(b):
        mu = mu + kq[..., j] * alpha[:, j, None]
    v = torch.zeros_like(kq)
    for i in range(b):
        t = kq[..., i]
        for j in range(i):
            t = t - chol[:, i, j, None] * v[..., j]
        v[..., i] = t / chol[:, i, i, None]
    return ref.ei_closed_form(mu, v.transpose(1, 2), log_amp, y_mean, y_std,
                              best, xi)


def _panel_ei(log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std, cand,
              best, xi=0.01, tc=kgp.EI_TILE, nb=kgp.EI_PANEL):
    """Plain-torch emulation of the ``gp_ei`` kernel's order
    (``csrc/gp_ei.cu``): candidates in tiles of ``tc`` (the last tile
    padded with the last candidate, dropped at the end), kq from the
    scaled points, V = L⁻¹kqᵀ in panels of ``nb`` rows.  A panel's update
    L[p, :p]·V[:p] is split over the inner dimension as the warps' lanes
    split it, k = lane mod 32, each lane summing its k in order, and the
    32 partial sums meet in the reduce-scatter's tree (lanes paired on
    bit 4, then 3, 2, 1, 0); then V_p = L_pp⁻¹·(kq_p − update), with the
    diagonal block's inverse from ``_diag_inverses`` and four partial sums
    over j mod 4.  The kernel inverts the diagonal blocks instead of
    substituting row by row: that chain of b dependent steps cost a third
    of it.  Returns ei (k, m) in float32."""
    k, b, d = x.shape
    m = cand.shape[1]
    mp = -(-m // tc) * tc
    cand = torch.cat([cand, cand[:, -1:].expand(k, mp - m, d)], 1)
    kq = _scaled_kq(log_ls, log_amp, x, mask, cand)      # (k, mp, b)
    amp2 = torch.exp(2.0 * log_amp)
    mu = (kq * alpha[:, None, :]).sum(-1)
    bp = -(-b // nb) * nb
    L = torch.zeros(k, bp, bp)
    L[:, :b, :b] = chol
    linv = _diag_inverses(L, b, nb)
    V = torch.zeros(k, bp, mp)
    V[:, :b] = kq.transpose(1, 2)                         # kq, then V
    ss = torch.zeros(k, mp)
    for p in range(bp // nb):
        rows = slice(p * nb, (p + 1) * nb)
        part = torch.zeros(k, nb, nb, mp)                 # (row, lane, cand)
        for q in range(p):
            cols = slice(q * nb, (q + 1) * nb)
            part = part + L[:, rows, cols, None] * V[:, None, cols, :]
        for h in (16, 8, 4, 2, 1):
            part = part[:, :, :h] + part[:, :, h:2 * h]
        rr = V[:, rows] - part[:, :, 0]
        vp = [torch.zeros(k, nb, mp) for _ in range(4)]
        for j in range(nb):
            vp[j % 4] = vp[j % 4] + linv[:, p, :, j, None] * rr[:, None, j]
        V[:, rows] = (vp[0] + vp[1]) + (vp[2] + vp[3])
        ss = ss + (V[:, rows] ** 2).sum(1)
    var = torch.clamp(amp2[:, None] - ss, min=1e-12)[:, :m]
    mean = mu[:, :m] * y_std[:, None] + y_mean[:, None]
    sd = torch.sqrt(var) * y_std[:, None]
    imp = mean - best[:, None] - xi
    z = imp / sd
    ncdf = 0.5 * (1.0 + torch.erf(z / 2.0 ** 0.5))
    npdf = torch.exp(-0.5 * z * z) / (2.0 * np.pi) ** 0.5
    return imp * ncdf + sd * npdf


def _ei_case(b, k=4, m=13, seed=0):
    """k lanes (full, half, 2 points, and an all-zero-mask lane) with
    their posterior factors and m candidates (not a multiple of the tile):
    the arguments of ``gp_ei`` as numpy float32."""
    ll, la, ln, x, y, mask = _gp_case(k=k, b=b, seed=seed)
    mask[k - 1] = 0.0
    chol, alpha, y_mean, y_std, _, best = _posterior_factors(ll, la, ln, x, y,
                                                             mask, seed + 1)
    cand = np.random.default_rng(seed + 2).random((k, m, x.shape[-1]))
    return (ll, la, x, mask, chol, alpha, y_mean, y_std,
            cand.astype(np.float32), best)


@pytest.mark.parametrize("b", [16, 64])
def test_gp_ei_panel_order_matches_reference_and_pallas(b):
    """The kernel's order against the JAX oracle and the Pallas kernel in
    interpret mode on ragged lanes and an all-zero-mask lane: b = 16 is a
    panel that b does not fill, b = 64 two panels.  Held to chip_smoke's
    phase-2 limit for b <= 64: 1e-4 of the max-norm.  The seed gives the
    full lane EI of order 1, so the second panel's update shows in the
    max-norm (a lane whose EI is all ~0 would hide it)."""
    args = _ei_case(b, seed=3)
    got = _panel_ei(*_t(*args)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, np.asarray(jref.gp_ei_ref(*args))) <= 1e-4
    pal = jgp.gp_ei(*(jnp.asarray(a) for a in args), interpret=True)
    assert _rel(got, np.asarray(pal)) <= 1e-4


@pytest.mark.parametrize("b", [16, 32])
def test_gp_ei_one_panel_order_matches_reference_and_pallas(b):
    """The one-panel kernel's order (buckets b <= 32: a panel b does not
    fill, and a full one) against the JAX oracle and the Pallas kernel in
    interpret mode, on ragged lanes and an all-zero-mask lane: phase 2's
    limit for b <= 64, 1e-4 of the max-norm."""
    args = _ei_case(b, seed=3)
    got = _row_ei(*_t(*args)).numpy()
    assert np.isfinite(got).all()
    assert _rel(got, np.asarray(jref.gp_ei_ref(*args))) <= 1e-4
    pal = jgp.gp_ei(*(jnp.asarray(a) for a in args), interpret=True)
    assert _rel(got, np.asarray(pal)) <= 1e-4


def test_gp_ei_panel_order_at_a_larger_bucket():
    """Eight panels of updates, b = 256 and 96 candidates, against the JAX
    oracle: phase 2's limit for b > 64, 1e-3 of the max-norm."""
    args = _ei_case(256, k=3, m=96, seed=7)
    got = _panel_ei(*_t(*args)).numpy()
    assert _rel(got, np.asarray(jref.gp_ei_ref(*args))) <= 1e-3
