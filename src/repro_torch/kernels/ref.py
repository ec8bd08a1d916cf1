"""Plain PyTorch oracles for the kernels (the allclose ground truth).

Torch mirrors of ``flash_attention_ref``, ``rglru_scan_ref``,
``_matern52``, ``gp_nll_ref``, ``gp_nll_grads_ref``, ``gp_ei_ref`` and
``int8_quant_ref`` from the JAX package's ``kernels/ref.py``, formula for
formula, so the CPU tests can hold each one against its JAX counterpart
and ``chip_smoke.py`` can hold the CUDA kernels against them on the card.
``flash_attention_bwd_ref`` and ``rglru_scan_bwd_ref`` are the plain
gradients of the two LM kernels (the JAX package has no backward kernel
to mirror; the tests hold them against ``jax.vjp`` of its oracles).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_LOG_2PI = math.log(2.0 * math.pi)
NEG_INF = -2.0 ** 30


def _flash_scores(q, k, causal, window, softcap, scale=None, q_offset=0):
    """Scores of ``flash_attention_ref`` (B,K,G,Sq,Skv) float32: scaled
    (by ``scale``, or over √D when it is None), softcapped, masked with
    ``NEG_INF`` (query row i at position ``q_offset`` + i); and the
    softcap's tanh (None without one), whose 1 − tanh² the gradient
    takes."""
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())
    s = s / math.sqrt(D) if scale is None else s * scale
    t = None
    if softcap:
        t = torch.tanh(s / softcap)
        s = t * softcap
    q_pos = torch.arange(q_offset, q_offset + Sq, device=q.device)[:, None]
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window:
        mask &= (q_pos - kv_pos) < window
    return torch.where(mask, s, NEG_INF), t


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None, return_lse=False, q_offset=0):
    """q: (B,Sq,H,D); k,v: (B,Skv,K,D) -> (B,Sq,H,D).  Dense masked
    softmax attention in float32, out in q's dtype: the function the
    flash kernel must equal.  Scores are scaled by ``scale`` (1/√D when
    None) before the softcap.  Key positions count from 0, query row i
    sits at ``q_offset`` + i (0: the Pallas kernel's layout; a shard of a
    sequence's queries: the shard's first position); masked scores take
    ``NEG_INF``, not -inf.  With ``return_lse`` also the row log-sum-exp
    of the masked scores, (B,H,Sq) float32."""
    B, Sq, H, D = q.shape
    s, _ = _flash_scores(q, k, causal, window, softcap, scale, q_offset)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    out = out.reshape(B, Sq, H, D).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H, Sq)
    return out


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, window=0,
                            softcap=0.0, scale=None, q_offset=0):
    """The gradient of ``flash_attention_ref`` -> (dq, dk, dv) in the
    inputs' dtype, dense and float32 inside: P = exp(s − lse) from the
    forward's lse (masked pairs 0), D = rowsum(dO·O) from its output,
    dS = P (dP − D), times 1 − tanh² under a softcap, times the scale
    (over √D when ``scale`` is None); dk and dv summed over the H/K query
    heads of each KV head; queries at ``q_offset`` onwards, as the
    forward."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    G = H // K
    s, t = _flash_scores(q, k, causal, window, softcap, scale, q_offset)
    p = torch.exp(s - lse.float().reshape(B, K, G, Sq)[..., None])
    qg = q.reshape(B, Sq, K, G, D).float()
    dog = do.reshape(B, Sq, K, G, D).float()
    dvec = (dog * o.reshape(B, Sq, K, G, D).float()).sum(-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    ds = p * (dp - dvec.permute(0, 2, 3, 1)[..., None])
    if t is not None:
        ds = ds * (1.0 - t * t)
    ds = ds / math.sqrt(D) if scale is None else ds * scale
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float())
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def rglru_scan_ref(log_a, b, h0=None):
    """Sequential RG-LRU recurrence h_t = exp(log_a_t)·h_{t-1} + b_t.
    log_a, b: (B,S,R) float32; h0: (B,R), zeros when None -> h (B,S,R)."""
    B, S, R = log_a.shape
    h = (torch.zeros((B, R), dtype=torch.float32, device=log_a.device)
         if h0 is None else h0.float())
    out = torch.empty((B, S, R), dtype=torch.float32, device=log_a.device)
    a = torch.exp(log_a.float())
    for t in range(S):
        h = h * a[:, t] + b[:, t]
        out[:, t] = h
    return out


def rglru_scan_bwd_ref(log_a, h, dh):
    """The gradient of ``rglru_scan_ref`` from h₀ = 0, as a sequential
    loop backwards: g_t = dh_t + a_{t+1}·g_{t+1}, d_b = g and
    d_log_a_t = g_t·a_t·h_{t−1} with h_{−1} = 0.  log_a, the forward's h,
    dh: (B,S,R) float32 -> (d_log_a, d_b)."""
    B, S, R = log_a.shape
    a = torch.exp(log_a.float())
    g = torch.zeros((B, R), dtype=torch.float32, device=log_a.device)
    d_log_a = torch.empty((B, S, R), dtype=torch.float32,
                          device=log_a.device)
    d_b = torch.empty_like(d_log_a)
    for t in range(S - 1, -1, -1):
        g = dh[:, t] + (a[:, t + 1] * g if t + 1 < S else 0.0)
        d_b[:, t] = g
        d_log_a[:, t] = (g * a[:, t] * h[:, t - 1] if t > 0
                         else torch.zeros_like(g))
    return d_log_a, d_b


def _matern52(a, b, log_ls, log_amp):
    """Matérn-5/2 ARD cross-covariance of a (..., n, d) and b (..., m, d)
    -> (..., n, m), with per-row leading dims broadcast (a lane axis).
    Mirrors ``core/suggest/gp.py`` — kernels/ must not import core, so
    the formula is duplicated here and pinned by parity tests."""
    ls = torch.exp(log_ls).unsqueeze(-2)                  # (...,1,d)
    amp2 = torch.exp(2.0 * log_amp)[..., None, None]
    a = a / ls
    b = b / ls
    sq = torch.clamp(
        (a * a).sum(-1)[..., :, None] - 2.0 * a @ b.transpose(-1, -2)
        + (b * b).sum(-1)[..., None, :], min=0.0)
    r = torch.sqrt(sq + 1e-12)
    s5r = math.sqrt(5.0) * r
    return amp2 * (1.0 + s5r + (5.0 / 3.0) * r * r) * torch.exp(-s5r)


def cholesky(cov):
    """Lower Cholesky factor that, like ``jnp.linalg.cholesky``, comes
    out all NaN (value and gradient) for a matrix that is not positive
    definite instead of raising: the fit loops reject a NaN step per
    lane, and no host sync is needed to find out.  Row-major, as the
    CUDA kernels take it (CUDA's factor comes back column-major)."""
    L, info = torch.linalg.cholesky_ex(cov)
    bad = torch.where(info == 0, 0.0, float("nan")).to(L.dtype)
    return (L + bad[..., None, None]).contiguous()


def masked_cov(log_ls, log_amp, log_noise, x, mask):
    """Lane-batched masked covariance: Matérn + noise on the real rows,
    an identity block on the padded ones.  (k,b,d), (k,b) -> (k,b,b)."""
    b = x.shape[-2]
    eye = torch.eye(b, dtype=x.dtype, device=x.device)
    noise2 = (torch.exp(2.0 * log_noise) + 1e-5)[..., None, None]
    k = _matern52(x, x, log_ls, log_amp) + noise2 * eye
    mm = mask[..., :, None] * mask[..., None, :]
    return k * mm + torch.diag_embed(1.0 - mask)


def gp_nll_ref(log_ls, log_amp, log_noise, x, y, mask):
    """Batched masked GP negative log marginal likelihood oracle.

    log_ls (k,d), log_amp (k,), log_noise (k,), x (k,b,d), y (k,b),
    mask (k,b) -> nll (k,).  Padded rows carry an identity block in the
    covariance so each lane's value is independent of the bucket size.
    Plain differentiable torch: the CPU path of ``ops.gp_neg_mll`` and
    the ground truth for the CUDA kernel."""
    cov = masked_cov(log_ls, log_amp, log_noise, x, mask)
    chol = cholesky(cov)
    ym = (y * mask).unsqueeze(-1)
    alpha = torch.cholesky_solve(ym, chol)
    return (0.5 * (ym * alpha).sum((-2, -1))
            + torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)).sum(-1)
            + 0.5 * mask.sum(-1) * _LOG_2PI)


def gp_nll_grads_ref(log_ls, log_amp, log_noise, x, y, mask):
    """Per-lane gradients of ``gp_nll_ref`` w.r.t. the hyperparameters:
    the analytic adjoint dNLL/dθ = tr(S·∂K/∂θ), S = ½(K⁻¹ − αα'),
    written batched and matmul-rich (one Cholesky and one triangular
    solve per lane, every kernel-derivative contraction a batched
    matmul).  Shapes as in ``gp_nll_ref`` -> (g_log_ls (k,d),
    g_log_amp (k,), g_log_noise (k,)).  All-zero-mask lanes get exactly
    zero grads."""
    k, b, d = x.shape
    ls = torch.exp(log_ls)                                # (k,d)
    amp2 = torch.exp(2.0 * log_amp)                       # (k,)
    noise2 = torch.exp(2.0 * log_noise) + 1e-5            # (k,)
    xa = x / ls[:, None, :]                               # (k,b,d)
    q = (xa * xa).sum(-1)                                 # (k,b)
    sq = torch.clamp(q[:, :, None]
                     - 2.0 * torch.einsum("kid,kjd->kij", xa, xa)
                     + q[:, None, :], min=0.0)
    r = torch.sqrt(sq + 1e-12)
    s5r = math.sqrt(5.0) * r
    e = torch.exp(-s5r)
    mat = amp2[:, None, None] * (1.0 + s5r + (5.0 / 3.0) * r * r) * e
    mm = mask[:, :, None] * mask[:, None, :]
    eye = torch.eye(b, dtype=x.dtype, device=x.device)
    cov = (mat + noise2[:, None, None] * eye) * mm \
        + (1.0 - mask)[:, :, None] * eye
    L = cholesky(cov)
    linv = torch.linalg.solve_triangular(L, eye.expand(k, b, b),
                                         upper=False)
    ki = torch.einsum("kji,kjl->kil", linv, linv)         # K⁻¹ = L⁻ᵀL⁻¹
    alpha = torch.einsum("kij,kj->ki", ki, y * mask)
    S = 0.5 * (ki - alpha[:, :, None] * alpha[:, None, :])
    W = S * mm
    # ∂k/∂log_ls_d = amp2·(5/3)(1+√5r)e^{−√5r}·(xa_id − xa_jd)²; V is
    # symmetric, so Σ_ij V_ij(xa_id−xa_jd)² folds into one V@xa matmul
    V = W * (amp2[:, None, None] * (5.0 / 3.0) * (1.0 + s5r) * e)
    rs = V.sum(2)                                         # (k,b)
    vxa = torch.einsum("kij,kjd->kid", V, xa)
    g_ll = 2.0 * (torch.einsum("ki,kid->kd", rs, xa * xa)
                  - torch.einsum("kid,kid->kd", xa, vxa))
    g_la = 2.0 * (W * mat).sum((1, 2))
    g_ln = 2.0 * torch.exp(2.0 * log_noise) * (
        torch.diagonal(S, dim1=1, dim2=2) * mask).sum(1)
    return g_ll, g_la, g_ln


def gp_ei_ref(log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std,
              cand, best, xi=0.01):
    """Batched expected-improvement oracle over per-lane posteriors.

    log_ls (k,d), log_amp (k,), x (k,b,d), mask (k,b), chol (k,b,b),
    alpha (k,b), y_mean (k,), y_std (k,), cand (k,m,d), best (k,)
    -> ei (k,m) in raw y units (mirrors gp.predict + expected_improvement)."""
    kq = _matern52(cand, x, log_ls, log_amp) * mask[:, None, :]  # (k,m,b)
    mu = (kq @ alpha.unsqueeze(-1)).squeeze(-1)                  # (k,m)
    v = torch.linalg.solve_triangular(chol, kq.transpose(-1, -2),
                                      upper=False)               # (k,b,m)
    return ei_closed_form(mu, v, log_amp, y_mean, y_std, best, xi)


def ei_closed_form(mu, v, log_amp, y_mean, y_std, best, xi=0.01):
    """EI in raw y units from the posterior mean's kq·α (k,m) and the
    substituted V = L⁻¹kqᵀ (k,b,m): the tail of ``gp_ei_ref``."""
    amp2 = torch.exp(2.0 * log_amp)[:, None]
    var = torch.clamp(amp2 - (v * v).sum(-2), min=1e-12)
    mu = mu * y_std[:, None] + y_mean[:, None]
    sd = torch.sqrt(var) * y_std[:, None]
    imp = mu - best[:, None] - xi
    z = imp / sd
    ncdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))
    npdf = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    return imp * ncdf + sd * npdf


def int8_quant_ref(x, block=256):
    """Blockwise max-abs int8 quantization oracle.
    x: any shape -> (q int8 (nb, block), scales f32 (nb,)).

    The eager JAX reference's arithmetic exactly: IEEE division by 127
    (a 0-dim tensor divisor, because PyTorch's CUDA division by a Python
    number multiplies by its reciprocal), round half to even.  A block
    holding a NaN gets scale NaN, one holding an inf scale inf, and q is 0
    wherever x/scale is NaN, as the reference's float-to-int8 cast gives
    on the CPU (written out here: that cast is undefined in C)."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    amax = blocks.abs().amax(1)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)
    r = torch.round(blocks / scale[:, None])
    r = torch.where(torch.isnan(r), torch.zeros_like(r), r)
    return torch.clamp(r, -127, 127).to(torch.int8), scale
