"""Wrappers of the hand-written CUDA GP kernels, with their plain versions.

Two kernels, both with a *lane* (= experiment) axis so k same-bucket
experiments run in one launch:

* ``gp_nll_chol`` — masked batched negative log marginal likelihood: the
  covariance build, Cholesky factorization, forward solve and log-det
  fused into one launch, a cluster of 8 CTAs per lane factoring it in
  32-column panels (``csrc/gp_nll.cu``).  It also returns its
  (L, z) residuals.  ``gp_nll`` wraps it in a ``torch.autograd.Function``
  whose backward is the *analytic* adjoint tr(S·∂K/∂θ) with
  S = ½(K⁻¹ − αα'), written batched in plain torch from those residuals —
  as the reference's custom_vjp backward is plain jnp.
* ``gp_ei`` — batched expected improvement: per lane, the cross
  covariance, the forward substitution for the predictive variance and
  the EI closed form (``csrc/gp_ei.cu``).  One block of 8 warps per tile
  of ``EI_TILE`` candidates, which it solves together as the columns of
  one blocked triangular solve: 32-row panels of L, each panel's update
  from the panels above split over the warps (L staged with cp.async),
  then its 32 x 32 diagonal block solved one candidate a warp.  Any
  bucket: the tile's V columns sit in shared memory through b = 5984
  (d = 3) and in a global scratch buffer past that.  A bucket of one
  panel (b <= ``EI_PANEL``) is solved by one launch of a small kernel
  instead, one thread a candidate substituting row by row.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors — there is no fall-back: on a CUDA
tensor it launches or raises.  Every launch adds one to the kernel's
counter (``gp_nll_launches``, ``gp_ei_launches``), so a run can show its
main path went through the kernels.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels._launch import (I as _I, P as _P, LaunchCounter,
                                         _check, _fn, _raise_on,
                                         current_stream, on_device)

gp_nll_launches = LaunchCounter()
gp_ei_launches = LaunchCounter()

#: candidates a ``gp_ei`` block solves together, and the rows of L a
#: panel of its blocked forward substitution (``csrc/gp_ei.cu`` kTC,
#: kPanel; the CPU tests emulate that order with these)
EI_TILE = 8
EI_PANEL = 32


# ------------------------------------------------------------------ NLL
def gp_nll_chol_plain(log_ls, log_amp, log_noise, x, y, mask):
    """Plain torch version of ``gp_nll_chol``: (nll (k,), L (k,b,b),
    z (k,b)) with z = L⁻¹(y·m)."""
    L = ref.cholesky(ref.masked_cov(log_ls, log_amp, log_noise, x, mask))
    ym = y * mask
    z = torch.linalg.solve_triangular(L, ym.unsqueeze(-1),
                                      upper=False).squeeze(-1)
    nll = (0.5 * (z * z).sum(-1)
           + torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
           + 0.5 * mask.sum(-1) * ref._LOG_2PI)
    return nll, L, z


def gp_nll_chol(log_ls, log_amp, log_noise, x, y, mask):
    """Fused batched NLL, also returning the (L, z) residuals the analytic
    backward reuses.  Shapes as in ``ref.gp_nll_ref``."""
    if x.device.type == "cpu":
        return gp_nll_chol_plain(log_ls, log_amp, log_noise, x, y, mask)
    if x.device.type != "cuda":
        raise ValueError(f"gp_nll_chol: no kernel for device {x.device}")
    k, b, d = x.shape
    dev = x.device
    for name, t, shape in (("log_ls", log_ls, (k, d)),
                           ("log_amp", log_amp, (k,)),
                           ("log_noise", log_noise, (k,)),
                           ("x", x, (k, b, d)), ("y", y, (k, b)),
                           ("mask", mask, (k, b))):
        _check(name, t, shape, dev)
    nll = torch.empty((k,), dtype=torch.float32, device=dev)
    L = torch.empty((k, b, b), dtype=torch.float32, device=dev)
    z = torch.empty((k, b), dtype=torch.float32, device=dev)
    fn = _fn("gp_nll", "gp_nll_launch", [_P] * 9 + [_I] * 3 + [_P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(log_ls.data_ptr(), log_amp.data_ptr(), log_noise.data_ptr(),
                 x.data_ptr(), y.data_ptr(), mask.data_ptr(), nll.data_ptr(),
                 L.data_ptr(), z.data_ptr(), k, b, d, stream)
    _raise_on(err, "gp_nll")
    gp_nll_launches.add()
    work.charge("gp_nll", work.nll_work, k, b, d)
    return nll, L, z


def nll_backward(log_ls, log_amp, log_noise, x, mask, L, z, g):
    """Analytic per-lane NLL gradient from the forward residuals:
    dNLL/dθ = tr(S·∂K/∂θ) with S = ½(K⁻¹ − αα'), α = L⁻ᵀz — the batched
    form of the reference's ``_nll_bwd_lane``.  Returns (g_log_ls (k,d),
    g_log_amp (k,), g_log_noise (k,), g_y (k,b))."""
    k, b, _ = x.shape
    eye = torch.eye(b, dtype=x.dtype, device=x.device)
    ls = torch.exp(log_ls)
    amp2 = torch.exp(2.0 * log_amp)
    alpha = torch.linalg.solve_triangular(
        L.transpose(-1, -2), z.unsqueeze(-1), upper=True).squeeze(-1)
    linv = torch.linalg.solve_triangular(L, eye.expand(k, b, b), upper=False)
    S = 0.5 * (linv.transpose(-1, -2) @ linv
               - alpha[:, :, None] * alpha[:, None, :])
    smm = S * (mask[:, :, None] * mask[:, None, :])
    diff = x[:, :, None, :] - x[:, None, :, :]            # (k,b,b,d)
    sq_k = (diff / ls[:, None, None, :]) ** 2
    r = torch.sqrt(torch.clamp(sq_k.sum(-1), min=0.0) + 1e-12)
    s5r = 5.0 ** 0.5 * r
    e = torch.exp(-s5r)
    mat = amp2[:, None, None] * (1.0 + s5r + (5.0 / 3.0) * r * r) * e
    # ∂k/∂log_ls_k = amp2·(5/3)(1+√5r)e^{−√5r}·d_k²/ls_k²
    coeff = amp2[:, None, None] * (5.0 / 3.0) * (1.0 + s5r) * e
    g_ll = g[:, None] * torch.einsum("kij,kij,kijd->kd", smm, coeff, sq_k)
    g_la = g * 2.0 * (smm * mat).sum((1, 2))
    g_ln = g * 2.0 * torch.exp(2.0 * log_noise) * (
        torch.diagonal(S, dim1=1, dim2=2) * mask).sum(1)
    g_y = g[:, None] * (alpha * mask)                     # K⁻¹(y·m)·m
    return g_ll, g_la, g_ln, g_y


class GPNLL(torch.autograd.Function):
    """Batched masked neg-MLL: fused forward, analytic backward.
    Hyperparameter and y gradients are exact; x and mask get none (the
    fit loop never differentiates them)."""

    @staticmethod
    def forward(ctx, log_ls, log_amp, log_noise, x, y, mask):
        nll, L, z = gp_nll_chol(log_ls, log_amp, log_noise, x, y, mask)
        ctx.save_for_backward(log_ls, log_amp, log_noise, x, mask, L, z)
        return nll

    @staticmethod
    def backward(ctx, g):
        log_ls, log_amp, log_noise, x, mask, L, z = ctx.saved_tensors
        g_ll, g_la, g_ln, g_y = nll_backward(log_ls, log_amp, log_noise, x,
                                             mask, L, z, g)
        return g_ll, g_la, g_ln, None, g_y, None


def gp_nll(log_ls, log_amp, log_noise, x, y, mask):
    """Batched masked neg-MLL through the kernel, differentiable."""
    return GPNLL.apply(log_ls, log_amp, log_noise, x, y, mask)


# ------------------------------------------------------------------- EI
@functools.lru_cache(maxsize=256)
def _ei_scratch_floats(k, b, d, m):
    return _fn("gp_ei", "gp_ei_scratch_floats", [_I] * 4,
               ctypes.c_longlong)(k, b, d, m)


def gp_ei(log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std, cand, best,
          xi: float = 0.01):
    """Fused batched EI over per-lane posteriors; shapes as in
    ``ref.gp_ei_ref`` -> ei (k,m) in raw y units."""
    if x.device.type == "cpu":
        return ref.gp_ei_ref(log_ls, log_amp, x, mask, chol, alpha, y_mean,
                             y_std, cand, best, xi=xi)
    if x.device.type != "cuda":
        raise ValueError(f"gp_ei: no kernel for device {x.device}")
    k, b, d = x.shape
    m = cand.shape[1]
    dev = x.device
    for name, t, shape in (("log_ls", log_ls, (k, d)),
                           ("log_amp", log_amp, (k,)), ("x", x, (k, b, d)),
                           ("mask", mask, (k, b)), ("chol", chol, (k, b, b)),
                           ("alpha", alpha, (k, b)), ("y_mean", y_mean, (k,)),
                           ("y_std", y_std, (k,)), ("cand", cand, (k, m, d)),
                           ("best", best, (k,))):
        _check(name, t, shape, dev)
    fn = _fn("gp_ei", "gp_ei_launch",
             [_P] * 12 + [_I] * 4 + [ctypes.c_float, _P])
    ei = torch.empty((k, m), dtype=torch.float32, device=dev)
    n = _ei_scratch_floats(k, b, d, m)
    scratch = torch.empty((n,), dtype=torch.float32, device=dev) if n else None
    with on_device(dev):
        err = fn(log_ls.data_ptr(), log_amp.data_ptr(), x.data_ptr(),
                 mask.data_ptr(), chol.data_ptr(), alpha.data_ptr(),
                 y_mean.data_ptr(), y_std.data_ptr(), cand.data_ptr(),
                 best.data_ptr(), ei.data_ptr(),
                 None if scratch is None else scratch.data_ptr(), k, b, d, m,
                 float(xi), current_stream(dev))
    _raise_on(err, "gp_ei")
    gp_ei_launches.add()
    work.charge("gp_ei", work.ei_work, k, b, d, m)
    return ei
