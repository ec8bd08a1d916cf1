"""Public dispatch for the kernels.

For CUDA tensors these launch the hand-written kernels (``kernels/gp.py``,
``kernels/flash_attention.py``, ``kernels/rglru_scan.py``,
``kernels/int8_quant.py``); for CPU tensors they run the plain PyTorch
oracles in ``ref.py`` — callers never branch on the device themselves.

``flash_attention`` and ``rglru_scan`` are differentiable: each is a
``torch.autograd.Function`` whose forward is the kernel wrapper (saving
what its backward needs) and whose backward is another Function around
the backward kernel (``flash_attention_bwd``, ``rglru_scan_bwd``), on
both devices.  Each Function has a ``vmap`` rule that folds the mapped
dim into the batch dim, so under ``torch.func.vmap`` (the population
trainer, ``core/vmap_trials.py``) one launch serves every trial.  Where
nothing needs a gradient (serving), ``flash_attention`` calls its wrapper
directly, and the kernel writes no row log-sum-exp.

Meta tensors (shapes only: the dry run's) take the kernels' meta
functions: the kernel's outputs, uninitialised, each launch charged by
its work formula (``kernels/work.py``), so a dry run costs what the
card's kernels would do rather than the plain versions' sequential loops
and dense S x S scores.  The wrappers themselves raise on meta tensors.

``force_kernel=True`` asks for the kernel wrapper whatever the tensor's
device, as the reference's flag does.  The GP wrappers have a CPU form of
their own — the autograd ``gp_nll`` with its analytic backward, over the
plain versions — and that is how the CPU tests reach it.  The LM and
int8 wrappers have none: on a CPU tensor ``force_kernel=True`` raises,
rather than quietly run the plain version in the kernel's place.

AdamW's kernels (``adamw_norm``, ``adamw_leaf``) have no plain version
here: the plain update is the optimizer's own (``optim/adamw.py``), which
calls these for CUDA and meta tensors only, under its own vmap rule.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import adamw as _aw
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import gp as _gpk
from repro_torch.kernels import int8_quant as _q8
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as _rg


def _on_cuda(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _need_cuda(name: str, t: torch.Tensor, force_kernel: bool) -> None:
    if force_kernel and not _on_cuda(t):
        raise ValueError(
            f"{name}: force_kernel=True asks for the hand-written CUDA "
            f"kernel, which needs CUDA tensors (got {t.device})")


def gp_neg_mll(log_ls, log_amp, log_noise, x, y, mask, *,
               force_kernel=False):
    """Batched masked GP neg-MLL over lanes: the fused CUDA kernel with
    its analytic backward on the card, plain differentiable torch on the
    CPU.  Shapes: log_ls (k,d), log_amp (k,), log_noise (k,), x (k,b,d),
    y (k,b), mask (k,b) -> nll (k,)."""
    if _on_cuda(x) or force_kernel:
        return _gpk.gp_nll(log_ls, log_amp, log_noise, x, y, mask)
    return ref.gp_nll_ref(log_ls, log_amp, log_noise, x, y, mask)


def gp_fit_grads(log_ls, log_amp, log_noise, x, y, mask, *,
                 force_kernel=False):
    """Per-lane NLL hyperparameter gradients for the batched Adam fit loop
    (``gp._fit_lanes``).  On the card this differentiates the fused
    kernel through its ``autograd.Function`` (whose backward reuses the
    kernel's L and z); on the CPU it runs the matmul-rich analytic
    adjoint directly.  Returns (g_log_ls (k,d), g_log_amp (k,),
    g_log_noise (k,))."""
    if _on_cuda(x) or force_kernel:
        with torch.enable_grad():
            ll = log_ls.detach().requires_grad_()
            la = log_amp.detach().requires_grad_()
            ln = log_noise.detach().requires_grad_()
            nll = _gpk.gp_nll(ll, la, ln, x, y, mask).sum()
            return torch.autograd.grad(nll, (ll, la, ln))
    return ref.gp_nll_grads_ref(log_ls, log_amp, log_noise, x, y, mask)


def gp_ei(log_ls, log_amp, x, mask, chol, alpha, y_mean, y_std, cand,
          best, *, xi=0.01, force_kernel=False):
    """Batched expected improvement over per-lane posteriors.  Shapes as
    in ``ref.gp_ei_ref`` -> ei (k,m) in raw y units."""
    if _on_cuda(x) or force_kernel:
        return _gpk.gp_ei(log_ls, log_amp, x, mask, chol, alpha, y_mean,
                          y_std, cand, best, xi=xi)
    return ref.gp_ei_ref(log_ls, log_amp, x, mask, chol, alpha, y_mean,
                         y_std, cand, best, xi=xi)


def _differentiated(*ts: torch.Tensor) -> bool:
    """Whether a result computed from ``ts`` needs a graph: autograd
    records one, or a ``torch.func`` transform wraps them (its tensors
    reach a kernel only through a Function's rules)."""
    return ((torch.is_grad_enabled() and any(t.requires_grad for t in ts))
            or any(torch._C._functorch.is_functorch_wrapped_tensor(t)
                   for t in ts))


def _lm(wrapper, meta, t):
    """An LM kernel's wrapper, or its meta function for a meta tensor."""
    return meta if t.is_meta else wrapper


def _fold(t, dim, size):
    """A vmapped argument with its mapped dim (None: not mapped, so
    broadcast) folded into its leading batch dim: (size·B, ...)."""
    t = t.unsqueeze(0).expand(size, *t.shape) if dim is None \
        else t.movedim(dim, 0)
    return t.reshape(size * t.shape[1], *t.shape[2:])


def _unfold(t, size):
    return t.reshape(size, t.shape[0] // size, *t.shape[1:])


class _FlashAttention(torch.autograd.Function):
    """o, lse = attention(q, k, v); saves q, k, v, o and lse."""

    @staticmethod
    def forward(q, k, v, causal, window, softcap, scale, q_offset=0):
        fwd = _lm(_fa.flash_attention, _fa.flash_attention_meta, q)
        return fwd(q, k, v, causal=causal, window=window, softcap=softcap,
                   scale=scale, return_lse=True, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, causal, window, softcap, scale, *q_offset = inputs
        o, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = (causal, window, softcap, scale, *q_offset)

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _FlashAttentionBwd.apply(q, k, v, o, lse, do,
                                              *ctx.opts)
        return dq, dk, dv, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, causal, window, softcap, scale,
             q_offset=0):
        n = info.batch_size
        o, lse = _FlashAttention.apply(
            *(_fold(t, d, n) for t, d in zip((q, k, v), in_dims)),
            causal, window, softcap, scale, q_offset)
        return (_unfold(o, n), _unfold(lse, n)), (0, 0)


class _FlashAttentionBwd(torch.autograd.Function):
    """(dq, dk, dv) of ``_FlashAttention``: a Function of its own so that
    the backward, too, runs under ``vmap`` as one folded launch."""

    @staticmethod
    def forward(q, k, v, o, lse, do, causal, window, softcap, scale,
                q_offset=0):
        bwd = _lm(_fa.flash_attention_bwd, _fa.flash_attention_bwd_meta,
                  q)
        return bwd(q, k, v, o, lse, do, causal=causal, window=window,
                   softcap=softcap, scale=scale, q_offset=q_offset)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("flash_attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, lse, do, causal, window, softcap,
             scale, q_offset=0):
        n = info.batch_size
        grads = _FlashAttentionBwd.apply(
            *(_fold(t, d, n) for t, d in zip((q, k, v, o, lse, do),
                                            in_dims)),
            causal, window, softcap, scale, q_offset)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


class _RglruScan(torch.autograd.Function):
    """h = scan(log_a, b); saves log_a and h."""

    @staticmethod
    def forward(log_a, b):
        return _lm(_rg.rglru_scan, _rg.rglru_scan_meta, log_a)(log_a, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[0], output)

    @staticmethod
    def backward(ctx, dh):
        log_a, h = ctx.saved_tensors
        return _RglruScanBwd.apply(log_a, h, dh)

    @staticmethod
    def vmap(info, in_dims, log_a, b):
        n = info.batch_size
        h = _RglruScan.apply(_fold(log_a, in_dims[0], n),
                             _fold(b, in_dims[1], n))
        return _unfold(h, n), 0


class _RglruScanBwd(torch.autograd.Function):
    """(d_log_a, d_b) of ``_RglruScan``, vmapped as one folded launch."""

    @staticmethod
    def forward(log_a, h, dh):
        return _lm(_rg.rglru_scan_bwd, _rg.rglru_scan_bwd_meta, log_a)(
            log_a, h, dh)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("rglru_scan has no second derivative")

    @staticmethod
    def vmap(info, in_dims, log_a, h, dh):
        n = info.batch_size
        grads = _RglruScanBwd.apply(
            *(_fold(t, d, n) for t, d in zip((log_a, h, dh), in_dims)))
        return tuple(_unfold(g, n) for g in grads), (0, 0)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, q_offset=0, force_kernel=False):
    """Softmax attention, q (B,Sq,H,D), k/v (B,Skv,K,D) with K | H,
    causal and/or a sliding window (query row i at position ``q_offset``
    + i, key j at j), optional tanh softcap, scores scaled by ``scale``
    (1/√D when None) -> (B,Sq,H,D) in q's dtype, differentiable in q, k
    and v: the CUDA kernels forward and backward on the card, the dense
    oracle and its plain gradient on the CPU."""
    _need_cuda("flash_attention", q, force_kernel)
    q_offset = int(q_offset)
    if not _differentiated(q, k, v):
        # serving: no graph, so no lse to save
        fwd = _lm(_fa.flash_attention, _fa.flash_attention_meta, q)
        return fwd(q, k, v, causal=causal, window=window, softcap=softcap,
                   scale=scale, q_offset=q_offset)
    return _FlashAttention.apply(q, k, v, causal, window, softcap, scale,
                                 q_offset)[0]


def rglru_scan(log_a, b, *, force_kernel=False):
    """h_t = exp(log_a_t)·h_{t−1} + b_t from h₀ = 0 over (B,S,R)
    float32, differentiable in log_a and b: the CUDA kernels forward and
    backward on the card, the sequential oracles on the CPU."""
    _need_cuda("rglru_scan", log_a, force_kernel)
    return _RglruScan.apply(log_a, b)


def int8_quantize(x, *, force_kernel=False):
    """Blockwise max-abs int8 quantization, blocks of 256 -> (q int8
    (nb, 256), scales float32 (nb,)): the CUDA kernel on the card, the
    plain oracle on the CPU."""
    _need_cuda("int8_quantize", x, force_kernel)
    return _q8.int8_quantize(x)


def adamw_norm(gs, step, cfg, trials=None):
    """The gradient norm AdamW clips by, and each trial's (clip scale,
    c1, c2) -> (norm, coef): the CUDA kernels on the card, the meta
    function for meta tensors (``kernels/adamw.py``)."""
    return _lm(_aw.adamw_norm, _aw.adamw_norm_meta, gs[0])(gs, step, cfg,
                                                          trials)


def adamw_leaf(g, m, v, p, coef, lr, decay, cfg, trials=None) -> None:
    """One leaf's AdamW update written into p, m and v: the CUDA kernel
    on the card, the meta function for meta tensors."""
    _lm(_aw.adamw_leaf, _aw.adamw_leaf_meta, p)(g, m, v, p, coef, lr, decay,
                                                cfg, trials)
