"""Public dispatch for the kernels.

For CUDA tensors these launch the hand-written kernels (``kernels/gp.py``,
``kernels/flash_attention.py``, ``kernels/rglru_scan.py``,
``kernels/int8_quant.py``); for CPU tensors they run the plain PyTorch
oracles in ``ref.py`` — callers never branch on the device themselves.

``force_kernel=True`` asks for the kernel wrapper whatever the tensor's
device, as the reference's flag does.  The GP wrappers have a CPU form of
their own — the autograd ``gp_nll`` with its analytic backward, over the
plain versions — and that is how the CPU tests reach it.  The LM and
int8 wrappers have none: on a CPU tensor ``force_kernel=True`` raises,
rather than quietly run the plain version in the kernel's place.
"""
from __future__ import annotations

import torch

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


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    force_kernel=False):
    """Forward softmax attention, q (B,Sq,H,D), k/v (B,Skv,K,D) with
    K | H, causal and/or a sliding window, optional tanh softcap ->
    (B,Sq,H,D) in q's dtype: the CUDA kernel on the card, the dense
    oracle on the CPU."""
    _need_cuda("flash_attention", q, force_kernel)
    return _fa.flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)


def rglru_scan(log_a, b, *, force_kernel=False):
    """h_t = exp(log_a_t)·h_{t−1} + b_t from h₀ = 0 over (B,S,R)
    float32: the CUDA kernel on the card, the sequential oracle on the
    CPU."""
    _need_cuda("rglru_scan", log_a, force_kernel)
    return _rg.rglru_scan(log_a, b)


def int8_quantize(x, *, force_kernel=False):
    """Blockwise max-abs int8 quantization, blocks of 256 -> (q int8
    (nb, 256), scales float32 (nb,)): the CUDA kernel on the card, the
    plain oracle on the CPU."""
    _need_cuda("int8_quantize", x, force_kernel)
    return _q8.int8_quantize(x)
