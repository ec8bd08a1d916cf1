"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), forward and backward, with their plain
versions.

``flash_attention(q, k, v, causal=, window=, softcap=, scale=,
return_lse=, q_offset=)`` is forward softmax attention over q (B,Sq,H,D)
and k, v (B,Skv,K,D) with K | H (grouped-query heads), causal and/or a
sliding window, query row i at position ``q_offset`` + i (0 by default;
a rank holding one shard of a sequence's queries against the whole
sequence's keys passes the shard's first position), an optional tanh
softcap, the scores scaled by ``scale`` (1/√D
by default; a caller that zero-pads its heads to one of ``HEAD_DIMS``
passes its own), float32 inside and out in q's dtype; with ``return_lse``
it also returns the float32 row log-sum-exp (B,H,Sq) that the backward
recomputes the probabilities from.  Every head dim up to 256 runs: one
between the instantiated ``HEAD_DIMS`` is zero-padded to the next of them
(``kernel_head_dim``) at the scale of its true width, and the outputs are
cut back (``padded_forward``, ``padded_backward``); a wider one raises.  ``flash_attention_bwd(q, k, v, o,
lse, do, ...)`` is its gradient -> (dq, dk, dv) in the inputs' dtype.
For tensors on the CPU each takes its plain version
(``ref.flash_attention_ref``, ``ref.flash_attention_bwd_ref``); for CUDA
tensors it launches its kernels or raises.  Each C entry point picks its
kernels by dtype: bfloat16 runs on the
tensor cores (``wgmma`` fed by TMA; the backward's dK/dV kernel one block
per (64 keys, query head, batch), each head's share summed over the heads
of its KV head in a second pass through float32 scratch), float32 on the
CUDA cores.  Every forward launch adds one to
``flash_attention_launches``, every backward launch (its four kernels
in bfloat16, three in float32) one to ``flash_attention_bwd_launches``.

Neither wrapper records an autograd graph: the gradient is
``ops.flash_attention``'s ``autograd.Function``, and a wrapper reached
with inputs that require grad, outside that Function, raises.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ref, work
from repro_torch.kernels._launch import I, P, LaunchCounter, _check, _fn, \
    _no_grad_inputs, _raise_on, current_stream, on_device

flash_attention_launches = LaunchCounter()
flash_attention_bwd_launches = LaunchCounter()

#: input types the kernel takes, by the code its C entry point expects
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 64, 128, 256)


def _check_call(name, q, k, window, q_offset):
    """The shape, type and option checks both directions share ->
    (B, Sq, H, D, Skv, K)."""
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"{name}: q and k must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"{name}: {K} kv heads do not divide {H}")
    kernel_head_dim(D, name)
    if q.dtype not in DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not in {tuple(DTYPES)}")
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0")
    if q_offset < 0:
        raise ValueError(f"{name}: q_offset {q_offset} < 0")
    return B, Sq, H, D, Skv, K


def kernel_head_dim(D: int, name: str = "flash_attention") -> int:
    """The instantiated head dim a head of width D runs at: the smallest
    of ``HEAD_DIMS`` that holds it."""
    for width in HEAD_DIMS:
        if width >= D:
            return width
    raise ValueError(f"{name}: head dim {D} is wider than {HEAD_DIMS[-1]}, "
                     f"the widest of the kernels' {HEAD_DIMS}")


def _pad_heads(Dp: int, *ts: torch.Tensor):
    return [F.pad(t, (0, Dp - t.shape[-1])) for t in ts]


def padded_forward(fwd, q, k, v, Dp: int, *, scale=None,
                   return_lse: bool = False, **kw):
    """``fwd`` (the forward wrapper, or its plain version) at head dim Dp
    on q, k, v zero-padded to it: zero columns add nothing to q·k, the
    scale stays the true width's (1/√D for None), and o's padded columns,
    zero, are cut off."""
    D = q.shape[-1]
    out = fwd(*_pad_heads(Dp, q, k, v), scale=_scale(scale, D),
              return_lse=return_lse, **kw)
    if return_lse:
        return out[0][..., :D], out[1]
    return out[..., :D]


def padded_backward(bwd, q, k, v, o, lse, do, Dp: int, *, scale=None,
                    **kw):
    """``bwd`` (the backward wrapper, or its plain version) at head dim Dp
    on inputs zero-padded to it, as ``padded_forward`` ran the forward
    (o's padded columns are the zeros it cut off) -> (dq, dk, dv) cut
    back to the true width: their padded columns are zero."""
    D = q.shape[-1]
    dq, dk, dv = bwd(*_pad_heads(Dp, q, k, v, o), lse, *_pad_heads(Dp, do),
                     scale=_scale(scale, D), **kw)
    return dq[..., :D], dk[..., :D], dv[..., :D]


def _scale(scale, D: int) -> float:
    """The scores' scale as the C entry points take it: 1/√D for None."""
    scale = 1.0 / math.sqrt(D) if scale is None else float(scale)
    if not math.isfinite(scale) or scale <= 0.0:
        raise ValueError(f"flash_attention: scale {scale} is not > 0")
    return scale


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale=None,
                    return_lse: bool = False, q_offset: int = 0):
    """q: (B,Sq,H,D); k, v: (B,Skv,K,D) -> o (B,Sq,H,D) in q's dtype, and
    with ``return_lse`` (o, lse (B,H,Sq) float32).  ``scale`` None is
    1/√D; query row i sits at position ``q_offset`` + i."""
    _no_grad_inputs("flash_attention", q, k, v)
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale,
                                       return_lse=return_lse,
                                       q_offset=q_offset)
    B, Sq, H, D, Skv, K = _check_call("flash_attention", q, k, window,
                                      q_offset)
    Dp = kernel_head_dim(D)
    if Dp != D:
        return padded_forward(flash_attention, q, k, v, Dp, causal=causal,
                              window=window, softcap=softcap, scale=scale,
                              return_lse=return_lse, q_offset=q_offset)
    scale = _scale(scale, D)
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check("q", q, (B, Sq, H, D), dev, q.dtype)
    _check("k", k, (B, Skv, K, D), dev, q.dtype)
    _check("v", v, (B, Skv, K, D), dev, q.dtype)
    o = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if o.numel() == 0 or Skv == 0:
        o.zero_()
        if lse is not None:
            lse.fill_(ref.NEG_INF)
        return (o, lse) if return_lse else o
    fn = _fn("flash_attention", "flash_attention_launch",
             [P] * 5 + [I] * 10 + [ctypes.c_float] * 2 + [P])
    with on_device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, Sq, Skv, H, K, D, DTYPES[q.dtype], int(bool(causal)),
                 int(window), q_offset, float(softcap), scale,
                 current_stream(dev))
    _raise_on(err, "flash_attention")
    flash_attention_launches.add()
    work.charge("flash_attention", work.flash_work, B, Sq, Skv, H, K, D,
                causal, window, q.element_size(), q_offset=q_offset)
    return (o, lse) if return_lse else o


def flash_attention_meta(q, k, v, *, causal: bool = True, window: int = 0,
                         softcap: float = 0.0, scale=None,
                         return_lse: bool = False, q_offset: int = 0):
    """The kernel's meta function, for meta tensors (shapes only: the dry
    run): ``flash_attention``'s outputs, uninitialised, and the launch
    charged by its work formula (``work.flash_work``); nothing counted."""
    B, Sq, H, D = q.shape
    o = torch.empty(B, Sq, H, v.shape[-1], dtype=q.dtype, device=q.device)
    work.charge("flash_attention", work.flash_work, B, Sq, k.shape[1], H,
                k.shape[2], D, causal, window, q.element_size(),
                v.shape[-1], q_offset=int(q_offset))
    if not return_lse:
        return o
    return o, torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)


def flash_attention_bwd_meta(q, k, v, o, lse, do, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0,
                             scale=None, q_offset: int = 0):
    """The backward kernel's meta function (see ``flash_attention_meta``):
    (dq, dk, dv) uninitialised, the launch charged by
    ``work.flash_bwd_work``."""
    B, Sq, H, D = q.shape
    work.charge("flash_attention_bwd", work.flash_bwd_work, B, Sq,
                k.shape[1], H, k.shape[2], D, causal, window,
                q.element_size(), v.shape[-1], q_offset=int(q_offset))
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0, scale=None,
                        q_offset: int = 0):
    """The gradient of ``flash_attention``: q, o, do (B,Sq,H,D); k, v
    (B,Skv,K,D); lse (B,H,Sq) float32 as the forward returned it; the
    forward's ``scale`` and ``q_offset`` -> (dq, dk, dv) in the inputs'
    dtype."""
    _no_grad_inputs("flash_attention_bwd", q, k, v, o, do)
    q_offset = int(q_offset)
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                           causal=causal, window=window,
                                           softcap=softcap, scale=scale,
                                           q_offset=q_offset)
    B, Sq, H, D, Skv, K = _check_call("flash_attention_bwd", q, k, window,
                                      q_offset)
    Dp = kernel_head_dim(D)
    if Dp != D:
        return padded_backward(flash_attention_bwd, q, k, v, o, lse, do, Dp,
                               causal=causal, window=window, softcap=softcap,
                               scale=scale, q_offset=q_offset)
    scale = _scale(scale, D)
    dev, dt = q.device, q.dtype
    q, k, v, o, do, lse = (t.contiguous() for t in (q, k, v, o, do, lse))
    for name, t, shape in (("q", q, (B, Sq, H, D)), ("k", k, (B, Skv, K, D)),
                           ("v", v, (B, Skv, K, D)), ("o", o, (B, Sq, H, D)),
                           ("do", do, (B, Sq, H, D))):
        _check(name, t, shape, dev, dt)
    _check("lse", lse, (B, H, Sq), dev)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if Sq == 0 or Skv == 0 or dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    dvec = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    # bf16: each query head's float32 share of dk, then of dv
    part = (torch.empty((2, B, Skv, H, D), dtype=torch.float32, device=dev)
            if dt == torch.bfloat16 else None)
    fn = _fn("flash_attention", "flash_attention_bwd_launch",
             [P] * 11 + [I] * 10 + [ctypes.c_float] * 2 + [P])
    with on_device(dev):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 do.data_ptr(), lse.data_ptr(), dvec.data_ptr(),
                 None if part is None else part.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 B, Sq, Skv, H, K, D, DTYPES[dt], int(bool(causal)),
                 int(window), q_offset, float(softcap), scale,
                 current_stream(dev))
    _raise_on(err, "flash_attention_bwd")
    flash_attention_bwd_launches.add()
    work.charge("flash_attention_bwd", work.flash_bwd_work, B, Sq, Skv, H,
                K, D, causal, window, q.element_size(), q_offset=q_offset)
    return dq, dk, dv
