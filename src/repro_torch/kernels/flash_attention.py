"""Wrapper of the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), with its plain version.

``flash_attention(q, k, v, causal=, window=, softcap=)`` is forward
softmax attention over q (B,Sq,H,D) and k, v (B,Skv,K,D) with K | H
(grouped-query heads), causal and/or a sliding window, an optional tanh
softcap, float32 inside and out in q's dtype.  For tensors on the CPU it
takes its plain version (``ref.flash_attention_ref``, a dense masked
softmax); for CUDA tensors it launches the kernel or raises.  The C entry
point picks the kernel by dtype: bfloat16 runs on the tensor cores
(``wgmma`` fed by TMA), float32 on the CUDA cores.  Every launch adds one
to ``flash_attention_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import I, P, LaunchCounter, _check, _fn, \
    _raise_on

flash_attention_launches = LaunchCounter()

#: input types the kernel takes, by the code its C entry point expects
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 64, 128, 256)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q: (B,Sq,H,D); k, v: (B,Skv,K,D) -> (B,Sq,H,D) in q's dtype."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q and k must be (B, S, heads, D)")
    B, Sq, H, D = q.shape
    Skv, K = k.shape[1], k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {K} kv heads do not divide {H}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not in "
                        f"{tuple(DTYPES)}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    dev = q.device
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    _check("q", q, (B, Sq, H, D), dev, q.dtype)
    _check("k", k, (B, Skv, K, D), dev, q.dtype)
    _check("v", v, (B, Skv, K, D), dev, q.dtype)
    o = torch.empty_like(q)
    if o.numel() == 0 or Skv == 0:
        return o.zero_()
    fn = _fn("flash_attention", "flash_attention_launch",
             [P] * 4 + [I] * 9 + [ctypes.c_float, P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, Sq, Skv, H, K, D, DTYPES[q.dtype], int(bool(causal)),
                 int(window), float(softcap), stream)
    _raise_on(err, "flash_attention")
    flash_attention_launches.add()
    return o
