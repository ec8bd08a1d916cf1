"""Wrapper of the hand-written CUDA RG-LRU scan (``csrc/rglru_scan.cu``),
with its plain version.

``rglru_scan(log_a, b)`` computes h_t = exp(log_a_t)·h_{t−1} + b_t from
h₀ = 0 over (B,S,R) float32, the recurrence of every RG-LRU layer's
prefill.  For tensors on the CPU it takes its plain version
(``ref.rglru_scan_ref``, a sequential loop); for CUDA tensors it launches
the kernel or raises.  Every launch adds one to ``rglru_scan_launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import I, P, LaunchCounter, _check, _fn, \
    _raise_on

rglru_scan_launches = LaunchCounter()


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: (B,S,R) float32 -> h (B,S,R) float32."""
    if log_a.device.type == "cpu":
        return ref.rglru_scan_ref(log_a, b)
    if log_a.device.type != "cuda":
        raise ValueError(f"rglru_scan: no kernel for device {log_a.device}")
    if log_a.dim() != 3:
        raise ValueError(f"rglru_scan: log_a is {tuple(log_a.shape)}, "
                         "expected (B, S, R)")
    B, S, R = log_a.shape
    dev = log_a.device
    log_a, b = log_a.contiguous(), b.contiguous()
    for name, t in (("log_a", log_a), ("b", b)):
        _check(name, t, (B, S, R), dev)
    h = torch.empty((B, S, R), dtype=torch.float32, device=dev)
    if h.numel() == 0:
        return h
    fn = _fn("rglru_scan", "rglru_scan_launch", [P] * 3 + [I] * 3 + [P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(log_a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, R,
                 stream)
    _raise_on(err, "rglru_scan")
    rglru_scan_launches.add()
    return h
