"""Wrapper of the hand-written CUDA RG-LRU scan (``csrc/rglru_scan.cu``),
with its plain version.

``rglru_scan(log_a, b)`` computes h_t = exp(log_a_t)·h_{t−1} + b_t from
h₀ = 0 over (B,S,R) float32, the recurrence of every RG-LRU layer's
prefill.  For tensors on the CPU it takes its plain version
(``ref.rglru_scan_ref``, a sequential loop); for CUDA tensors it launches
the kernel or raises.  Every launch adds one to ``rglru_scan_launches``.

The kernel is a single-pass chunked scan across time: one block per tile
of ``TIME_TILE`` steps x 64 features of one batch row, staged into shared
memory with cp.async; its threads scan ``SUB_CHUNK``-step sub-chunks from
0 to (prod a, end state) pairs, the tile takes its carry-in from the
state the tile before it published and publishes its own (tile order
from an atomic ticket; one fixed order, so the result repeats bit for
bit), and then runs its steps again from the carry-in, writing h once.
The wrapper allocates the states' scratch (``rglru_scan_scratch_bytes``);
one call runs one memset and one kernel.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref
from repro_torch.kernels._launch import I, I64, P, LaunchCounter, _check, \
    _fn, _raise_on, current_stream, on_device

rglru_scan_launches = LaunchCounter()

#: time steps of one tile of the kernel, and of one thread's sub-chunk of
#: it (``csrc/rglru_scan.cu`` kT, kL; the CPU tests emulate that order)
TIME_TILE = 64
SUB_CHUNK = 16


@functools.lru_cache(maxsize=64)
def _scratch_bytes(B, S, R):
    return _fn("rglru_scan", "rglru_scan_scratch_bytes", [I] * 3, I64)(B, S, R)


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
    fn = _fn("rglru_scan", "rglru_scan_launch", [P] * 4 + [I] * 3 + [P])
    scratch = torch.empty((_scratch_bytes(B, S, R),), dtype=torch.uint8,
                          device=dev)
    with on_device(dev):
        err = fn(log_a.data_ptr(), b.data_ptr(), h.data_ptr(),
                 scratch.data_ptr(), B, S, R, current_stream(dev))
    _raise_on(err, "rglru_scan")
    rglru_scan_launches.add()
    return h
