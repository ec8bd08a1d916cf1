"""Wrapper of the hand-written CUDA RG-LRU scan (``csrc/rglru_scan.cu``),
forward and backward, with their plain versions.

``rglru_scan(log_a, b)`` computes h_t = exp(log_a_t)·h_{t−1} + b_t from
h₀ = 0 over (B,S,R) float32, the recurrence of every RG-LRU layer.
``rglru_scan_bwd(log_a, h, dh)`` is its gradient -> (d_log_a, d_b), by
the reverse recurrence g_t = dh_t + a_{t+1}·g_{t+1}.  For tensors on the
CPU each takes its plain version (``ref.rglru_scan_ref``,
``ref.rglru_scan_bwd_ref``, sequential loops); for CUDA tensors it
launches its kernel or raises.  Every launch adds one to
``rglru_scan_launches`` or ``rglru_scan_bwd_launches``.  Neither wrapper
records an autograd graph: the gradient is ``ops.rglru_scan``'s
``autograd.Function``, and a wrapper reached with inputs that require
grad, outside it, raises.

The kernel is a single-pass chunked scan across time: one block per tile
of ``TIME_TILE`` steps x 64 features of one batch row, staged into shared
memory with cp.async; its threads scan ``SUB_CHUNK``-step sub-chunks from
0 to (prod a, end state) pairs, the tile takes its carry-in from the
state the tile before it published and publishes its own (tile order
from an atomic ticket; one fixed order, so the result repeats bit for
bit), and then runs its steps again from the carry-in, writing h once.
The wrapper allocates the states' scratch (``rglru_scan_scratch_bytes``);
one call runs one memset and one kernel.  The backward is the same scan
walking time backwards, its tiles from the last to the first.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ref, work
from repro_torch.kernels._launch import I, I64, P, LaunchCounter, _check, \
    _fn, _no_grad_inputs, _raise_on, current_stream, on_device

rglru_scan_launches = LaunchCounter()
rglru_scan_bwd_launches = LaunchCounter()

#: time steps of one tile of the kernel, and of one thread's sub-chunk of
#: it (``csrc/rglru_scan.cu`` kT, kL; the CPU tests emulate that order)
TIME_TILE = 64
SUB_CHUNK = 16


@functools.lru_cache(maxsize=64)
def _scratch_bytes(B, S, R):
    return _fn("rglru_scan", "rglru_scan_scratch_bytes", [I] * 3, I64)(B, S, R)


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log_a, b: (B,S,R) float32 -> h (B,S,R) float32."""
    _no_grad_inputs("rglru_scan", log_a, b)
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
    work.charge("rglru_scan", work.scan_work, B, S, R)
    return h


def rglru_scan_meta(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernel's meta function, for meta tensors (shapes only: the dry
    run): h uninitialised, the launch charged by ``work.scan_work``."""
    work.charge("rglru_scan", work.scan_work, *log_a.shape)
    return torch.empty_like(log_a, dtype=torch.float32)


def rglru_scan_bwd_meta(log_a, h, dh):
    """The backward kernel's meta function: (d_log_a, d_b) uninitialised,
    the launch charged by ``work.scan_bwd_work``."""
    work.charge("rglru_scan_bwd", work.scan_bwd_work, *log_a.shape)
    return (torch.empty_like(log_a, dtype=torch.float32),
            torch.empty_like(log_a, dtype=torch.float32))


def rglru_scan_bwd(log_a: torch.Tensor, h: torch.Tensor, dh: torch.Tensor):
    """log_a, the forward's h and its gradient dh: (B,S,R) float32 ->
    (d_log_a, d_b) (B,S,R) float32."""
    _no_grad_inputs("rglru_scan_bwd", log_a, h, dh)
    if log_a.device.type == "cpu":
        return ref.rglru_scan_bwd_ref(log_a, h, dh)
    if log_a.device.type != "cuda":
        raise ValueError(
            f"rglru_scan_bwd: no kernel for device {log_a.device}")
    if log_a.dim() != 3:
        raise ValueError(f"rglru_scan_bwd: log_a is {tuple(log_a.shape)}, "
                         "expected (B, S, R)")
    B, S, R = log_a.shape
    dev = log_a.device
    log_a, h, dh = log_a.contiguous(), h.contiguous(), dh.contiguous()
    for name, t in (("log_a", log_a), ("h", h), ("dh", dh)):
        _check(name, t, (B, S, R), dev)
    d_log_a = torch.empty_like(log_a)
    d_b = torch.empty_like(log_a)
    if d_b.numel() == 0:
        return d_log_a, d_b
    fn = _fn("rglru_scan", "rglru_scan_bwd_launch", [P] * 6 + [I] * 3 + [P])
    scratch = torch.empty((_scratch_bytes(B, S, R),), dtype=torch.uint8,
                          device=dev)
    with on_device(dev):
        err = fn(log_a.data_ptr(), h.data_ptr(), dh.data_ptr(),
                 d_log_a.data_ptr(), d_b.data_ptr(), scratch.data_ptr(),
                 B, S, R, current_stream(dev))
    _raise_on(err, "rglru_scan_bwd")
    rglru_scan_bwd_launches.add()
    work.charge("rglru_scan_bwd", work.scan_bwd_work, B, S, R)
    return d_log_a, d_b
