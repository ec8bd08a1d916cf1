"""What every kernel wrapper of the port shares: its launch counter, its
typed C entry point, the checks of its inputs and of its launch.

A wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; on a CUDA tensor it launches or
raises, with no fall-back.  It adds one to its ``LaunchCounter`` where it
launches and nowhere else, so a run can show that its main path went
through the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels._build import library

P, I = ctypes.c_void_p, ctypes.c_int
#: a 64-bit count, for entry points whose element counts pass 2^31
I64 = ctypes.c_longlong

_BOUND = {}
_BIND_LOCK = threading.Lock()


class LaunchCounter:
    """Thread-safe count of a kernel's launches."""

    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def add(self) -> None:
        with self._lock:
            self._n += 1

    def reset(self) -> None:
        with self._lock:
            self._n = 0

    @property
    def count(self) -> int:
        with self._lock:
            return self._n


def _fn(lib_name: str, sym: str, argtypes, restype=ctypes.c_int):
    """The C entry point ``sym`` of one kernel library, typed once."""
    fn = _BOUND.get(sym)
    if fn is None:
        with _BIND_LOCK:
            fn = _BOUND.get(sym)
            if fn is None:
                fn = getattr(library(lib_name), sym)
                fn.argtypes = argtypes
                fn.restype = restype
                _BOUND[sym] = fn
    return fn


def _check(name, t, shape, device, dtype=torch.float32):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device: nothing to
    do when it already is (``torch.cuda.device`` costs a few microseconds
    of host time a call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def current_stream(dev: torch.device) -> int:
    """The current CUDA stream of ``dev`` as the int a C entry point
    takes, read as Triton's launcher reads it (``torch.cuda.current_stream``
    builds a Python object a call)."""
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return torch._C._cuda_getCurrentRawStream(index)


def _no_grad_inputs(name: str, *tensors: torch.Tensor) -> None:
    """A kernel wrapper's output carries no autograd graph: reached with
    inputs that require grad (outside the ``autograd.Function`` of
    ``ops.py``, whose forward runs with grad off) it would hand back a
    result that silently gives those inputs no gradient.  Raise instead."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: inputs require grad but the kernel records no graph; "
            f"call ops.{name.removesuffix('_bwd')}, whose autograd.Function "
            "carries the gradient")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")

