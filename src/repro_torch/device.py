"""Device resolution for the port: CUDA unless the caller asks otherwise.

Every entry point takes ``device=None`` and resolves it here once.
``None`` means the CUDA card; there is no silent fall-back to the CPU, so
a process without a card fails loudly instead of quietly running the
plain PyTorch paths.  Tests pass ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import threading
from typing import Optional, Set, Union

import torch

from repro_torch import card_pool

DeviceLike = Optional[Union[str, torch.device]]

_LINALG_LOCK = threading.Lock()
_LINALG_READY: Set[torch.device] = set()


def _load_cuda_linalg(device: torch.device) -> None:
    """Run each CUDA linear-algebra op the GP uses once, under a lock, on
    one of the GP's threads (``card_pool``: the library handles it
    creates stay with that set).  PyTorch loads its CUDA linear-algebra
    kernels lazily at the first call of such an op, and that first call
    fails ("lazy wrapper should be called at most once") when a second
    thread races through it — as the GP's threads would on a fresh
    process."""
    if device not in _LINALG_READY:
        card_pool.run(_load_linalg, device)


def _load_linalg(device: torch.device) -> None:
    with _LINALG_LOCK:
        if device in _LINALG_READY:
            return
        a = torch.eye(2, device=device) * 2.0
        a.requires_grad_()
        L, _ = torch.linalg.cholesky_ex(a)
        z = torch.linalg.solve_triangular(L, a, upper=False)
        w = torch.cholesky_solve(z, L)
        torch.autograd.grad(w.sum(), a)
        torch.cuda.synchronize(device)
        _LINALG_READY.add(device)


def resolve(device: DeviceLike = None, linalg: bool = False
            ) -> torch.device:
    """``None`` -> ``torch.device("cuda")`` (RuntimeError when CUDA is
    absent); anything else -> ``torch.device(device)``.  Resolving does
    no work on the card; with ``linalg=True`` (the GP's callers) a CUDA
    device comes back with PyTorch's CUDA linear algebra loaded, which
    allocates its workspaces there."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "paths on the CPU")
        device = "cuda"
    dev = torch.device(device)
    if linalg and dev.type == "cuda":
        _load_cuda_linalg(dev)
    return dev
