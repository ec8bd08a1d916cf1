"""The fixed set of threads that run the GP's numerics.

PyTorch gives each thread that calls cuBLAS or cuSOLVER a handle of its
own.  When the thread ends, the handle goes back to a pool for the next
thread, and no handle is ever destroyed.  On an H100 a cuBLAS handle holds
about 64 MiB of the card outside PyTorch's caching allocator, and a
cuSOLVER handle about 304 MB more.  If every thread that serves a
suggestion ran the GP itself, the card would keep one of each for every
such thread: the service's client and HTTP handler threads, the
per-experiment pumps and the fleet's shards.

So the GP's work runs on a fixed set of threads instead:

* the fit executor's workers (``api/pipeline.py``), which ``enroll`` and
  run it inline;
* ``THREADS`` threads of this module (``gp-card_0``, ...), which run what
  any other thread hands them.

A function wrapped in ``confined`` runs inline on an enrolled thread.  On
any other thread it is handed to this module's threads, and the caller
waits for the result; an exception is raised again in the caller.  The
confinement holds on every device, so a CPU test can check it.

No deadlock can come of it.  This module's threads run only confined
functions, which take no lock that a waiting caller may hold (an
experiment's ``opt_lock`` is taken by the callers, never inside the
numerics), and a confined call made on an enrolled thread runs inline,
so no such thread ever waits on another.

``stats()`` counts the hand-offs and the seconds their callers waited,
and the part of that wait spent queued before one of this module's
threads took the call.

A leaf module: it imports nothing of the port.
"""
from __future__ import annotations

import concurrent.futures
import functools
import os
import threading
import time
from typing import Callable, Dict, Optional

import torch

#: threads of this module's own (``PREFIX``_0 .. _THREADS-1)
THREADS = 2
PREFIX = "gp-card"

_LOCAL = threading.local()
_LOCK = threading.Lock()
_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
#: hand-offs since the process started: count, seconds the callers
#: waited, seconds of that wait before a thread of this module took one
_STATS = {"handoffs": 0, "waited_s": 0.0, "queued_s": 0.0}


def enroll() -> None:
    """Mark the calling thread as one of the set: confined calls made on
    it run inline."""
    _LOCAL.member = True


def enrolled() -> bool:
    """Whether the calling thread is one of the set."""
    return getattr(_LOCAL, "member", False)


def _pool() -> concurrent.futures.ThreadPoolExecutor:
    global _POOL
    with _LOCK:
        if _POOL is None:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                THREADS, thread_name_prefix=PREFIX, initializer=enroll)
        return _POOL


def _forget_pool() -> None:
    """A forked child has none of the parent's threads: it starts its own
    pool at its first confined call."""
    global _POOL, _LOCK
    _POOL, _LOCK = None, threading.Lock()


os.register_at_fork(after_in_child=_forget_pool)


def stats() -> Dict[str, float]:
    """The hand-offs so far (``_STATS``), a copy."""
    with _LOCK:
        return dict(_STATS)


def _call(fn, grad: bool, cuda: Optional[int], started: list, args,
          kwargs):
    started.append(time.perf_counter())
    with torch.set_grad_enabled(grad):
        if cuda is None:
            return fn(*args, **kwargs)
        with torch.cuda.device(cuda):
            return fn(*args, **kwargs)


def run(fn: Callable, *args, **kwargs):
    """``fn(*args, **kwargs)`` on one of the set: inline when the calling
    thread is one, else on this module's threads, with the caller's
    grad mode and current CUDA device."""
    if enrolled():
        return fn(*args, **kwargs)
    cuda = (torch.cuda.current_device() if torch.cuda.is_initialized()
            else None)
    started: list = []
    t0 = time.perf_counter()
    try:
        return _pool().submit(_call, fn, torch.is_grad_enabled(), cuda,
                              started, args, kwargs).result()
    finally:
        t1 = time.perf_counter()
        with _LOCK:
            _STATS["handoffs"] += 1
            _STATS["waited_s"] += t1 - t0
            _STATS["queued_s"] += (started[0] if started else t1) - t0


def confined(fn: Callable) -> Callable:
    """``fn`` made to run on one of the set (``run``); the wrapper's
    ``confined`` attribute is True."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return run(fn, *args, **kwargs)
    wrapper.confined = True
    return wrapper
