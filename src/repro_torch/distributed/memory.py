"""Live storage bytes of one step on one device: the port's counterpart of
the ``memory_analysis()`` of the reference's compiled step.

XLA plans a compiled program's buffers and reports argument, output,
alias, temp and peak bytes a device.  An eager PyTorch step has no such
plan: its memory is whatever the tensors alive at each moment hold.
``MemoryTracker`` is a ``TorchDispatchMode`` that follows them, on meta
tensors (the dry run), on DTensors' local shards and on CUDA tensors
alike:

* the step's arguments are registered first, as the local shards of
  their DTensors (``add_arguments``);
* every op's output storage that is not one of its inputs' storages and
  is not already live is counted once, keyed by the storage's identity
  (never its ``data_ptr``, which is 0 for every meta tensor).  So a view
  or an in-place op allocates nothing;
* a weak reference on the storage takes its bytes off when it dies, on
  whichever thread that happens (autograd's device thread runs a CUDA
  backward);
* the peak is the most live bytes after any op;
* ``add_outputs`` reads the step's result: its storages' bytes, and the
  part of them that is an argument's storage (AdamW's in-place update of
  the state, a decode cache updated in place).

It sees the ops ``distributed/cost.py``'s counter sees (``LocalOps``): a
DTensor op passes (DTensor turns it into local ops, which it sees) and
the ops DTensor's sharding propagation runs on fake tensors are ignored.  Autograd's saved
tensors are outputs of the forward's ops and live until the backward
frees them; remat's recompute runs its ops again in the backward; a
``local_map`` region runs plain ops; a hand-written kernel's wrapper (or
on meta tensors its meta function) allocates its outputs with an aten op.
All of these it counts like any op's outputs.

What it cannot see: memory a single op allocates inside its own body and
frees before it returns (scratch inside a hand-written kernel's C++ body,
cuBLAS and cuDNN workspaces, a library op's temporaries), and the CUDA
caching allocator's rounding of each block to 512 bytes.
"""
from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, Iterator, List, Set

import torch
from torch.utils._pytree import tree_leaves

from repro_torch._dtensor import is_dtensor
from repro_torch.distributed.cost import LocalOps, fake_type

#: the reference's ``memory_analysis()`` keys that an eager step has
KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
        "alias_size_in_bytes", "temp_size_in_bytes", "peak_memory_in_bytes")

#: what ``result()`` leaves out, and why
NO_GENERATED_CODE = ("generated_code_size_in_bytes: an eager step has no "
                     "compiled program")
UNSEEN = ("scratch an op allocates and frees inside its body (a "
          "hand-written kernel's C++ scratch, cuBLAS/cuDNN workspaces, a "
          "library op's temporaries) and the CUDA caching allocator's "
          "rounding of each block to 512 bytes")


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if is_dtensor(t) else t


def _storage(t: torch.Tensor):
    """``t``'s untyped storage, or None for a tensor without one."""
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


class MemoryTracker(LocalOps):
    """Live, peak, argument, output and alias bytes of the ops run inside
    it (see the module's docstring); ``result()`` -> ``KEYS``."""

    def __init__(self):
        super().__init__()
        self._lock = threading.Lock()
        self._bytes: Dict[int, int] = {}          # live storage -> bytes
        self._refs: Dict[int, weakref.ref] = {}
        self._dead: List[int] = []                # died since the reap
        self._args: Set[int] = set()
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self.output_bytes = 0
        self.alias_bytes = 0

    # -------------------------------------------------------- bookkeeping
    def _died(self, key: int, _ref) -> None:
        # a weakref callback: it may run inside any allocation, so it
        # only appends (atomic); the counts are settled under the lock
        self._dead.append(key)

    def _reap(self) -> None:
        while self._dead:
            key = self._dead.pop()
            self._refs.pop(key, None)
            self.live -= self._bytes.pop(key, 0)

    def _add(self, st) -> int:
        """Count storage ``st`` if it is not live yet (holding the lock);
        -> its key."""
        key = st._cdata
        n = st.nbytes()
        have = self._bytes.get(key)
        if have is None:
            self._bytes[key] = n
            self._refs[key] = weakref.ref(st, lambda r, k=key:
                                          self._died(k, r))
            self.live += n
        elif n > have:                  # resized in place
            self._bytes[key] = n
            self.live += n - have
        if self.live > self.peak:
            self.peak = self.live
        return key

    def add_arguments(self, tree: Any, argument: bool = True) -> int:
        """Register the step's arguments (their local shards) -> their
        bytes.  With ``argument=False`` they count as live only: inputs
        the record's argument bytes leave out (the dry run's batch)."""
        with self._lock:
            self._reap()
            for t in tree_leaves(tree):
                if isinstance(t, torch.Tensor):
                    st = _storage(_local(t))
                    if st is None or st._cdata in self._bytes:
                        continue
                    key = self._add(st)
                    if argument:
                        self._args.add(key)
                        self.argument_bytes += st.nbytes()
        return self.argument_bytes

    def add_outputs(self, tree: Any) -> None:
        """Read the step's result: its storages' bytes, and those of them
        that are the arguments'."""
        seen: Set[int] = set()
        with self._lock:
            self._reap()
            for t in tree_leaves(tree):
                if not isinstance(t, torch.Tensor):
                    continue
                st = _storage(_local(t))
                if st is None or st._cdata in seen:
                    continue
                seen.add(st._cdata)
                self.output_bytes += st.nbytes()
                if st._cdata in self._args:
                    self.alias_bytes += st.nbytes()

    def result(self) -> Dict[str, int]:
        """The reference's ``memory_analysis()`` keys an eager step has:
        temp is what the peak holds beyond the arguments and the outputs
        that are not arguments, floored at 0."""
        with self._lock:
            self._reap()
            peak = max(self.peak, self.argument_bytes)
        temp = max(0, peak - self.argument_bytes
                   - (self.output_bytes - self.alias_bytes))
        return {"argument_size_in_bytes": self.argument_bytes,
                "output_size_in_bytes": self.output_bytes,
                "alias_size_in_bytes": self.alias_bytes,
                "temp_size_in_bytes": temp,
                "peak_memory_in_bytes": peak}

    # ----------------------------------------------------------- dispatch
    def local_op(self, func, args, kwargs, out) -> None:
        fake = fake_type()
        ins = set()
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                st = _storage(t)
                if st is not None:
                    ins.add(st._cdata)
        with self._lock:
            self._reap()
            for t in tree_leaves(out):
                # a factory op makes the fake tensors of that inference
                if isinstance(t, torch.Tensor) and not isinstance(t, fake):
                    st = _storage(t)
                    if st is not None and st._cdata not in ins:
                        self._add(st)


@contextlib.contextmanager
def tracking(arguments: Any = (), live: Any = ()
             ) -> Iterator[MemoryTracker]:
    """A ``MemoryTracker`` over the block, ``arguments`` registered as
    the step's arguments and ``live`` as live inputs only."""
    tracker = MemoryTracker()
    tracker.add_arguments(arguments)
    tracker.add_arguments(live, argument=False)
    with tracker:
        yield tracker


def analyze(fn, *args, **kwargs) -> Dict[str, int]:
    """The memory of one call ``fn(*args, **kwargs)``: ``KEYS``, its
    arguments registered first and its result read as the outputs."""
    with tracking((args, kwargs)) as tracker:
        tracker.add_outputs(fn(*args, **kwargs))
    return tracker.result()
