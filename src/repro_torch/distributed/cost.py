"""Per-device cost of a step, from the ops each rank dispatches on its
local shards: the port's counterpart of the reference's
``distributed/hlo.py``.

The reference reads the per-device cost off the compiled, SPMD-partitioned
HLO text.  An eager PyTorch step has no HLO: ``CostCounter`` is a
``TorchDispatchMode`` that watches the aten ops the step runs on plain
(local) tensors.  It lets a DTensor op pass (``NotImplemented``, as
PyTorch's ``CommDebugMode`` does), so DTensor turns the op into its local
op and the collectives that redistribute its inputs, and the counter sees
those — never the global op, whose shapes are the whole mesh's:

* FLOPs: ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention) applied to the local op's shapes, as the
  reference counts ``dot`` and ``convolution``;
* bytes: the inputs and outputs of every op that materialises a tensor
  (views, uninitialised allocations, metadata queries such as a tensor's
  device, and the wait on a collective move nothing).  Eager PyTorch
  fuses nothing outside the hand-written kernels, so each op is one trip
  to memory;
* collectives: counted by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, and ``broadcast``), with each
  device's link bytes from the ring model ``_ici_bytes``, the reference's
  as it is;
* a hand-written kernel launch is no aten op: its wrapper charges its
  work formula (``kernels/work.py``) to the open counter.

The reference's HLO parser recovers ``while``-loop trip counts, since XLA
costs a loop body once.  It has no counterpart here: an eager step runs
every iteration of its Python loops (the layers, the mLSTM chunks, the
sLSTM time steps), and the counter sees each one.

All numbers are per device: under a fake process group (the dry run) the
counter sees one rank's shards (the dry run's: the last rank's), which
every rank's equal in shape.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Iterator

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

#: (namespace::name of a functional collective) -> its kind
_KINDS = {
    "_c10d_functional::all_reduce": "all-reduce",
    "_c10d_functional::all_reduce_": "all-reduce",
    "_c10d_functional::all_reduce_coalesced": "all-reduce",
    "_c10d_functional::all_gather_into_tensor": "all-gather",
    "_c10d_functional::all_gather_into_tensor_out": "all-gather",
    "_c10d_functional::all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional::reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional::all_to_all_single": "all-to-all",
    "_dtensor::shard_dim_alltoall": "all-to-all",
    "_c10d_functional::broadcast": "broadcast",
}

_TRANS_OPS = {"exp", "log", "tanh", "rsqrt", "sqrt", "pow", "sigmoid",
              "sin", "cos", "exp2", "log1p", "expm1", "erf"}

#: ops that allocate without writing, or wait on a collective's result:
#: they move no bytes
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "wait_tensor", "_wrap_tensor_autograd"}


def _ici_bytes(kind: str, result_bytes: int, group: int) -> float:
    ring = (group - 1) / group if group > 1 else 0.0
    if kind == "all-reduce":
        return 2.0 * result_bytes * ring
    if kind == "all-gather":
        return result_bytes * ring
    if kind == "reduce-scatter":
        return result_bytes * group * ring   # result is the shard
    if kind == "all-to-all":
        return result_bytes * ring
    return float(result_bytes)               # collective-permute


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)) and all(
            not isinstance(t, (list, tuple, dict)) for t in tree):
        return sum(t.numel() * t.element_size() for t in tree
                   if isinstance(t, torch.Tensor))
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _is_view(func) -> bool:
    """Every output aliases an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


#: per aten op: (name, collective kind, FLOP formula, whether it moves
#: bytes, whether it is transcendental), worked out at its first call
_INFO: Dict[Any, tuple] = {}


def _op_info(func) -> tuple:
    name = func._schema.name
    base = name.split("::")[-1]
    return (base, _KINDS.get(name), flop_registry.get(func._overloadpacket),
            not (_is_view(func) or base in _NO_TRAFFIC),
            base.rstrip("_") in _TRANS_OPS)


def _group_size(args, kwargs) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in list(args) + list(kwargs.values())
             if isinstance(a, str)]
    for name in reversed(names):
        try:
            return _resolve_process_group(name).size()
        except (RuntimeError, ValueError, KeyError):
            continue
    return 1


class LocalOps(TorchDispatchMode):
    """A dispatch mode over the aten ops each rank runs on its local
    tensors: a higher-order operator runs as it is, a DTensor op is
    declined (``NotImplemented``: DTensor runs it as local ops and
    collectives, which come back here), and an op on fake tensors
    (DTensor's sharding propagation infers a global op's output there,
    an op that runs nowhere) runs unseen.  Every other op runs and is
    passed to ``local_op``."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not any(issubclass(t, fake_type()) for t in types):
            self.local_op(func, args, kwargs, out)
        return out

    def local_op(self, func, args, kwargs, out) -> None:
        raise NotImplementedError


class CostCounter(LocalOps):
    """Per-device FLOPs, bytes and collectives of the ops run inside it
    (see the module's docstring); ``result()`` -> the reference's keys."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.transcendentals = 0.0
        self.ici_bytes = 0.0
        self.coll_counts: Dict[str, int] = {}
        self.coll_bytes: Dict[str, float] = {}
        self.ops = 0
        self.by_op: Dict[str, list] = {}
        self.tally = work.Tally()

    def local_op(self, func, args, kwargs, out) -> None:
        self.ops += 1
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _op_info(func)
        base, kind, formula, traffic, trans = info
        if kind is not None:
            ici = _ici_bytes(kind, _nbytes(out), _group_size(args, kwargs))
            self.ici_bytes += ici
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + ici
        flops = 0.0
        if formula is not None:
            flops = float(formula(*args, **kwargs, out_val=out))
        written = _nbytes(out)
        if trans:
            self.transcendentals += written
        nbytes = 0
        if traffic and written:
            nbytes = _nbytes(args) + _nbytes(kwargs) + written
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(base, [0, 0.0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def result(self) -> Dict[str, Any]:
        """The reference's ``analyze`` keys, the kernels' charged work
        added in (and itemised under ``kernels``)."""
        return {
            "flops": self.flops + self.tally.flops,
            "bytes accessed": self.bytes + self.tally.bytes,
            "transcendentals": self.transcendentals,
            "ici_bytes": self.ici_bytes,
            "collective_counts": dict(self.coll_counts),
            "collective_bytes": dict(self.coll_bytes),
            "kernels": {k: dict(v) for k, v in self.tally.kernels.items()},
            "aten_ops": self.ops,
            "top_ops": self.top_ops(),
        }

    def top_ops(self, n: int = 8) -> Dict[str, Dict[str, float]]:
        """The ``n`` aten ops that moved the most bytes: calls, FLOPs and
        bytes of each."""
        rows = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])[:n]
        return {k: {"calls": c, "flops": f, "bytes": b}
                for k, (c, f, b) in rows}


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def fake_type():
    """The class of the fake tensors DTensor's sharding propagation runs
    ops on."""
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor


@contextlib.contextmanager
def counting() -> Iterator[CostCounter]:
    """A ``CostCounter`` over the block, with the kernels' launches
    charged to it."""
    counter = CostCounter()
    with work.charging() as tally:
        counter.tally = tally
        with counter:
            yield counter


def analyze(fn, *args, **kwargs) -> Dict[str, Any]:
    """Per-device cost of one call ``fn(*args, **kwargs)``: the
    reference's keys (``flops``, ``bytes accessed``, ``transcendentals``,
    ``ici_bytes``, ``collective_counts``, ``collective_bytes``)."""
    with counting() as counter:
        fn(*args, **kwargs)
    return counter.result()
