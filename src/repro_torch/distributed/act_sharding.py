"""Activation sharding anchors, threaded to the model through a
contextvar.

The port's copy of the reference's ``distributed/act_sharding.py``.  In
the reference the anchors keep XLA's sharding propagation from picking
feature-dim shardings that conflict with the batch/seq sharding of the
inputs.  In the port a DTensor op's output placements follow its inputs'
(a sharded contraction leaves its product ``Partial``), so the anchors
redistribute an activation back to the ambient (batch, seq) placements.

The launcher sets the ambient spec around a step (``activation_sharding``)
and the model calls ``constrain`` / ``constrain_at``.  On a plain tensor
(one card, the unit tests, the population's vmap) or with no ambient
spec they return their input: the unsharded step computes what it did.

A sharded step runs each layer as one region of plain tensors on each
rank's batch shard (``repro_torch._dtensor``), so the anchors act where
DTensors remain: the embedding, the end of each repeat of a group's
pattern (the reference's scanned step returns there) and the logits.
The reference's anchors inside a layer (its dense outputs, the MoE
dispatch, the recurrent carries) anchor the batch dim of regions that the
port runs batch-locally as a whole; there they see plain tensors and do
nothing.

Every model module imports this one, so it imports nothing of the rest
of ``repro_torch.distributed`` until a DTensor reaches an anchor.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import TYPE_CHECKING, Optional

from repro_torch._dtensor import is_dtensor

if TYPE_CHECKING:
    from repro_torch.distributed.auto_shard import Spec

_SPEC: contextvars.ContextVar[Optional[Spec]] = contextvars.ContextVar(
    "repro_torch_act_spec", default=None)


@contextlib.contextmanager
def activation_sharding(spec: Optional[Spec]):
    tok = _SPEC.set(spec)
    try:
        yield
    finally:
        _SPEC.reset(tok)


def current_spec() -> Optional[Spec]:
    return _SPEC.get()


def _redistribute(x, entries):
    from repro_torch.distributed.auto_shard import placements
    target = tuple(placements(entries, x.device_mesh))
    if target == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, target)


def constrain_at(x, batch_dim: int):
    """Anchor only dim ``batch_dim`` of x to the ambient batch axes — for
    recurrent carries and time-major inputs, whose sharding would
    otherwise be re-derived (and re-gathered) every step of the loop."""
    spec = _SPEC.get()
    if spec is None or not is_dtensor(x) or x.ndim <= batch_dim:
        return x
    parts = [None] * x.ndim
    parts[batch_dim] = spec[0] if len(spec) > 0 else None
    return _redistribute(x, parts)


def constrain(x):
    """Anchor an activation to the ambient (batch, seq) spec,
    rank-adaptively: (B, F) -> (b, None); (B, S, ...) -> (b, s, None,
    ...).  The stored spec is a 2-entry Spec(batch_axes, seq_axes)."""
    spec = _SPEC.get()
    if spec is None or not is_dtensor(x) or x.ndim < 2:
        return x
    b = spec[0] if len(spec) > 0 else None
    s = spec[1] if len(spec) > 1 else None
    full = [b, None] if x.ndim == 2 else [b, s] + [None] * (x.ndim - 2)
    return _redistribute(x, full)
