"""Faults planted under the timed path, for the check's own tests and for
the readings its limits are set from (``readings.py``).  None of the
benchmark's runs plants one.

- ``unchanged``: the optimizer returns the state it was given (the step
  count moved on, the gradient norm reported);
- ``half_batch``: the loss is the mean over the first half of each
  trial's rows, the rest left out;
- ``double_leaf``: the first parameter's update is applied twice, the
  step's answer altered where it is produced.

Each is a context manager that patches the port's module attributes the
step reads at call time, and restores them on leaving.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

FAULTS = ("unchanged", "half_batch", "double_leaf")


@contextlib.contextmanager
def _patched(obj, name, value) -> Iterator[None]:
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _unchanged(adamw_update):
    from repro_torch.optim.adamw import global_norm

    def update(grads, opt_state, params, cfg, lr=None, *, decay=None):
        return (params, dict(opt_state, step=opt_state["step"] + 1),
                {"grad_norm": global_norm(grads)})
    return update


def _double_leaf(adamw_update):
    from repro_torch.models.model import tensors

    def update(grads, opt_state, params, cfg, lr=None, *, decay=None):
        first = next(tensors(params))
        old = first.clone()
        out = adamw_update(grads, opt_state, params, cfg, lr, decay=decay)
        new = next(tensors(out[0]))
        new.copy_(old + 2 * (new - old))
        return out
    return update


@contextlib.contextmanager
def planted(fault: str) -> Iterator[None]:
    """The port with ``fault`` planted inside the block."""
    from repro_torch.core import vmap_trials
    from repro_torch.launch import steps
    from repro_torch.models.model import LM
    if fault == "half_batch":
        loss = LM.loss

        def half(self, params, batch):
            return loss(self, params, {k: v[: v.shape[0] // 2]
                                       for k, v in batch.items()})
        with _patched(LM, "loss", half):
            yield
        return
    make = {"unchanged": _unchanged, "double_leaf": _double_leaf}[fault]
    with contextlib.ExitStack() as stack:
        for mod in (vmap_trials, steps):
            stack.enter_context(_patched(mod, "adamw_update",
                                         make(mod.adamw_update)))
        yield
