"""AdamW with decoupled weight decay, bias correction and global-norm
clipping: the reference's ``optim/adamw.py`` over dicts of tensors.

The moments are float32 whatever the parameters' dtype, and the update
reads gradients of any dtype (the train step differentiates the bf16
cast of float32 masters, as the reference does), which ``torch.optim``
does not.  ``lr`` may be a tensor, and the whole update runs under
``torch.func.vmap``, each trial with its own learning rate and weight
decay (``core/vmap_trials.py``).

The update is the counterpart of the reference's jit with donated
state: the new moments and parameters are written into the tensors of
``opt_state`` and ``params`` (which the caller gives up), a slice of rows
at a time, so an update holds a few hundred megabytes of temporaries
rather than a second copy of the state (recurrentgemma-2b's is 35 GB).
A caller that stops an update part way holds a state that is partly
updated (``launch/train.py`` then saves no checkpoint of it).

A sharded state (DTensors, ``launch/steps.py``) updates each leaf on its
local shards: the gradient redistributed to its parameter's placements
first (a no-op when ``grad_specs`` anchored it), the moments on the
parameter's placements, the step's scalars replicated; the update is
elementwise, so each rank's shard gets what the whole tensor would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch._dtensor import is_dtensor
from repro_torch.models.model import tensors, tree_map

#: elements of a leaf updated at once
CHUNK = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                      # peak lr (scheduled externally)
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0                # 0 disables clipping


def adamw_init(params) -> Dict[str, Any]:
    """Zero float32 moments shaped like ``params`` and an int32 step, on
    the parameters' device."""
    zeros = lambda p: tree_map(  # noqa: E731
        lambda a: torch.zeros_like(a, dtype=torch.float32), p)
    device = next(tensors(params)).device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(a.float()))
                          for a in tensors(tree)))


def _update(g, m, v, p, scale, c1, c2, lr, cfg: AdamWConfig, decay):
    """One leaf's (new p, new m, new v), in the reference's order of
    operations."""
    g = g.float()
    if scale is not None:
        g = g * scale
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
    delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
    p32 = p.float()
    if cfg.weight_decay:
        delta = delta + cfg.weight_decay * p32
    new_p = (p32 - lr * delta).to(p.dtype)
    if decay is not None:
        new_p = (new_p.float() - lr * decay * p32).to(p.dtype)
    return new_p, m, v


def adamw_update(grads, opt_state, params, cfg: AdamWConfig,
                 lr=None, *, decay=None
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """Returns (new_params, new_opt_state, metrics {"grad_norm"}, taken
    before clipping).

    ``lr`` may be a float or a tensor (a schedule's value, or a trial's
    learning rate under vmap); it falls back to ``cfg.lr``.  ``decay``, a
    per-trial weight decay, is applied after the step from the old
    parameters, p − lr·decay·p_old, as the reference's population step
    applies it (with ``cfg.weight_decay`` 0 there).  The new parameters
    and moments are written into the given tensors (see the module); the
    new step is a new tensor."""
    lr = cfg.lr if lr is None else lr
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = None
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    steps = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, steps)
    c2 = 1.0 - torch.pow(cfg.b2, steps)

    scale, c1, c2, lr_l = (_local(t) for t in (scale, c1, c2, lr))

    def leaf(g, m, v, p):
        if is_dtensor(p):
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            local_leaf(g.to_local(), m.to_local(), v.to_local(),
                       p.to_local())
            return p, m, v
        return local_leaf(g, m, v, p)

    def local_leaf(g, m, v, p):
        for sl in _row_slices(p):
            new = _update(g[sl], m[sl], v[sl], p[sl], scale, c1, c2, lr_l,
                          cfg, decay)
            for dst, src in zip((p, m, v), new):
                dst[sl].copy_(src)
        return p, m, v

    new = [leaf(g, m, v, p) for g, m, v, p in zip(
        tensors(grads), tensors(opt_state["m"]), tensors(opt_state["v"]),
        tensors(params))]

    def rebuild(i):
        it = iter([n[i] for n in new])
        return tree_map(lambda _: next(it), params)

    return (rebuild(0), {"m": rebuild(1), "v": rebuild(2), "step": step},
            {"grad_norm": gnorm})


def _local(t):
    """A replicated DTensor scalar's value as a plain tensor; anything
    else as it is."""
    return t.to_local() if is_dtensor(t) else t


def _row_slices(p: torch.Tensor):
    """Slices of ``p``'s leading dim of at most ``CHUNK`` elements each
    (the whole tensor when it has no dims)."""
    if p.dim() == 0:
        return [...]
    rows = max(1, CHUNK // max(1, p[0].numel()))
    return [slice(i, i + rows) for i in range(0, p.shape[0], rows)]
