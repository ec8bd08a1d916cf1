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
``opt_state`` and ``params`` (which the caller gives up).  A caller that
stops an update part way holds a state that is partly updated
(``launch/train.py`` then saves no checkpoint of it).

On the card the update is the hand-written kernels of
``kernels/adamw.py`` (``csrc/adamw.cu``): the norm in one launch a leaf
and one to finish it, then one pass over each leaf, in place, with no
temporaries.  Meta tensors (the dry run) take their meta functions.
Under ``torch.func.vmap`` the rule of an ``autograd.Function``
(``_AdamW``) hands them the population's stacked (P, ...) tensors, so
one launch a leaf serves every trial, each with its own step, learning
rate, decay and norm.

On the CPU the plain update runs (``_update``, in the reference's order
of operations), under vmap through the same rule, a trial at a time.
Only this plain path works a slice of rows at a time (``CHUNK``), so
that its temporaries come to a few hundred megabytes rather than a
second copy of the state (recurrentgemma-2b's is 35 GB).

A sharded state (DTensors, ``launch/steps.py``) takes the norm over the
DTensors (the sum across ranks), then updates each leaf on its local
shards, by the kernel on the card: the gradient redistributed to its
parameter's placements first (a no-op when ``grad_specs`` anchored it),
the moments on the parameter's placements, the step's scalars
replicated; the update is elementwise, so each rank's shard gets what
the whole tensor would.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import torch

from repro_torch._dtensor import is_dtensor
from repro_torch.kernels import ops
from repro_torch.models.model import tensors, tree_map

#: elements of a leaf the plain update takes at once
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
    leaves = [list(tensors(t)) for t in (grads, opt_state["m"],
                                         opt_state["v"], params)]
    if any(is_dtensor(p) for p in leaves[3]):
        gnorm = _sharded(*leaves, step, lr, decay, cfg)
    elif _transformed(step, lr, decay, *leaves[0], *leaves[3]):
        gnorm = _AdamW.apply(step, lr, decay, cfg,
                             *(t for ts in leaves for t in ts))
    else:
        gnorm = _all_leaves(None, *leaves, step, lr, decay, cfg)
    same = lambda t: tree_map(lambda a: a, t)  # noqa: E731
    return (same(params), {"m": same(opt_state["m"]),
                           "v": same(opt_state["v"]), "step": step},
            {"grad_norm": gnorm})


class _AdamW(torch.autograd.Function):
    """Every leaf updated in place -> the norm: a Function so that under
    ``torch.func.vmap`` its rule gets the trials' stacked tensors."""

    @staticmethod
    def forward(step, lr, decay, cfg, *leaves):
        return _all_leaves(None, *_quarters(leaves), step, lr, decay, cfg)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("adamw_update has no derivative")

    @staticmethod
    def vmap(info, in_dims, step, lr, decay, cfg, *leaves):
        gs, ms, vs, ps = _quarters([_stacked(t, d)
                                    for t, d in zip(leaves, in_dims[4:])])
        step, lr, decay = (t if d is None else t.movedim(d, 0)
                           for t, d in zip((step, lr, decay), in_dims))
        return _all_leaves(info.batch_size, gs, ms, vs, ps, step, lr, decay,
                           cfg), 0


def _quarters(leaves):
    """(grads, m, v, params) from their leaves laid end to end."""
    k = len(leaves) // 4
    return [list(leaves[i * k:(i + 1) * k]) for i in range(4)]


def _stacked(t, dim):
    """A vmapped leaf as its (trials, ...) tensor.  Every leaf carries the
    trials' dim (a state leaf every trial shared could not take each
    trial's update; a gradient of vmapped parameters has the dim)."""
    if dim is None:
        raise ValueError("adamw_update under vmap: a leaf without the "
                         "trials' dim")
    return t.movedim(dim, 0)


def _transformed(*ts) -> bool:
    """Whether a ``torch.func`` transform wraps any of ``ts``."""
    return any(isinstance(t, torch.Tensor)
               and torch._C._functorch.is_functorch_wrapped_tensor(t)
               for t in ts)


def _all_leaves(trials, gs, ms, vs, ps, step, lr, decay, cfg):
    """Every leaf updated in place -> the norm.  ``trials``: None for one
    trial's leaves, else the count of the stacked (trials, ...) leaves,
    with step, lr and decay (trials,) or shared by every trial."""
    if ps[0].device.type != "cpu":
        norm, coef = ops.adamw_norm(gs, step, cfg, trials)
        for g, m, v, p in zip(gs, ms, vs, ps):
            ops.adamw_leaf(g, m, v, p, coef, lr, decay, cfg, trials)
        return norm
    if trials is None:
        return _plain(gs, ms, vs, ps, step, lr, decay, cfg)

    def at(x, i):
        return x[i] if isinstance(x, torch.Tensor) and x.dim() else x
    return torch.stack([
        _plain(*([t[i] for t in ts] for ts in (gs, ms, vs, ps)),
               at(step, i), at(lr, i), at(decay, i), cfg)
        for i in range(trials)])


def _plain(gs, ms, vs, ps, step, lr, decay, cfg):
    """One trial's plain update of every leaf, in place -> the norm."""
    gnorm = global_norm(gs)
    scale, c1, c2 = _coefficients(gnorm, step, cfg)
    for g, m, v, p in zip(gs, ms, vs, ps):
        _plain_leaf(g, m, v, p, scale, c1, c2, lr, cfg, decay)
    return gnorm


def _sharded(gs, ms, vs, ps, step, lr, decay, cfg):
    """The update of a sharded state -> the norm: the norm and the
    step's scalars over the DTensors, each leaf on its local shards."""
    gnorm = global_norm(gs)
    scale, c1, c2, lr = (_local(t) for t in (*_coefficients(gnorm, step,
                                                            cfg), lr))
    coef = None
    for g, m, v, p in zip(gs, ms, vs, ps):
        if is_dtensor(p):
            if tuple(g.placements) != tuple(p.placements):
                g = g.redistribute(p.device_mesh, p.placements)
            g, m, v, p = (t.to_local() for t in (g, m, v, p))
        if p.device.type == "cpu":
            _plain_leaf(g, m, v, p, scale, c1, c2, lr, cfg, decay)
            continue
        if coef is None:
            coef = torch.stack([torch.ones_like(c1) if scale is None
                                else scale, c1, c2]).reshape(1, 3)
        ops.adamw_leaf(g, m, v, p, coef, lr, decay, cfg)
    return gnorm


def _coefficients(gnorm, step, cfg: AdamWConfig):
    """(clip scale, None without clipping; c1; c2) of the norm and the
    step being taken."""
    scale = None
    if cfg.clip_norm:
        scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    steps = step.to(torch.float32)
    return scale, 1.0 - torch.pow(cfg.b1, steps), 1.0 - torch.pow(cfg.b2,
                                                                  steps)


def _plain_leaf(g, m, v, p, scale, c1, c2, lr, cfg, decay):
    """One leaf's plain update, written into p, m and v a slice of rows
    at a time."""
    for sl in _row_slices(p):
        new = _update(g[sl], m[sl], v[sl], p[sl], scale, c1, c2, lr, cfg,
                      decay)
        for dst, src in zip((p, m, v), new):
            dst[sl].copy_(src)


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
