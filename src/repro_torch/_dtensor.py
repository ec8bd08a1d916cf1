"""Regions of plain-tensor code over DTensors' local shards.

A sharded step (``launch/steps.py``) hands the model DTensors.  The model
runs each layer, and the embedding and unembedding, as one region of
plain tensors on each rank's shards
(``torch.distributed.tensor.experimental.local_map``), FSDP-style: the
activation keeps its batch (or row) shards, the region's weights are
gathered, and each weight's gradient comes back as a pending sum over
the shards, which the backward of the gather reduce-scatters onto the
weight's own placements.  Inside a region
nothing is a DTensor, so the hand-written kernels, which take raw
pointers, only ever see local tensors, and ops with no DTensor sharding
rule (the MoE's capacity dispatch, ``log_sigmoid``'s backward, a row
write into a cache) need none.

A leaf module: importing it imports nothing of the port and nothing of
``torch.distributed``.
"""
from __future__ import annotations

import sys

import torch


def is_dtensor(x) -> bool:
    """Whether x is a DTensor (none can exist before PyTorch's DTensor
    module is imported, so a plain run never imports it here)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def on_local_shards(fn, args, in_placements, out_placements,
                    grad_placements=None):
    """``fn(*args)`` run on each rank's local shards: every DTensor (or
    tensor, taken as replicated) of ``args`` redistributed to its entry of
    ``in_placements`` and passed as its local tensor, the outputs wrapped
    as DTensors with ``out_placements`` (a list, one entry an output: fn
    returns a tuple when it has more than one); ``grad_placements``
    (default ``in_placements``) are what each input's local gradient is
    taken to be.  Non-tensor arguments take ``None``."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    args = tuple(
        DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                           run_check=False)
        if isinstance(a, torch.Tensor) and not is_dtensor(a) else a
        for a in args)
    # local_map reads a tuple as one entry an output, a list as one
    # output's placements
    outs = (list(out_placements[0]) if len(out_placements) == 1
            else tuple(list(p) for p in out_placements))
    return local_map(fn, out_placements=outs,
                     in_placements=tuple(in_placements),
                     in_grad_placements=(None if grad_placements is None
                                         else tuple(grad_placements)),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def batch_placements(x) -> tuple:
    """x's placements with its batch (dim 0) shards kept and every other
    mesh dim replicated: the placements of a batch-local region."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard(0) else Replicate() for p in x.placements)


def row_placements(x, gather_last: bool = True) -> tuple:
    """x's placements with the shards of its leading dims kept and, when
    ``gather_last``, its last dim (features) gathered: the placements of
    a row-local product."""
    from torch.distributed.tensor import Replicate
    n = x.ndim - 1 if gather_last else x.ndim
    return tuple(p if p.is_shard() and p.dim < n else Replicate()
                 for p in x.placements)


def on_batch_shards(fn, batched, params, outs):
    """``fn(batched, params)`` on each rank's batch shard: ``batched`` a
    tree of activations with their batch in dim 0 (the first one's batch
    shards kept, their other dims gathered), ``params`` a tree of weights
    replicated in, each weight's gradient a pending sum over the batch
    shards.  ``outs`` names the placement of each output, in the order of
    its flattened tree: "batch" (sharded like the first activation),
    "mean" (a mean over the batch: each shard's mean, weighted by its
    share of the batch, summed across the shards) or "sum" (each shard's
    value summed across the shards)."""
    from torch.utils._pytree import tree_flatten
    acts = tree_flatten(batched)[0]
    return _on_shards(fn, batched, params, outs, batch_placements(acts[0]))


def on_row_shards(fn, x, params, *, gather_last: bool = True):
    """``fn(x, params)`` -> one tensor with x's leading dims, on each
    rank's shard of x's leading dims (its last dim gathered unless
    ``gather_last`` is False: token ids, whose every dim is a row), with
    ``params`` gathered (each gradient a pending sum over x's shards): a
    sharded activation's product with sharded weights, FSDP-style, which
    never flattens two dims sharded over different mesh dims."""
    return _on_shards(fn, x, params, ["batch"],
                      row_placements(x, gather_last))


def on_row_sums(fn, rows, n_out: int):
    """``fn(rows, ())`` -> ``n_out`` sums over rows, on each rank's shard
    of the leading dims of ``rows`` (a tuple of activations with the same
    leading dims, the first one's last dim gathered): each a pending sum
    over the row shards.  A reduction to a scalar stays on the shards
    (a loss's backward builds no global-shape gradient on a rank)."""
    return _on_shards(fn, rows, (), ["sum"] * n_out,
                      row_placements(rows[0]))


def pending_sum(bp) -> tuple:
    """The placements of a region's weight gradients, and of its "mean"
    outputs, for activations on ``bp``: a pending sum over the mesh dims
    the activations are sharded on (the gradient of the weights' gather
    reduce-scatters it)."""
    from torch.distributed.tensor import Partial, Replicate
    return tuple(Partial("sum") if p.is_shard() else Replicate()
                 for p in bp)


#: the placements of a region's weight gradients (``pending_sum``); a
#: fault check replaces it
weight_grads = pending_sum


def _on_shards(fn, batched, params, outs, bp):
    from torch.distributed.tensor import Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten
    acts, a_spec = tree_flatten(batched)
    leaves, p_spec = tree_flatten(params)
    rep = tuple(Replicate() for _ in bp)
    psum = pending_sum(bp)
    B, n = acts[0].shape[0], len(acts)
    out_spec = []

    def local(*flat):
        out, ospec = tree_flatten(fn(tree_unflatten(list(flat[:n]), a_spec),
                                     tree_unflatten(list(flat[n:]), p_spec)))
        out_spec.append(ospec)
        share = flat[0].shape[0] / B
        out = [o * share if kind == "mean" else o
               for o, kind in zip(out, outs)]
        return tuple(out) if len(out) > 1 else out[0]

    tensor = [isinstance(t, torch.Tensor) for t in leaves]
    ins = (bp,) * n + tuple(rep if t else None for t in tensor)
    grads = (bp,) * n + tuple(weight_grads(bp) if t else None
                              for t in tensor)
    res = on_local_shards(local, (*acts, *leaves), ins,
                          [bp if kind == "batch" else psum for kind in outs],
                          grads)
    return tree_unflatten(list(res) if len(outs) > 1 else [res],
                          out_spec[0])
