"""Regions of plain-tensor code over DTensors' local shards.

A sharded step (``launch/steps.py``) hands the model DTensors.  The model
runs each layer, and the embedding and unembedding, as regions of
plain tensors on each rank's shards
(``torch.distributed.tensor.experimental.local_map``), FSDP-style: the
activation keeps its batch (or row) shards, the region's weights are
gathered, and each weight's gradient comes back as a pending sum over
the shards, which the backward of the gather reduce-scatters onto the
weight's own placements.  Where the sequence is sharded too (sequence
parallelism, ``on_seq_shards``), a region keeps each rank's (batch,
sequence) shard and learns the shard's first position; activations it
takes with their sequence gathered (attention's keys and values) give
back gradients that are pending sums over the sequence shards, which the
backward of their gather reduce-scatters.  Inside a region
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


def seq_placements(x) -> tuple:
    """x's placements with its batch (dim 0) and sequence (dim 1) shards
    kept and every other mesh dim replicated: the placements of a
    sequence-parallel region."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard(0) or p.is_shard(1) else Replicate()
                 for p in x.placements)


def seq_shards(x) -> int:
    """How many shards x's sequence (dim 1) is split into, 1 when x is
    no DTensor, has fewer than 3 dims or its shards would be uneven
    (a region then takes the sequence gathered)."""
    if not is_dtensor(x) or x.ndim < 3:
        return 1
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(1):
            n *= x.device_mesh.size(i)
    return n if x.shape[1] % n == 0 else 1


def seq_offset(mesh, placements, length: int) -> int:
    """The first position of this rank's shard of a dim 1 of ``length``
    placed by ``placements`` on ``mesh``: a dim that several mesh dims
    shard is split by them in mesh-dim order (sizes divide)."""
    coord = mesh.get_coordinate()
    off = 0
    for i, p in enumerate(placements):
        if p.is_shard(1):
            length //= mesh.size(i)
            off += coord[i] * length
    return off


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
    bp = batch_placements(acts[0])
    return _on_shards(fn, [(batched, bp)], params, outs, {"batch": bp})


def on_seq_shards(fn, seq, gathered, params, outs):
    """``fn(seq, gathered, params, offset)`` on each rank's (batch,
    sequence) shard: ``seq`` a tree of activations (B,S,...) on the first
    one's batch and sequence shards (``seq_placements``; ``seq_shards``
    of it > 1), ``offset`` the position of its shard's first row;
    ``gathered`` a tree of activations with their batch shards kept and
    every other dim gathered (their gradients pending sums over the
    sequence shards, reduce-scattered by the backward of the gather);
    ``params`` replicated in, each weight's gradient a pending sum over
    every shard.  ``outs`` as ``on_batch_shards``'s, "seq" the
    placements of the first activation and "batch" those of a gathered
    one."""
    from torch.utils._pytree import tree_flatten
    x = tree_flatten(seq)[0][0]
    sp = seq_placements(x)
    off = seq_offset(x.device_mesh, sp, x.shape[1])
    bp = batch_placements(x)
    return _on_shards(lambda a, g, p: fn(a, g, p, off),
                      [(seq, sp), (gathered, bp)], params, outs,
                      {"seq": sp, "batch": bp})


def cache_chunk_dims(c) -> list:
    """The mesh dims that shard a decode cache leaf ``c`` (B,S,...) on
    its slots (dim 1), where a decode step leaves it ([] when none, or
    when the slots would not split evenly)."""
    dims = [i for i, p in enumerate(c.placements) if p.is_shard(1)]
    n = 1
    for i in dims:
        n *= c.device_mesh.size(i)
    return dims if dims and c.shape[1] % n == 0 else []


def on_cache_chunks(fn, batched, chunked, dims, params, outs):
    """``fn(batched, chunked, params, offset)`` on each rank's batch
    shard (``batched`` as ``on_batch_shards`` takes it) and its chunk of
    ``chunked``, a tree of cache leaves (B,S,...) with the batch shards
    of the first activation and their slots (dim 1) sharded over mesh
    dims ``dims`` (``cache_chunk_dims``; the activations replicated
    there), ``offset`` the chunk's first slot.  ``outs``: "batch" (as
    the first activation), "chunk" (as a cache leaf), "sum" or
    "mean"."""
    from torch.distributed.tensor import Shard
    from torch.utils._pytree import tree_flatten
    x = tree_flatten(batched)[0][0]
    bp = batch_placements(x)
    cp = tuple(Shard(1) if i in dims else p for i, p in enumerate(bp))
    c = tree_flatten(chunked)[0][0]
    off = seq_offset(c.device_mesh, cp, c.shape[1])
    return _on_shards(lambda a, ch, p: fn(a, ch, p, off),
                      [(batched, bp), (chunked, cp)], params, outs,
                      {"batch": bp, "chunk": cp})


def chunk_combine(mesh, dims):
    """-> ``combine(num, mx, den)``: the float32 attention output over
    every rank's chunk of a sequence split over mesh dims ``dims``, from
    this rank's chunk stats (``models/attention.decode_attend_chunk``):
    the reference's ``combine_decode``, as an all-reduce of the max over
    each of ``dims``, then one of the rescaled numerator and denominator
    together (functional collectives: inside a region, on local
    tensors)."""
    from torch.distributed import _functional_collectives as fc

    def combine(num, mx, den):
        m = mx
        for d in dims:
            m = fc.all_reduce(m, "max", (mesh, d))
        c = torch.exp(mx - m)
        nd = torch.cat([num.float() * c[..., None], (den * c)[..., None]],
                       dim=-1)
        for d in dims:
            nd = fc.all_reduce(nd, "sum", (mesh, d))
        return nd[..., :-1] / torch.clamp(nd[..., -1:], min=1e-37)
    return combine


def on_row_shards(fn, x, params, *, gather_last: bool = True):
    """``fn(x, params)`` -> one tensor with x's leading dims, on each
    rank's shard of x's leading dims (its last dim gathered unless
    ``gather_last`` is False: token ids, whose every dim is a row), with
    ``params`` gathered (each gradient a pending sum over x's shards): a
    sharded activation's product with sharded weights, FSDP-style, which
    never flattens two dims sharded over different mesh dims."""
    rp = row_placements(x, gather_last)
    return _on_shards(fn, [(x, rp)], params, ["batch"], {"batch": rp})


def on_row_sums(fn, rows, n_out: int):
    """``fn(rows, ())`` -> ``n_out`` sums over rows, on each rank's shard
    of the leading dims of ``rows`` (a tuple of activations with the same
    leading dims, the first one's last dim gathered): each a pending sum
    over the row shards.  A reduction to a scalar stays on the shards
    (a loss's backward builds no global-shape gradient on a rank)."""
    return _on_shards(fn, [(rows, row_placements(rows[0]))], (),
                      ["sum"] * n_out, {})


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


def _grads_of(pl, bp) -> tuple:
    """The placements of the gradient of an activation taken on ``pl``
    into a region over ``bp``: a pending sum over the mesh dims that
    split the region's work (``bp`` shards them) but not the activation
    (``pl`` replicates them), ``pl`` elsewhere."""
    from torch.distributed.tensor import Partial
    return tuple(Partial("sum") if b.is_shard() and not p.is_shard() else p
                 for p, b in zip(pl, bp))


#: the placements of the gradients of a region's activations
#: (``_grads_of``); a fault check replaces it
act_grads = _grads_of


def _on_shards(fn, groups, params, outs, kinds):
    """``fn(*trees, params)`` on each rank's local shards, ``groups`` a
    list of (tree of activations, their placements), the first group's
    placements those of the region's work; ``kinds`` maps an output kind
    of ``outs`` to its placements ("mean" and "sum" are pending sums; a
    "mean" is weighted by the shard's share of the first activation)."""
    from torch.distributed.tensor import Replicate
    from torch.utils._pytree import tree_flatten, tree_unflatten
    flat_groups = [tree_flatten(tree) for tree, _ in groups]
    leaves, p_spec = tree_flatten(params)
    bp = groups[0][1]
    rep = tuple(Replicate() for _ in bp)
    psum = pending_sum(bp)
    total = flat_groups[0][0][0].numel()
    out_spec = []

    def local(*flat):
        trees, i = [], 0
        for acts, spec in flat_groups:
            trees.append(tree_unflatten(list(flat[i:i + len(acts)]), spec))
            i += len(acts)
        out, ospec = tree_flatten(fn(*trees,
                                     tree_unflatten(list(flat[i:]), p_spec)))
        out_spec.append(ospec)
        share = flat[0].numel() / total
        out = [o * share if kind == "mean" else o
               for o, kind in zip(out, outs)]
        return tuple(out) if len(out) > 1 else out[0]

    tensor = [isinstance(t, torch.Tensor) for t in leaves]
    acts = [a for a_flat, _ in flat_groups for a in a_flat]
    ins = tuple(pl for (a_flat, _), (_, pl) in zip(flat_groups, groups)
                for _ in a_flat)
    grads = tuple(act_grads(pl, bp) for pl in ins)
    ins += tuple(rep if t else None for t in tensor)
    grads += tuple(weight_grads(bp) if t else None for t in tensor)
    res = on_local_shards(local, (*acts, *leaves), ins,
                          [kinds.get(kind, psum) for kind in outs], grads)
    return tree_unflatten(list(res) if len(outs) > 1 else [res],
                          out_spec[0])
