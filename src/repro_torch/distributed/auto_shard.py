"""Greedy divisibility-aware sharding rules of the port.

The port's copy of the reference's ``distributed/auto_shard.py``.  The
architectures' head counts (40, 96, 10, 24, ...) and vocabularies (49155,
51865, ...) do not all divide a fixed 16x16 mesh, so mesh axes go to
tensor dims greedily, largest axis to the largest dim still divisible by
it: every parameter whose dims allow it is sharded on every axis, and the
rest degrade gracefully (granite's 49155-row embedding shards only its
d_model dim).

``auto_spec``, ``tree_specs``, ``batch_seq_spec`` and ``sharded_bytes``
are pure functions of a mesh's ``{axis: size}`` shape and axis order: they
take a ``torch.distributed.device_mesh.DeviceMesh`` (its
``mesh_dim_names`` and ``shape``), anything with the reference's
``shape`` dict and ``axis_names``, or the dict itself, and touch no
device and no process group.  A ``Spec`` has one entry a tensor dim, ``None`` or a tuple of
axis names, and compares entry for entry with the reference's
``PartitionSpec``.  ``placements`` turns a spec into DTensor placements
(``Shard`` / ``Replicate``, one a mesh dim) and ``shard_tree`` into
distributed tensors.

Stacked versus unstacked layers.  The reference stacks each layer group's
parameters under ``"groups"`` with a leading ``repeats`` dim, which its
``skip_leading`` leaves unsharded, and judges ``min_elems`` on the stacked
leaf.  The port keeps one flat list of layers (``models/convert.py``), so
``auto_spec(..., repeats=r)`` judges a layer's leaf as one of the ``r``
stacked copies the reference sees and returns the spec of the layer's own
dims; ``tree_specs(tree, mesh, cfg)`` gives each layer its group's
repeats (``layer_repeats``).  The encoder's layers, stacked by the
reference under a key that is not ``"groups"``, keep their leading dim in
play there: a spec that would shard that dim has no counterpart on an
unstacked layer and raises.

Two axes on one dim.  A spec entry lists its axes major to minor, in the
order ``auto_spec`` assigned them (largest axis first), while DTensor's
``Shard`` splits a dim that several mesh dims shard in mesh-dim order.
On 16x16 the stable sort keeps ``data`` before ``model`` and the two
agree; on 2x16x16 ``pod`` (the smallest axis) comes last in an entry but
first in the mesh, in hundreds of leaves of every architecture.
``placements`` raises there unless asked to ``reorder``: then it shards
in mesh order, which gives each rank a shard of the same size (the same
bytes, the same collectives) holding other rows than the reference's
layout gives it.  ``count_reordered`` counts such leaves, and the dry run
records the count.  (DTensor's ``_StridedShard`` keeps the reference's
layout exactly, but its redistribution planner searches for minutes per
op on a 3-D mesh.)
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch

MIN_SHARD_ELEMS = 1 << 20   # replicate leaves below ~1M elements: sharding
                            # them buys nothing and seeds per-iteration
                            # gathers inside recurrent loops


class Spec(tuple):
    """A sharding spec: one entry a tensor dim, ``None`` (replicated) or
    a tuple of mesh axis names (sharded over them, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


def mesh_axes(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order, of a ``DeviceMesh``, of an object
    with the reference's ``shape`` dict and ``axis_names``, or of such a
    dict itself."""
    if isinstance(mesh, dict):
        return dict(mesh)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {n: mesh.shape[n] for n in mesh.axis_names}


def auto_spec(shape: Sequence[int], mesh, *, skip_leading: bool = False,
              min_elems: int = MIN_SHARD_ELEMS,
              repeats: Optional[int] = None) -> Spec:
    """Greedy spec: each mesh axis (largest first) goes to the largest
    tensor dim still divisible by it; small leaves are replicated.  With
    ``repeats`` the leaf is one layer of a stack of that many, judged as
    the reference judges the stacked leaf (its leading dim skipped when
    ``skip_leading``); the spec of the layer's own dims comes back."""
    shape = tuple(shape)
    if repeats is not None:
        full = auto_spec((repeats,) + shape, mesh, skip_leading=skip_leading,
                         min_elems=min_elems)
        if full[0] is not None:
            raise ValueError(
                f"a stack of {repeats} x {shape} shards its layer dim over "
                f"{full[0]}: an unstacked layer has no such dim")
        return Spec(*full[1:])
    if math.prod(shape) < min_elems:
        return Spec(*([None] * len(shape)))
    assign: List[List[str]] = [[] for _ in shape]
    sizes = list(shape)
    start = 1 if (skip_leading and len(shape) > 1) else 0
    axes = sorted(mesh_axes(mesh).items(), key=lambda kv: -kv[1])
    for name, n in axes:
        if n == 1:
            continue
        best = -1
        for i in range(start, len(shape)):
            if sizes[i] % n == 0 and sizes[i] >= n:
                if best < 0 or sizes[i] > sizes[best]:
                    best = i
        if best >= 0:
            assign[best].append(name)
            sizes[best] //= n
    return Spec(*[tuple(a) if a else None for a in assign])


def layer_repeats(cfg) -> List[int]:
    """The repeats of the reference's layer group each of the port's
    layers belongs to, in stack order (``model.model_groups``)."""
    from repro_torch.models.model import model_groups  # lazy, avoids cycle
    return [reps for pattern, reps in model_groups(cfg)
            for _ in range(reps) for _ in pattern]


def _map(fn: Callable, tree, is_leaf: Callable[[Any], bool]):
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v, is_leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, is_leaf) for v in tree)
    return fn(tree)


def _leaves(tree, is_leaf: Callable[[Any], bool]) -> Iterator[Any]:
    if is_leaf(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v, is_leaf)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v, is_leaf)
    else:
        yield tree


def _is_spec(x) -> bool:
    return isinstance(x, Spec)


def _is_shape(x) -> bool:
    return isinstance(x, torch.Tensor)


def tree_specs(tree: Any, mesh, cfg=None, *,
               min_elems: int = MIN_SHARD_ELEMS) -> Any:
    """Spec tree for a parameter tree of tensors (meta tensors will do).
    With ``cfg`` each of ``tree["layers"]`` is judged as one of its
    group's stacked repeats, leading dim skipped, and each of
    ``tree["encoder"]["layers"]`` as one of ``encoder_layers`` stacked
    copies, leading dim in play (the reference's keys); without it, and
    everywhere else, a leaf is judged alone."""
    leaf = lambda t, **kw: auto_spec(  # noqa: E731
        t.shape, mesh, min_elems=min_elems, **kw)
    if cfg is None or not isinstance(tree, dict):
        return _map(leaf, tree, _is_shape)
    out = {k: _map(leaf, v, _is_shape) for k, v in tree.items()}
    if "layers" in tree:
        out["layers"] = [
            _map(lambda t, r=r: leaf(t, skip_leading=True, repeats=r), lp,
                 _is_shape)
            for lp, r in zip(tree["layers"], layer_repeats(cfg))]
    if "encoder" in tree:
        n = cfg.encoder_layers
        out["encoder"] = dict(out["encoder"], layers=[
            _map(lambda t: leaf(t, repeats=n), lp, _is_shape)
            for lp in tree["encoder"]["layers"]])
    return out


def batch_seq_spec(mesh, batch: int, seq: Optional[int]) -> Spec:
    """Sharding for (batch, seq, ...) activations: batch over leading mesh
    axes while divisible, the remaining axes over seq (sequence
    parallelism)."""
    baxes, saxes = [], []
    b, s = batch, seq
    for name, n in mesh_axes(mesh).items():
        if n == 1:
            continue
        if not saxes and b % n == 0 and b >= n:
            b //= n
            baxes.append(name)
        elif s is not None and s % n == 0 and s >= n:
            s //= n
            saxes.append(name)
    if seq is None:
        return Spec(tuple(baxes) if baxes else None)
    return Spec(tuple(baxes) if baxes else None,
                tuple(saxes) if saxes else None)


def placements(spec: Sequence, mesh, *, reorder: bool = False) -> list:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` on the mesh dim of each axis that entry d names,
    ``Replicate()`` on the rest.  An entry whose axes are not in the
    mesh's order raises, unless ``reorder`` (see the module)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        entry = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in entry]
        if idx != sorted(idx) and not reorder:
            raise ValueError(
                f"spec entry {entry} for dim {d} is not in the mesh's axis "
                f"order {tuple(names)}: DTensor would lay that dim out "
                "otherwise (pass reorder=True to accept its order)")
        for i in idx:
            out[i] = Shard(d)
    return out


def count_reordered(specs: Any, mesh) -> int:
    """Leaves of a spec tree with an entry against the mesh's axis order
    (which ``placements`` shards in mesh order only when asked to)."""
    names = list(mesh_axes(mesh))
    n = 0
    for spec in _leaves(specs, _is_spec):
        for entry in spec:
            if entry is not None and not isinstance(entry, str):
                idx = [names.index(a) for a in entry]
                if idx != sorted(idx):
                    n += 1
                    break
    return n


def shard_tree(tree: Any, mesh, specs: Any, *, reorder: bool = False):
    """Distributed tensors from a tree of tensors and its spec tree: each
    rank keeps its own shard of its own copy (no data moves between
    ranks, so every rank must hold the same tensors)."""
    from torch.distributed.tensor import distribute_tensor
    flat = iter(list(_leaves(specs, _is_spec)))
    return _map(lambda t: distribute_tensor(
        t, mesh, placements(next(flat), mesh, reorder=reorder),
        src_data_rank=None), tree, _is_shape)


def sharded_bytes(shapes: Any, specs: Any, mesh) -> int:
    """Exact per-device bytes of a tree of tensors (meta tensors will do)
    under its spec tree — the analytic 'does it fit' number of the dry
    run's record."""
    axes = mesh_axes(mesh)
    total = 0
    for t, spec in zip(_leaves(shapes, _is_shape), _leaves(specs, _is_spec)):
        dims = list(t.shape)
        for i, entry in enumerate(spec):
            if entry is None or i >= len(dims):
                continue
            names = (entry,) if isinstance(entry, str) else entry
            f = math.prod(axes[nm] for nm in names)
            dims[i] = math.ceil(dims[i] / f)
        total += math.prod(dims) * t.element_size()
    return total
