"""Initial parameters from ``--seed``, made on the device.

A reference family lists its parameters (``reference.<family>.leaves``):
path, shape and initial distribution.  The parameters of one trial are
drawn group by group (the leaves up to a layer's index, or the leaves of
one dict outside the layers: the embedding, a final norm), one
``torch.randn`` a group from a generator seeded by (seed, trial, group),
so that any group of any trial can be drawn again alone: the program's
state is filled from the same draws that the reference, and the check of
the parameters' change, read later.
"""
from __future__ import annotations

import hashlib
import math
from typing import Dict, Iterator, List, Sequence, Tuple

import torch


def derive(*parts) -> int:
    """A 63-bit generator seed from any parts (the run's seed first)."""
    digest = hashlib.sha256(repr(parts).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def group_of(path: Tuple) -> Tuple:
    """The leaves a path shares its draw with: up to its first integer
    index, else its parent dict."""
    for i, key in enumerate(path):
        if isinstance(key, int):
            return path[: i + 1]
    return path[:-1]


def groups(leaves: Sequence) -> List[Tuple[Tuple, List[int]]]:
    """(group, indices of its leaves) in the order of first appearance."""
    out: Dict[Tuple, List[int]] = {}
    for i, leaf in enumerate(leaves):
        out.setdefault(group_of(leaf[0]), []).append(i)
    return list(out.items())


def draw(leaves: Sequence, seed: int, trial: int, device,
         only: Sequence[Tuple] = None) -> Iterator[Tuple[int, torch.Tensor]]:
    """(leaf index, its float32 initial value) for every leaf of one
    trial, group by group (only the groups in ``only`` when given)."""
    for group, idx in groups(leaves):
        if only is not None and group not in only:
            continue
        normal = [i for i in idx if leaves[i][2][0] == "normal"]
        n = sum(math.prod(leaves[i][1]) for i in normal)
        flat = None
        if n:
            gen = torch.Generator(device=device)
            gen.manual_seed(derive(seed, trial, group))
            flat = torch.randn(n, generator=gen, device=device,
                               dtype=torch.float32)
        off = 0
        for i in idx:
            _, shape, (kind, std) = leaves[i]
            if kind == "normal":
                size = math.prod(shape)
                yield i, flat[off: off + size].view(shape).mul_(std)
                off += size
            elif kind == "ones":
                yield i, torch.ones(shape, device=device)
            elif kind == "zeros":
                yield i, torch.zeros(shape, device=device)
            else:
                raise ValueError(f"unknown initial distribution {kind!r}")
        del flat


def trial(leaves: Sequence, seed: int, trial_index: int, device
          ) -> List[torch.Tensor]:
    """Every leaf's initial value for one trial, in ``leaves``' order."""
    out = [None] * len(leaves)
    for i, value in draw(leaves, seed, trial_index, device):
        out[i] = value
    return out


def stacked(leaves: Sequence, seed: int, trials: int, device
            ) -> List[torch.Tensor]:
    """Every leaf as a (trials, *shape) float32 tensor on ``device``,
    trial i's slice drawn as ``trial(..., i, ...)`` draws it."""
    out = [torch.empty((trials,) + tuple(leaf[1]), device=device,
                       dtype=torch.float32) for leaf in leaves]
    for t in range(trials):
        for i, value in draw(leaves, seed, t, device):
            out[i][t].copy_(value)
    return out
