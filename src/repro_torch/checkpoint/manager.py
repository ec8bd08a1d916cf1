"""Sharded npz checkpoints with async writes and atomic step directories.

Fault-tolerance contract (trial-level):
* a checkpoint directory becomes visible only after a complete atomic
  rename, so a crash mid-write can never produce a half checkpoint;
* ``latest_step`` scans for the newest complete step — restart just works;
* writes happen on a background thread (training never blocks on disk);
* ``keep`` bounds disk usage (old steps garbage-collected).

A state is a nest of dicts, lists and tuples whose leaves are tensors,
numpy arrays or Python numbers (``None`` holds no leaf).  It is flattened
to ``a/b/c`` keys — dict keys and sequence indices, the names the JAX
package's key paths give — and stored as one npz per host shard (one
shard here), one numpy array a leaf.  So a checkpoint the JAX package
wrote loads here, and one written here loads there.

numpy has no bfloat16 of its own: the JAX package's npz holds a bfloat16
leaf as raw 2-byte values (``|V2``), and the port writes its bfloat16
tensors the same way and reads such a leaf back bit for bit.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _leaves(tree, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) in the JAX package's flattening order: dict keys
    sorted, sequences by index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _rebuild(tree, fn: Callable[[str, Any], Any],
             prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``fn(key, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, fn, prefix + (str(i),))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn("/".join(prefix), tree)


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array of its own (a copy: the caller may go on
    mutating the tensor); bfloat16 as raw 2-byte values."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().copy().view("V2")
        return t.numpy().copy()
    return np.array(leaf)


def _like(arr: np.ndarray, leaf):
    """``arr`` in ``leaf``'s kind: a tensor of its dtype on its device, or
    a numpy array of its dtype."""
    if isinstance(leaf, torch.Tensor):
        if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {key: _host(leaf) for key, leaf in _leaves(tree)}


def save_pytree(tree, path: pathlib.Path) -> None:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(tree))


def load_pytree(template, path: pathlib.Path):
    """Restore into the structure of ``template`` (shape checked; each
    leaf in the template leaf's dtype, and on its device for a tensor)."""
    with np.load(path, allow_pickle=False) as data:
        def leaf(key, like):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(np.shape(like)):
                raise ValueError(f"shape mismatch at {key}: "
                                 f"{arr.shape} vs {tuple(np.shape(like))}")
            return _like(arr, like)
        return _rebuild(template, leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_write: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._pending: Optional[threading.Thread] = None

    # ------------------------------------------------------------- write
    def save(self, step: int, state, metadata: Optional[Dict] = None) -> None:
        self.wait()  # one in-flight write at a time
        # device->host copy happens NOW so training can mutate state after
        host_state = _flatten(state)

        def write():
            tmp = self.dir / f".tmp-{step}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "state.npz", **host_state)
            (tmp / "meta.json").write_text(json.dumps(
                {"step": step, **(metadata or {})}))
            final = self.dir / f"step_{step:08d}"
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)            # atomic visibility
            self._gc()

        if self.async_write:
            self._pending = threading.Thread(target=write, daemon=True)
            self._pending.start()
        else:
            write()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ------------------------------------------------------------- read
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            m = re.fullmatch(r"step_(\d+)", p.name)
            if m and (p / "state.npz").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None
                ) -> Tuple[Any, Dict]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        state = load_pytree(template, d / "state.npz")
        meta = json.loads((d / "meta.json").read_text())
        return state, meta
