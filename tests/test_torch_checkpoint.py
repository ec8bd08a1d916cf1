"""The port's checkpoint manager (``repro_torch.checkpoint``) on the CPU:
the reference's own tests (``test_checkpoint.py``) over torch states,
then checkpoints across the two packages both ways — the same ``a/b/c``
npz keys, a reference checkpoint restoring into a torch template and a
port checkpoint into a JAX one, bfloat16 leaves bit for bit."""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import load_pytree as ref_load
from repro.checkpoint import save_pytree as ref_save
from repro_torch.checkpoint import (CheckpointManager, load_pytree,
                                    save_pytree)


def _state(seed):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "groups": [{"0": torch.arange(6.0)}]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _ref_state(seed):
    k = jax.random.key(seed)
    return {"params": {"w": jax.random.normal(k, (4, 8)),
                       "groups": [{"0": jnp.arange(6.0)}],
                       "h": jnp.linspace(-3, 3, 5).astype(jnp.bfloat16)},
            "opt": {"step": jnp.int32(7)}}


def _zeros(state):
    if isinstance(state, dict):
        return {k: _zeros(v) for k, v in state.items()}
    if isinstance(state, list):
        return [_zeros(v) for v in state]
    return torch.zeros_like(state)


def _flat(state, prefix=""):
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(state, list):
        out = {}
        for i, v in enumerate(state):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: state}


# ------------------------------ the reference's test_checkpoint.py, ported
def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    st = _state(0)
    mgr.save(10, st, {"loss": 1.5})
    got, meta = mgr.restore(_zeros(st))
    assert meta["step"] == 10 and meta["loss"] == 1.5
    for key, a in _flat(st).items():
        b = _flat(got)[key]
        assert b.dtype == a.dtype and torch.equal(a, b)


def test_latest_and_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    for s in (1, 5, 9):
        mgr.save(s, _state(s))
    assert mgr.latest_step() == 9
    assert mgr.all_steps() == [5, 9]          # step 1 collected


def test_async_write_then_restore(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=True)
    st = _state(3)
    mgr.save(2, st)
    want = st["params"]["w"].clone()
    st["params"]["w"].add_(1.0)       # training goes on mutating the state
    mgr.wait()
    got, meta = mgr.restore(_zeros(st))
    assert meta["step"] == 2
    assert torch.equal(got["params"]["w"], want)


def test_incomplete_tmp_dir_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(4, _state(1))
    (pathlib.Path(tmp_path) / ".tmp-9").mkdir()      # simulated crash
    (pathlib.Path(tmp_path) / "step_00000009").mkdir()  # no state.npz
    assert mgr.latest_step() == 4


def test_shape_mismatch_rejected(tmp_path):
    p = pathlib.Path(tmp_path) / "x.npz"
    save_pytree({"w": torch.zeros((2, 2))}, p)
    with pytest.raises(ValueError):
        load_pytree({"w": torch.zeros((3, 3))}, p)
    with pytest.raises(KeyError):
        load_pytree({"v": torch.zeros((2, 2))}, p)


# --------------------------------------------------- across the packages
def test_restore_takes_the_template_dtype_and_device(tmp_path):
    p = tmp_path / "x.npz"
    save_pytree({"a": torch.arange(4.0), "b": (np.int64(3), None)}, p)
    got = load_pytree({"a": torch.zeros(4, dtype=torch.float64),
                       "b": (torch.zeros((), dtype=torch.int32), None)}, p)
    assert got["a"].dtype == torch.float64 and got["a"].device.type == "cpu"
    assert got["b"][0].dtype == torch.int32 and int(got["b"][0]) == 3
    assert got["b"][1] is None and isinstance(got["b"], tuple)


def test_reference_checkpoint_loads_in_port(tmp_path):
    st = _ref_state(0)
    RefManager(tmp_path, async_write=False).save(3, st, {"loss": 0.5})
    template = {"params": {"w": torch.zeros((4, 8)),
                           "groups": [{"0": torch.zeros(6)}],
                           "h": torch.zeros(5, dtype=torch.bfloat16)},
                "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    got, meta = CheckpointManager(tmp_path).restore(template)
    assert meta == {"step": 3, "loss": 0.5}
    want = jax.tree.map(np.asarray, st)
    np.testing.assert_array_equal(got["params"]["w"].numpy(),
                                  want["params"]["w"])
    np.testing.assert_array_equal(got["params"]["groups"][0]["0"].numpy(),
                                  want["params"]["groups"][0]["0"])
    assert got["params"]["h"].dtype == torch.bfloat16
    assert got["params"]["h"].view(torch.int16).numpy().tolist() == \
        want["params"]["h"].view(np.int16).tolist()
    assert int(got["opt"]["step"]) == 7


def test_port_checkpoint_loads_in_reference(tmp_path):
    st = _state(4)
    st["params"]["h"] = torch.linspace(-3, 3, 5).to(torch.bfloat16)
    CheckpointManager(tmp_path, async_write=False).save(8, st)
    template = jax.tree.map(np.zeros_like, _ref_state(0))
    del template["params"]["h"]      # the reference reads no |V2 leaf back
    got, meta = RefManager(tmp_path).restore(template)
    assert meta == {"step": 8}
    np.testing.assert_array_equal(np.asarray(got["params"]["w"]),
                                  st["params"]["w"].numpy())
    assert int(got["opt"]["step"]) == 7
    # the same npz keys and bytes as the reference writes for that state
    ref_save({"params": {"h": jnp.asarray(
        st["params"]["h"].float().numpy()).astype(jnp.bfloat16)}},
        tmp_path / "ref.npz")
    save_pytree({"params": {"h": st["params"]["h"]}}, tmp_path / "port.npz")
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert a.files == b.files == ["params/h"]
        assert a["params/h"].dtype == b["params/h"].dtype
        assert a["params/h"].tobytes() == b["params/h"].tobytes()
    # and the port reads its own bfloat16 leaf back bit for bit
    got = load_pytree({"params": {"h": torch.zeros(5, dtype=torch.bfloat16)}},
                      tmp_path / "port.npz")
    assert torch.equal(got["params"]["h"], st["params"]["h"])


def test_keys_match_reference_flattening(tmp_path):
    """The same nest gives the same npz keys in both packages (sorted dict
    keys, list indices)."""
    nest = {"b": [{"z": 1.0, "a": 2.0}, 3.0], "a": {"0": 4.0}}
    ref_save(jax.tree.map(np.float32, nest), tmp_path / "ref.npz")
    save_pytree(jax.tree.map(lambda v: torch.tensor(v), nest),
                tmp_path / "port.npz")
    with np.load(tmp_path / "ref.npz") as a, \
            np.load(tmp_path / "port.npz") as b:
        assert sorted(a.files) == sorted(b.files) == \
            ["a/0", "b/0/a", "b/0/z", "b/1"]
        for k in a.files:
            assert a[k] == b[k]
    assert ref_load(jax.tree.map(np.float32, nest), tmp_path / "port.npz")
