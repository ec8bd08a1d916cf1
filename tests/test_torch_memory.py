"""The tracker of live storage bytes (``repro_torch.distributed.memory``)
on the CPU, at small sizes.

* a hand-counted function: ``y = x + 1; z = y * 2; del y; w = z.exp()``
  peaks at three tensors of x's size, outputs one and aliases none, on
  CPU and meta tensors;
* views and in-place ops allocate nothing, and what they return aliases
  the argument;
* a 2-layer narrow LM train step (xlstm's mLSTM and sLSTM, no kernel, so
  the CPU and meta tensors run the same ops), with and without remat:
  the same peak, output and alias bytes on meta tensors as on real CPU
  tensors;
* sharding: a fake world of 4 on a (2, 2) mesh with every leaf sharded
  registers argument bytes equal to ``sharded_bytes``, and peaks at or
  above them and below the same step's peak at world size 1;
* a train step's peak is above its forward's;
* ``peak = argument + output - alias + temp`` wherever temp > 0.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.registry import concrete_inputs, input_specs
from repro_torch.distributed import memory as M
from repro_torch.launch import steps as S
from repro_torch.models.common import ShapeSpec
from repro_torch.optim import AdamWConfig

SHAPE = ShapeSpec("t", 32, 4, "train")


def _identity(r: dict) -> None:
    assert set(r) == set(M.KEYS)
    assert r["peak_memory_in_bytes"] >= r["argument_size_in_bytes"]
    if r["temp_size_in_bytes"] > 0:
        assert r["peak_memory_in_bytes"] == (
            r["argument_size_in_bytes"] + r["output_size_in_bytes"]
            - r["alias_size_in_bytes"] + r["temp_size_in_bytes"])


def _three(x):
    y = x + 1
    z = y * 2
    del y
    w = z.exp()
    return w


def _in_place(x):
    v = x.view(10, -1)
    v.add_(1)
    x.mul_(2)
    return x.t()[:5]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_hand_counted_function(device):
    x = torch.ones(1000, device=device)
    r = M.analyze(_three, x)
    n = x.nbytes
    assert r["argument_size_in_bytes"] == n
    assert r["peak_memory_in_bytes"] == 3 * n
    assert r["output_size_in_bytes"] == n and r["alias_size_in_bytes"] == 0
    assert r["temp_size_in_bytes"] == n
    _identity(r)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_views_and_in_place_ops_allocate_nothing(device):
    x = torch.ones(1000, device=device)
    r = M.analyze(_in_place, x)
    assert r["peak_memory_in_bytes"] == x.nbytes
    assert r["output_size_in_bytes"] == r["alias_size_in_bytes"] == x.nbytes
    assert r["temp_size_in_bytes"] == 0
    _identity(r)


def test_freed_storage_leaves_the_live_count():
    """Five temporaries one after another peak at one of them."""
    x = torch.ones(1000)
    with M.tracking(x) as t:
        for _ in range(5):
            y = x * 2
            del y
    assert t.result()["peak_memory_in_bytes"] == 2 * x.nbytes


def test_storage_freed_on_other_threads_leaves_the_live_count():
    """Storages made under the tracker and dropped by 16 other threads at
    once (as a CUDA backward frees on autograd's device thread): each
    death is counted once, so the live bytes come back to the
    arguments."""
    import queue
    import sys
    import threading
    x = torch.ones(256)
    inbox: queue.Queue = queue.Queue()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with M.tracking(x) as t:
            def drop():
                while (item := inbox.get()) is not None:
                    del item
            threads = [threading.Thread(target=drop) for _ in range(16)]
            for th in threads:
                th.start()
            for _ in range(2000):
                inbox.put(x * 2)
            for _ in threads:
                inbox.put(None)
            for th in threads:
                th.join(30.0)
            assert not any(th.is_alive() for th in threads)
            y = x + 1
        assert t.result()["peak_memory_in_bytes"] >= 2 * x.nbytes
        with t._lock:
            t._reap()
            assert t.live == 2 * x.nbytes
        del y
    finally:
        sys.setswitchinterval(switch)


def _lm_cfg(remat: str):
    cfg = get_config("xlstm-125m").reduced()
    return dataclasses.replace(cfg, n_layers=2, remat=remat,
                               block_pattern=("mlstm", "slstm"))


def _meta_batch(cfg, shape):
    """``concrete_inputs``' batch as meta tensors."""
    return {k: torch.empty(dims, device="meta", dtype=dtype)
            for k, (dims, dtype) in input_specs(cfg, shape).items()}


def _train_memory(cfg, device: str) -> dict:
    state = S.init_train_state(cfg, 0, device)
    batch = (_meta_batch(cfg, SHAPE) if device == "meta"
             else concrete_inputs(cfg, SHAPE, 0, device=device))
    _, step = S.make_train_step(cfg, AdamWConfig())
    with M.tracking(state, live=batch) as t:
        t.add_outputs(step(state, batch))
    return t.result()


@pytest.mark.parametrize("remat", ["none", "full"])
def test_meta_step_holds_what_the_cpu_step_holds(remat):
    cfg = _lm_cfg(remat)
    meta = _train_memory(cfg, "meta")
    cpu = _train_memory(cfg, "cpu")
    assert meta == cpu
    shapes = S.train_state_shapes(cfg)
    state_bytes = sum(t.nbytes for t in
                      torch.utils._pytree.tree_leaves(shapes))
    # AdamW writes the parameters and moments in place, so the outputs
    # alias all of the state but the step count; they add the new count
    # and the metrics
    assert meta["argument_size_in_bytes"] == state_bytes
    assert meta["alias_size_in_bytes"] == \
        state_bytes - shapes["opt"]["step"].nbytes
    assert meta["output_size_in_bytes"] > state_bytes
    assert meta["temp_size_in_bytes"] > 0
    _identity(meta)


def test_remat_lowers_the_peak():
    assert (_train_memory(_lm_cfg("full"), "meta")["peak_memory_in_bytes"]
            < _train_memory(_lm_cfg("none"), "meta")["peak_memory_in_bytes"])


def test_train_step_peaks_above_its_forward():
    cfg = _lm_cfg("none")
    state = S.init_train_state(cfg, 0, "meta")
    batch = _meta_batch(cfg, SHAPE)
    model, step = S.make_train_step(cfg, AdamWConfig())

    def forward(state, batch):
        with torch.no_grad():
            params = S.cast_params(state["params"], cfg.compute_dtype)
            return model.loss(params, batch)[0]
    fwd = M.analyze(forward, state, batch)
    train = M.analyze(step, state, batch)
    assert train["peak_memory_in_bytes"] > fwd["peak_memory_in_bytes"]
    assert fwd["alias_size_in_bytes"] == 0
    _identity(fwd)
    _identity(train)


def _sharded_memory(cfg, world: int, mesh_shape) -> tuple:
    """One train step on a fake group of ``world`` ranks over meta
    tensors, every leaf sharded -> (memory, sharded_bytes of the state)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.distributed.act_sharding import activation_sharding
    from repro_torch.distributed.auto_shard import (Spec, shard_tree,
                                                    sharded_bytes)
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    with fake_world(world):
        mesh = make_local_mesh(mesh_shape, device_type="cpu")
        shapes = S.train_state_shapes(cfg)
        specs = S.state_specs(cfg, mesh, shapes, min_elems=0)
        b_specs = S.batch_specs(cfg, SHAPE, mesh, input_specs(cfg, SHAPE))
        state = shard_tree(shapes, mesh, specs)
        batch = shard_tree(_meta_batch(cfg, SHAPE), mesh, b_specs)
        _, step = S.make_train_step(cfg, AdamWConfig(),
                                    grad_specs=specs["params"])
        tok = b_specs["tokens"]
        with implicit_replication(), \
                activation_sharding(Spec(tok[0], tok[1])):
            with M.tracking(state, live=batch) as t:
                t.add_outputs(step(state, batch))
        return t.result(), sharded_bytes(shapes, specs, mesh)


def test_sharded_step_counts_local_shards():
    cfg = get_config("recurrentgemma-2b").reduced()
    four, want = _sharded_memory(cfg, 4, (2, 2))
    one, whole = _sharded_memory(cfg, 1, (1, 1))
    assert four["argument_size_in_bytes"] == want < whole
    assert one["argument_size_in_bytes"] == whole
    assert four["peak_memory_in_bytes"] >= want
    assert four["peak_memory_in_bytes"] < one["peak_memory_in_bytes"]
    _identity(four)
    _identity(one)


def test_sharded_loss_holds_no_global_logits():
    """A sharded step's cross entropy on 8 ranks' rows of the logits:
    its backward holds less than the global logits (on the DTensor
    itself, ``take_along_dim``'s backward built their whole gradient on
    every rank)."""
    from torch.distributed.tensor import DTensor, Shard
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.model import cross_entropy
    B, S_, V = 16, 8, 4096
    with fake_world(8):
        mesh = make_local_mesh((2, 4), device_type="cpu")
        rows = [Shard(0), Shard(0)]
        local = torch.empty(B // 8, S_, V, device="meta", requires_grad=True)
        logits = DTensor.from_local(local, mesh, rows, run_check=False)
        labels = DTensor.from_local(
            torch.empty(B // 8, S_, dtype=torch.long, device="meta"), mesh,
            rows, run_check=False)
        with M.tracking(local, live=labels) as t:
            loss = cross_entropy(logits, labels)
            (grad,) = torch.autograd.grad(loss, [local])
            t.add_outputs(grad)
        r = t.result()
    assert grad.shape == local.shape
    assert r["peak_memory_in_bytes"] < B * S_ * V * 4
    _identity(r)

