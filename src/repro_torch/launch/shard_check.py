"""Hold the sharded train step against the unsharded one on live ranks.

Each rank builds the same training state from one seed, runs ``steps``
AdamW steps of ``launch/steps.make_train_step`` sharded over a mesh of
the process group (state placed by ``state_specs``, batch by
``batch_specs``, activations anchored by ``activation_sharding``,
gradients by ``grad_specs``), and the same steps unsharded on its own;
it gathers each updated parameter and writes the largest distance from
the unsharded one, relative to the largest magnitude, with the losses
and the collectives ``CommDebugMode`` saw in the first sharded step.
``fault=True`` plants a fault: each gradient's pending sum over the
batch shards is dropped, every rank keeping its own local gradient;
``fault="gathered"`` drops the pending sum of the gradients of the
activations a region takes gathered (attention's keys and values in a
sequence-parallel step: each rank's share of dK / dV taken as the
whole).
A batch smaller than the mesh leaves mesh dims to the sequence
(``batch_seq_spec``): batch 2 on (2, 2) runs the step sequence-parallel.

``--decode`` holds the serving path instead (``decode_rank``): a
sequence-parallel prefill against the unsharded one, and decode steps
over a cache sharded on its slots (each rank attending its chunk, the
chunks combined across the ranks) against the unsharded steps, for
global attention, the local ring buffer and MLA's latent
(``DECODE_ARCHS``) in two cache layouts (``DECODE_LAYOUTS``).

  python -m repro_torch.launch.shard_check --ranks 4 --mesh 2,2 \
      --arch recurrentgemma-2b --out /tmp/shard [--batch 2] [--decode]

runs 4 gloo ranks on the CPU (the tests' and the card's 4-rank check)
and exits non-zero when a rank fails or the hold does not.
"""
from __future__ import annotations

import argparse
import datetime
import faulthandler
import json
import math
import multiprocessing as mp
import pathlib
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, Optional, Sequence

#: the reduced configs' leaves are all below the greedy rule's 1M
#: elements, so the check shards every leaf it can (min_elems 0)
MIN_ELEMS = 0
LIMIT = 1e-5
#: the split decode's architectures: global attention, the local ring
#: buffer (recurrentgemma-2b's window of 32 over a cache of 64) and MLA's
#: latent
DECODE_ARCHS = ("granite-3-8b", "recurrentgemma-2b", "deepseek-v2-lite-16b")
#: the split decode's cache layouts on a (2, 2) mesh, (batch, slots)
#: entries of each attention cache leaf: the slots over both mesh dims
#: and the batch whole (phi3-medium-14b ``decode_32k``'s layout on
#: 16x16), and the batch over "data" with the slots over "model"
DECODE_LAYOUTS = {"slots_data_model": (None, ("data", "model")),
                  "batch_data_slots_model": (("data",), ("model",))}
#: (batch, prompt, cache slots, decode steps) of the split decode
DECODE_CELL = (2, 40, 64, 3)


def local_grads(bp) -> tuple:
    """The planted fault: a region's weight gradients taken as already
    summed over the batch shards (each rank keeps its own)."""
    from torch.distributed.tensor import Replicate
    return tuple(Replicate() for _ in bp)


def local_act_grads(pl, bp) -> tuple:
    """The planted fault ``"gathered"``: the gradient of an activation a
    region takes gathered taken on its own placements, as if each rank's
    share were the sum."""
    return tuple(pl)


def local_combine(mesh, dims):
    """The split decode's planted fault: each rank's chunk of the cache
    attended alone, the chunks never combined."""
    from repro_torch.models.attention import combine_decode
    return lambda num, mx, den: combine_decode([(num, mx, den)])


def comm_counts(counts) -> Dict[str, int]:
    """``CommDebugMode``'s counts by op -> counts by the cost analyser's
    kinds (``distributed/cost.py``)."""
    kinds = {"all_reduce": "all-reduce", "all_gather_into_tensor":
             "all-gather", "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "shard_dim_alltoall": "all-to-all", "broadcast": "broadcast"}
    out: Dict[str, int] = {}
    for op, n in counts.items():
        name = getattr(op, "__name__", str(op)).split(".")[0]
        kind = kinds.get(name, name)
        out[kind] = out.get(kind, 0) + n
    return out


def sharded_run(cfg, shape, mesh, steps: int, seed: int = 0,
                fault: bool = False, device="cpu", counter=None):
    """``steps`` sharded AdamW steps from ``init_train_state(cfg, seed)``
    on ``mesh`` -> (state, losses, CommDebugMode's counts of the first
    step, the first step's cost per ``counter`` when given)."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import _dtensor
    from repro_torch.configs.registry import input_specs
    from repro_torch.distributed.act_sharding import activation_sharding
    from repro_torch.distributed.auto_shard import Spec, shard_tree
    from repro_torch.launch import steps as S
    from repro_torch.optim import AdamWConfig
    state = S.init_train_state(cfg, seed, device)
    specs = S.state_specs(cfg, mesh, S.train_state_shapes(cfg),
                          min_elems=MIN_ELEMS)
    state = shard_tree(state, mesh, specs)
    b_specs = S.batch_specs(cfg, shape, mesh, input_specs(cfg, shape))
    _, step = S.make_train_step(cfg, AdamWConfig(), grad_specs=specs["params"])
    tok = b_specs["tokens"]
    losses, comms, cost = [], None, None
    if fault == "gathered":
        _dtensor.act_grads = local_act_grads
    elif fault:
        _dtensor.weight_grads = local_grads
    try:
        for t in range(steps):
            batch = shard_tree(_batch(cfg, shape, seed + t, device),
                                 mesh, b_specs)
            with implicit_replication(), \
                    activation_sharding(Spec(tok[0], tok[1])):
                if t == 0:
                    with CommDebugMode() as comm:
                        if counter is not None:
                            with counter() as c:
                                state, m = step(state, batch)
                            cost = c.result()
                        else:
                            state, m = step(state, batch)
                    comms = comm_counts(comm.get_comm_counts())
                else:
                    state, m = step(state, batch)
            losses.append(float(m["loss"].full_tensor()))
    finally:
        _dtensor.weight_grads = _dtensor.pending_sum
        _dtensor.act_grads = _dtensor._grads_of
    return state, losses, comms, cost


def fake_cost(cfg, shape, mesh_shape, device="cpu"):
    """The cost analyser's count of the first sharded step on a fake
    process group of the same mesh (``launch/dryrun.fake_world``)."""
    from repro_torch.distributed.cost import counting
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_local_mesh
    with fake_world(math.prod(mesh_shape)):
        mesh = make_local_mesh(tuple(mesh_shape), device_type=device)
        return sharded_run(cfg, shape, mesh, 1, device=device,
                           counter=counting)[3]


def _batch(cfg, shape, seed: int, device):
    from repro_torch.configs.registry import concrete_inputs
    return concrete_inputs(cfg, shape, seed=seed, device=device)


def unsharded_run(cfg, shape, steps: int, seed: int = 0, device="cpu"):
    from repro_torch.launch import steps as S
    from repro_torch.optim import AdamWConfig
    state = S.init_train_state(cfg, seed, device)
    _, step = S.make_train_step(cfg, AdamWConfig())
    losses = []
    for t in range(steps):
        state, m = step(state, _batch(cfg, shape, seed + t, device))
        losses.append(float(m["loss"]))
    return state, losses


def hold(sharded, plain) -> float:
    """The largest |sharded - plain| over the parameters, relative to the
    largest |plain|."""
    from repro_torch.models.model import tensors
    worst, mag = 0.0, 0.0
    for a, b in zip(tensors(sharded["params"]), tensors(plain["params"])):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        worst = max(worst, float((a.double() - b.double()).abs().max()))
        mag = max(mag, float(b.double().abs().max()))
    return worst / max(mag, 1e-30)


def run_rank(rank: int, world: int, store: str, out: str, arch: str,
             mesh_shape: Sequence[int], batch: int, seq: int, steps: int,
             faults: Sequence[bool] = (False,),
             device: str = "cpu") -> None:
    """One rank of the check (module docstring): the sharded run once for
    each of ``faults`` against one unsharded run; writes a JSON list of
    records, one for each, to ``out``, and the Python stack of a fatal
    signal (a crash below Python) to ``out`` + ".fault"."""
    fault_log = open(out + ".fault", "w")
    faulthandler.enable(fault_log)
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.common import ShapeSpec
    torch.set_num_threads(1)   # 4 ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    recs: Any = []
    try:
        cfg = get_config(arch).reduced()
        shape = ShapeSpec("check", seq, batch, "train")
        mesh = make_local_mesh(tuple(mesh_shape), device_type=device)
        plain, plain_losses = unsharded_run(cfg, shape, steps, device=device)
        for fault in faults:
            t0 = time.perf_counter()
            state, losses, comms, _ = sharded_run(cfg, shape, mesh, steps,
                                                  fault=fault, device=device)
            recs.append(dict(
                rank=rank, arch=arch, mesh=list(mesh_shape), batch=batch,
                seq=seq, steps=steps, fault=fault, device=device,
                seq_axes=_seq_axes(mesh, batch, seq),
                rel_err=hold(state, plain), limit=LIMIT, losses=losses,
                plain_losses=plain_losses, comms=comms,
                sharded_s=time.perf_counter() - t0))
    except Exception:
        recs = {"error": traceback.format_exc()}
        raise
    finally:
        dist.destroy_process_group()
        pathlib.Path(out).write_text(json.dumps(recs))


def _seq_axes(mesh, batch: int, seq: int):
    """The mesh axes ``batch_seq_spec`` gives the sequence (None: the
    batch covers the mesh)."""
    from repro_torch.distributed.auto_shard import batch_seq_spec
    return batch_seq_spec(mesh, batch, seq)[1]


def spawn_ranks(world: int, target, args: tuple, timeout_s: float,
                work: Optional[str] = None) -> list:
    """``world`` spawned processes ``target(rank, world, store, out,
    *args)`` on a file store -> each rank's JSON record from ``out``;
    raises when a rank fails or outlives ``timeout_s`` (the others are
    killed), with the first error and the first crash stack."""
    ctx = mp.get_context("spawn")
    work = pathlib.Path(work or tempfile.mkdtemp(prefix="shard-check-"))
    work.mkdir(parents=True, exist_ok=True)
    store = str(work / "store")
    outs = [str(work / f"rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=target, args=(r, world, store, outs[r],
                                              *args))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        errors = [json.loads(pathlib.Path(o).read_text()).get("error", "")
                  for o in outs if pathlib.Path(o).exists()
                  and pathlib.Path(o).read_text().startswith("{")]
        crashes = [pathlib.Path(o + ".fault").read_text() for o in outs
                   if pathlib.Path(o + ".fault").exists()]
        raise RuntimeError(f"shard check ranks exited {codes} (None: "
                           f"hung); first error: "
                           f"{(errors or [''])[0][-1500:]}; first crash: "
                           f"{([c for c in crashes if c] or [''])[0][-3000:]}")
    return [json.loads(pathlib.Path(o).read_text()) for o in outs]


def run_ranks(world: int, arch: str, mesh_shape, batch: int, seq: int,
              steps: int, faults: Sequence[bool] = (False,),
              device: str = "cpu", timeout_s: float = 240.0,
              work: Optional[str] = None) -> list:
    """``world`` spawned ranks of ``run_rank`` (``spawn_ranks``) -> for
    each of ``faults`` the ranks' records."""
    recs = spawn_ranks(world, run_rank, (arch, tuple(mesh_shape), batch,
                                         seq, steps, tuple(faults), device),
                       timeout_s, work)
    return [[r[i] for r in recs] for i in range(len(faults))]


# --- the split decode -------------------------------------------------------
def _rel(a, b) -> float:
    a = a.full_tensor() if hasattr(a, "full_tensor") else a
    return (float((a.double() - b.double()).abs().max())
            / max(float(b.double().abs().max()), 1e-30))


def layout_specs(cache, layout):
    """Specs of a decode cache: each attention leaf (k, v, ckv, kr) on
    ``layout``'s (batch, slots) entries, every other leaf, and ``pos``,
    replicated."""
    from repro_torch.distributed.auto_shard import Spec
    b, s = layout

    def leaf(name, t):
        if name in ("k", "v", "ckv", "kr"):
            return Spec(b, s, *[None] * (t.ndim - 2))
        return Spec(*[None] * t.ndim)
    return {"layers": [{n: leaf(n, t) for n, t in e.items()}
                       for e in cache["layers"]],
            "pos": Spec(None)}


def decode_run(cfg, mesh, layout, seed: int = 0, device="cpu",
               fault: bool = False) -> dict:
    """The serving path of ``cfg`` (``DECODE_CELL``) unsharded and
    sharded on ``mesh``: a prefill sequence-parallel (the batch over
    "data", the prompt over "model") against the unsharded prefill
    (last logits and every cache leaf), then decode steps from the
    unsharded prefill's cache, placed by ``layout_specs``, against the
    unsharded steps (each step's logits and the final cache) -> the
    largest of each distance relative to its reference's largest
    magnitude, and the chunk dims of the first attention cache.
    ``fault``: the chunks never combined (``local_combine``)."""
    import numpy as np
    import torch
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import _dtensor
    from repro_torch.distributed.act_sharding import activation_sharding
    from repro_torch.distributed.auto_shard import (Spec, batch_seq_spec,
                                                    shard_tree)
    from repro_torch.launch import steps as S
    from repro_torch.models import LM
    from repro_torch.models.model import tensors, tree_map
    _chunk_combine = _dtensor.chunk_combine
    B, P, C, n = DECODE_CELL
    model = LM(cfg)
    params = S.cast_params(model.init(seed, device), cfg.compute_dtype)
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, P + n))).to(device)
    cache, want_pre = model.prefill(params, {"tokens": toks[:, :P]}, C)
    start = tree_map(torch.clone, cache)
    want = []
    for i in range(n):
        logits, cache = model.decode_step(params, cache, toks[:, P + i])
        want.append(logits)
    p_specs = S.state_specs(cfg, mesh, {"params": params},
                            min_elems=MIN_ELEMS)["params"]
    sp = shard_tree(params, mesh, p_specs)
    tok_pre = batch_seq_spec(mesh, B, P)
    with implicit_replication(), activation_sharding(tok_pre):
        got_cache, got_pre = model.prefill(
            sp, {"tokens": shard_tree(toks[:, :P], mesh, tok_pre)}, C)
    prefill = max([_rel(got_pre, want_pre)]
                  + [_rel(a, b) for a, b in zip(tensors(got_cache),
                                                tensors(start))])
    c_specs = layout_specs(start, layout)
    sc = shard_tree(start, mesh, c_specs)
    first = next(e for e in sc["layers"] if "k" in e or "ckv" in e)
    dims = _dtensor.cache_chunk_dims(first["ckv" if cfg.mla else "k"])
    tok = Spec(("data",))
    steps = []
    if fault:
        _dtensor.chunk_combine = local_combine
    try:
        with implicit_replication(), \
                activation_sharding(Spec(("data",), None)):
            for i in range(n):
                logits, sc = model.decode_step(
                    sp, sc, shard_tree(toks[:, P + i], mesh, tok))
                steps.append(_rel(logits, want[i]))
    finally:
        _dtensor.chunk_combine = _chunk_combine
    final = max(_rel(a, b) for a, b in zip(tensors(sc), tensors(cache)))
    return dict(prefill_rel_err=prefill, decode_rel_err=steps,
                cache_rel_err=final, chunk_dims=dims,
                prefill_seq_axes=tok_pre[1])


def decode_rank(rank: int, world: int, store: str, out: str,
                mesh_shape: Sequence[int], archs: Sequence[str],
                layouts: Sequence[str], device: str = "cpu",
                faults: Sequence[bool] = (False,)) -> None:
    """One rank of the split decode check: ``decode_run`` of each of
    ``archs`` (reduced, float32) in each of ``layouts``, once for each of
    ``faults``; writes a JSON list of records to ``out`` (a fatal
    signal's stack to ``out`` + ".fault")."""
    fault_log = open(out + ".fault", "w")
    faulthandler.enable(fault_log)
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_local_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    recs: Any = []
    try:
        mesh = make_local_mesh(tuple(mesh_shape), device_type=device)
        for arch in archs:
            for name in layouts:
                for fault in faults:
                    t0 = time.perf_counter()
                    rec = decode_run(get_config(arch).reduced(), mesh,
                                     DECODE_LAYOUTS[name], device=device,
                                     fault=fault)
                    recs.append(dict(rank=rank, arch=arch, layout=name,
                                     fault=fault, cell=list(DECODE_CELL),
                                     limit=LIMIT,
                                     seconds=time.perf_counter() - t0, **rec))
    except Exception:
        recs = {"error": traceback.format_exc()}
        raise
    finally:
        dist.destroy_process_group()
        pathlib.Path(out).write_text(json.dumps(recs))


def run_decode_ranks(world: int = 4, mesh_shape=(2, 2),
                     archs: Sequence[str] = DECODE_ARCHS,
                     layouts: Sequence[str] = tuple(DECODE_LAYOUTS),
                     device: str = "cpu", timeout_s: float = 240.0,
                     work: Optional[str] = None,
                     faults: Sequence[bool] = (False,)) -> list:
    """``world`` spawned ranks of ``decode_rank`` -> every rank's records,
    one list."""
    recs = spawn_ranks(world, decode_rank, (tuple(mesh_shape), tuple(archs),
                                            tuple(layouts), device,
                                            tuple(faults)),
                       timeout_s, work)
    return [r for rank in recs for r in rank]


def decode_ok(r) -> bool:
    """Whether a split decode record holds: its prefill, every decode
    step and the final cache within ``LIMIT``."""
    return (r["prefill_rel_err"] <= LIMIT and r["cache_rel_err"] <= LIMIT
            and all(e <= LIMIT for e in r["decode_rel_err"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mesh", default="2,2")
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--fault", action="store_true")
    ap.add_argument("--decode", action="store_true",
                    help="the split decode (DECODE_ARCHS) instead")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    mesh = [int(n) for n in args.mesh.split(",")]
    if args.decode:
        recs = run_decode_ranks(args.ranks, mesh, work=args.out)
        for r in recs:
            print(json.dumps(r))
        return 0 if all(decode_ok(r) for r in recs) else 1
    recs = run_ranks(args.ranks, args.arch, mesh, args.batch, args.seq,
                     args.steps, (args.fault,), work=args.out)[0]
    for r in recs:
        print(json.dumps(r))
    return 0 if all(r["rel_err"] <= LIMIT for r in recs) else 1


if __name__ == "__main__":
    sys.exit(main())
