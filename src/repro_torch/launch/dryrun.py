"""Multi-pod dry run of the port: one step of every (architecture x
input-shape x mesh) cell on a fake process group of 256 or 512 ranks,
proving the sharding config is coherent (every op has its shards, the
state fits) and stating the H100 roofline terms.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell against 512 placeholder host devices.
Here each cell runs once, eagerly:

* a fake process group of 256 (16x16 ``("data", "model")``) or 512
  (2x16x16 with ``"pod"``) ranks (``torch.testing``'s ``FakeStore``:
  collectives are recorded, not performed) and this process as the last
  rank, whose shards are the last of every sharded dim: where a step
  shards the sequence (``_dtensor.on_seq_shards``), its causal attention
  has the most (query, key) pairs there, so the cell costs the slowest
  rank's step;
* the state as DTensors of meta tensors (shapes, no storage) placed by
  ``state_specs``, the batch by ``batch_specs``;
* one step: train (forward, backward and AdamW with ``grad_specs``),
  prefill, or decode over ``cache_specs``' cache, under the activation
  anchors of the batch's spec;
* ``distributed/cost.py``'s per-device cost of that step (the last
  rank's local ops and collectives), ``distributed/memory.py``'s live
  bytes of it, and the H100 roofline (``distributed/roofline.py``).

On meta tensors the hand-written kernels run as their meta functions
(``kernels/ops.py``: the outputs' shapes, each launch charged by its work
formula), so a cell costs what the card's kernels would do rather than
the plain versions' sequential loops (each record says ``"kernels":
"meta"``); the rest of the step is the port's own PyTorch code.  Meta
tensors, not ``FakeTensorMode``: DTensor's propagation reads a strided
shard's local size off a tensor it makes, which a fake mode turns into a
data-dependent value.

``memory`` holds the reference's ``memory_analysis()`` keys, a device:
``argument_size_in_bytes`` is the state's exact ``sharded_bytes`` (the
batch is live but not counted there); the output, alias, temp and peak
bytes come from the tracker of live local-shard storage
(``distributed/memory.py``) around the step, the last rank's shards
(every rank's are equal in shape), with temp
= peak - argument - (output - alias).  An eager step has no compiled
program, so ``generated_code_size_in_bytes`` is absent;
``memory_notes`` says so and names what the tracker cannot see.

On 2x16x16 the state's specs
put ``pod`` after ``data`` in hundreds of entries, against the mesh's
order: the cell shards those leaves in mesh order (same shard sizes,
other rows a rank; ``auto_shard.placements``) and records how many
(``reordered_leaves``).  One ``trace_s`` (the step's
wall time) replaces the reference's ``lower_s`` / ``compile_s``.  The
process group is destroyed after every cell.

Usage:
  python -m repro_torch.launch.dryrun --arch phi3-medium-14b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # every cell, both meshes
  python -m repro_torch.launch.dryrun --all --mesh pod # every cell, one mesh

Artifacts: one JSON per cell under results/dryrun_torch/.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import pathlib
import sys
import time
import traceback

import torch

from repro_torch.configs.registry import (get_config, input_specs,
                                          list_archs)
from repro_torch.distributed import cost as C
from repro_torch.distributed import memory as M
from repro_torch.distributed.act_sharding import activation_sharding
from repro_torch.distributed.auto_shard import (Spec, count_reordered,
                                                shard_tree, sharded_bytes)
from repro_torch.distributed.roofline import roofline_terms
from repro_torch.launch import steps as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import SHAPES, shape_applicable
from repro_torch.optim import AdamWConfig

def apply_opts(cfg, opts):
    """Hillclimb knobs: comma list like 'remat=none,dtype=float32'.  The
    port has no layer scan, so ``scan=`` is refused."""
    over = {}
    for item in (opts or "").split(","):
        if not item:
            continue
        k, _, v = item.partition("=")
        if k == "remat":
            over["remat"] = v
        elif k == "scan":
            raise ValueError("scan=: the port runs its layers in a Python "
                             "loop and has no layer scan to switch")
        elif k == "dtype":
            over["dtype"] = v
        elif k == "capacity":
            over["capacity_factor"] = float(v)
        else:
            raise ValueError(f"unknown opt {k}")
    return dataclasses.replace(cfg, **over) if over else cfg


@contextlib.contextmanager
def fake_world(n: int, rank: int = 0):
    """A fake process group of ``n`` ranks, this process ``rank`` (-1:
    the last); destroyed on the way out."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", rank=rank % n, world_size=n,
                            store=FakeStore())
    try:
        yield
    finally:
        dist.destroy_process_group()


def _inputs(cfg, shape):
    """Meta tensors of the cell's ``input_specs``; token ids int64."""
    out = {}
    for name, (dims, dtype) in input_specs(cfg, shape).items():
        out[name] = torch.empty(dims, device="meta", dtype=(
            dtype if dtype.is_floating_point else torch.long))
    return out


def _step(cfg, shape, mesh):
    """The cell's state, its spec tree, a function placing the step's
    arguments (-> the state's, the batch's and the step, which takes them
    in that order), the ambient activation spec and its 6ND / 2ND model
    FLOPs (before dividing by the mesh) -> (arg_shapes, arg_specs, make,
    act, flops)."""
    n_params = cfg.param_count()
    n_use = cfg.active_param_count() if cfg.moe else n_params
    specs_in = input_specs(cfg, shape)
    if shape.kind == "train":
        st_shapes = S.train_state_shapes(cfg)
        st_specs = S.state_specs(cfg, mesh, st_shapes)
        _, step = S.make_train_step(cfg, AdamWConfig(),
                                    grad_specs=st_specs["params"])
        b_specs = S.batch_specs(cfg, shape, mesh, specs_in)
        tok = b_specs["tokens"]

        def run():
            state = shard_tree(st_shapes, mesh, st_specs, reorder=True)
            batch = shard_tree(_inputs(cfg, shape), mesh, b_specs)
            return (state,), (batch,), step
        flops = 6.0 * n_use * shape.global_batch * shape.seq_len
        return st_shapes, st_specs, run, Spec(tok[0], tok[1]), flops
    p_shapes = S.cast_param_shapes(S.train_state_shapes(cfg)["params"],
                                   cfg.compute_dtype)
    p_specs = S.state_specs(cfg, mesh, {"params": p_shapes})["params"]
    if shape.kind == "prefill":
        _, step = S.make_prefill_step(cfg, shape.seq_len)
        b_specs = S.batch_specs(cfg, shape, mesh, specs_in)
        tok = b_specs["tokens"]

        def run():
            params = shard_tree(p_shapes, mesh, p_specs, reorder=True)
            batch = shard_tree(_inputs(cfg, shape), mesh, b_specs)
            return (params,), (batch,), step
        flops = 2.0 * n_use * shape.global_batch * shape.seq_len
        return p_shapes, p_specs, run, Spec(tok[0], tok[1]), flops
    _, step = S.make_serve_step(cfg)
    cshapes, cspecs, tok_spec = S.decode_specs(cfg, shape, mesh)

    def run():
        params = shard_tree(p_shapes, mesh, p_specs, reorder=True)
        cache = shard_tree(cshapes, mesh, cspecs, reorder=True)
        tokens = shard_tree(_inputs(cfg, shape)["tokens"], mesh, tok_spec)
        return (params, cache), (tokens,), step
    flops = 2.0 * n_use * shape.global_batch
    act = Spec(tok_spec[0] if len(tok_spec) else None, None)
    return ((p_shapes, cshapes), (p_specs, cspecs), run, act, flops)


def measure(cfg, shape, mesh) -> dict:
    """One step of the cell (``cfg``, ``shape``) on ``mesh``, whose
    process group is live (a fake one): the state's argument bytes a
    device, its leaves sharded in mesh order, the step's cost (this
    rank's ops, ``distributed/cost.py``), its memory (this rank's live
    local-shard bytes, ``distributed/memory.py``), its wall seconds and
    its model
    FLOPs (6ND / 2ND, before dividing by the mesh)."""
    from torch.distributed.tensor.experimental import implicit_replication
    arg_shapes, arg_specs, make, act, model_flops = _step(cfg, shape, mesh)
    arg_bytes = sharded_bytes(arg_shapes, arg_specs, mesh)
    t0 = time.perf_counter()
    with implicit_replication(), activation_sharding(act):
        state, batch, step = make()
        with C.counting() as counter, \
                M.tracking(state, live=batch) as tracker:
            tracker.add_outputs(step(*state, *batch))
        del state, batch
    return dict(arg_bytes=arg_bytes,
                reordered=count_reordered(arg_specs, mesh),
                cost=counter.result(), memory=tracker.result(),
                trace_s=time.perf_counter() - t0, model_flops=model_flops)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, opts: str = "",
             verbose: bool = True) -> dict:
    cfg = apply_opts(get_config(arch), opts)
    shape = SHAPES[shape_name]
    mesh_name = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}" + (f"__{opts}" if opts else "")
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "kind": shape.kind, "opts": opts, "ok": False}

    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        rec.update(skipped=True, skip_reason=reason, ok=True)
        _write(out_dir, tag, rec)
        if verbose:
            print(f"[dryrun] {tag}: SKIP ({reason})")
        return rec

    n_dev = 512 if multi_pod else 256
    try:
        with fake_world(n_dev, rank=-1):
            m = measure(cfg, shape,
                        make_production_mesh(multi_pod=multi_pod))
        cost, memory = m["cost"], m["memory"]
        terms = roofline_terms(cost, cost["ici_bytes"],
                               model_flops_per_chip=m["model_flops"] / n_dev)
        rec.update(
            ok=True, n_devices=n_dev, params=cfg.param_count(),
            active_params=cfg.active_param_count(), trace_s=m["trace_s"],
            kernels="meta", arg_bytes_per_device=m["arg_bytes"],
            reordered_leaves=m["reordered"],
            memory=memory, memory_notes=[M.NO_GENERATED_CODE,
                                         "not seen: " + M.UNSEEN],
            cost={k: cost[k] for k in ("flops", "bytes accessed",
                                       "transcendentals", "aten_ops",
                                       "top_ops")},
            collectives={"counts": cost["collective_counts"],
                         "ici_bytes": cost["collective_bytes"],
                         "total_ici_bytes": cost["ici_bytes"]},
            roofline=terms)
        if verbose:
            print(f"[dryrun] {tag}: OK trace={m['trace_s']:.1f}s "
                  f"dominant={terms['dominant']} "
                  f"frac={terms.get('roofline_fraction', 0):.3f} "
                  f"args/dev={m['arg_bytes'] / 2**30:.2f}GiB "
                  f"peak/dev={memory['peak_memory_in_bytes'] / 2**30:.2f}"
                  f"GiB")
    except Exception as e:  # a failure here is a bug in the system
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc())
        if verbose:
            print(f"[dryrun] {tag}: FAIL {type(e).__name__}: {e}")
    _write(out_dir, tag, rec)
    gc.collect()
    return rec


def _write(out_dir: pathlib.Path, tag: str, rec: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{tag}.json").write_text(json.dumps(rec, indent=1))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=("pod", "multipod",
                                                       "both"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opts", default="", help="hillclimb overrides")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    apply_opts(get_config(list_archs()[0]), args.opts)   # refuse early
    out = pathlib.Path(args.out)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"pod": [False], "multipod": [True],
              "both": [False, True]}[args.mesh]

    n_fail = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch}__{shape}__{mesh_name}" + (
                    f"__{args.opts}" if args.opts else "")
                if args.skip_existing and (out / f"{tag}.json").exists():
                    prev = json.loads((out / f"{tag}.json").read_text())
                    if prev.get("ok"):
                        print(f"[dryrun] {tag}: cached OK")
                        continue
                rec = run_cell(arch, shape, mp, out, args.opts)
                n_fail += 0 if rec.get("ok") else 1
    print(f"[dryrun] done, failures={n_fail}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
