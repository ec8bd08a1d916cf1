"""The port's dry run of the same cells from two checkouts, side by side.

Each checkout runs ``repro_torch.launch.dryrun.run_cell`` on its own
source (a pool of spawned worker processes a checkout, its ``src`` first
on the path) and writes its records under ``<out>/<label>/``; then every
cell prints one line a checkout: the H100 bound, its dominant term, the
per-device FLOPs, the useful ratio, the peak and argument bytes a device
and the collectives by kind.  Host-side and deterministic: meta tensors
on a fake process group.

    python3 scripts/compare_dryrun.py --base build/parent --out /tmp/cmp \\
        --cells command-r-plus-104b:prefill_32k:pod \\
                phi3-medium-14b:decode_32k:pod

``--cells`` takes arch:shape:mesh (mesh ``pod`` is 16x16, ``multipod``
2x16x16); ``--affected`` stands for every cell a sequence-parallel step
changes (each arch's ``prefill_32k`` and ``decode_32k`` on 16x16 and
``train_4k`` on 2x16x16, but xlstm-125m's prefill and train, which take
minutes each) and ``train_4k`` on 16x16 beside them, which it leaves as
it was.
"""
from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import multiprocessing as mp
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ("command-r-plus-104b", "llava-next-34b", "whisper-medium",
         "phi3-medium-14b", "deepseek-v2-lite-16b", "granite-moe-3b-a800m",
         "recurrentgemma-2b", "granite-3-8b", "granite-8b", "xlstm-125m")
AFFECTED = tuple(
    (a, s, m) for a in ARCHS
    for s, m in (("prefill_32k", "pod"), ("decode_32k", "pod"),
                 ("train_4k", "multipod"), ("train_4k", "pod"))
    if not (a == "xlstm-125m" and s in ("prefill_32k", "train_4k")))


def _cell(args):
    root, out, (arch, shape, mesh) = args
    sys.path.insert(0, str(pathlib.Path(root) / "src"))
    from repro_torch.launch import dryrun
    rec = dryrun.run_cell(arch, shape, mesh == "multipod", pathlib.Path(out),
                          verbose=False)
    return rec["ok"], rec.get("error")


def run(root: pathlib.Path, out: pathlib.Path, cells, workers: int):
    """Every cell's record from ``root``'s source into ``out``."""
    with cf.ProcessPoolExecutor(workers,
                                mp_context=mp.get_context("spawn")) as ex:
        for cell, (ok, err) in zip(cells, ex.map(
                _cell, [(str(root), str(out), c) for c in cells])):
            if not ok:
                print(f"{cell}: FAIL {err}", file=sys.stderr)


def line(rec: dict) -> str:
    if rec.get("skipped"):
        return "skipped: " + rec.get("skip_reason", "")
    if not rec.get("ok"):
        return "FAIL: " + str(rec.get("error"))
    rf, mem = rec["roofline"], rec["memory"]
    return (f"bound_s={rf['bound_s']:.6g} dominant={rf['dominant']} "
            f"flops={rf['hlo_flops_per_chip']:.6g} "
            f"useful={rf.get('useful_ratio', 0.0):.6g} "
            f"peak_bytes={mem['peak_memory_in_bytes']} "
            f"arg_bytes={mem['argument_size_in_bytes']} "
            f"collectives={json.dumps(rec['collectives']['counts'])}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", required=True,
                    help="root of the checkout to compare this one with")
    ap.add_argument("--out", required=True)
    ap.add_argument("--cells", nargs="*", default=[])
    ap.add_argument("--affected", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)
    cells = [tuple(c.split(":")) for c in args.cells]
    if args.affected:
        cells += list(AFFECTED)
    out = pathlib.Path(args.out)
    trees = {"base": pathlib.Path(args.base).resolve(), "this": ROOT}
    for label, root in trees.items():
        run(root, out / label, cells, args.workers)
    for arch, shape, mesh in cells:
        grid = "2x16x16" if mesh == "multipod" else "16x16"
        tag = f"{arch}__{shape}__{grid}"
        for label in trees:
            path = out / label / f"{tag}.json"
            rec = json.loads(path.read_text()) if path.exists() else {}
            print(f"{tag} {label}: {line(rec)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
