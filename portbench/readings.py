"""The readings the check's limits are set from, many seeds in one
process (no window, nothing timed):

    python3 portbench/readings.py --workload <name> --seeds 1,2,3 \\
        --mode program|control|unchanged|half_batch|double_leaf

``program``: the program's checked steps against the reference, the
lower readings; ``control``: the reference itself computed with its
matrix products in float8 (``reference/common.py``) in the program's
place; the faults (``faults.py``): the program with one planted.  Each
seed prints one JSON line of the three compared numbers (where each was
worst) to standard output and appends it to ``--out``.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", default="program")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import contextlib
    import torch
    from portbench import compare as C
    from portbench import faults, harness
    from portbench import traffic as T

    device = torch.device(args.device)
    suite = harness.Suite(ROOT)
    cell = suite.cell(args.workload)
    names = harness.leaf_names(cell)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        hp = T.hyperparameters(cell.traffic, seed)
        if args.mode == "control":
            prog = harness.follow_reference(cell, seed, device, hp, "fp8")
        else:
            ctx = (contextlib.nullcontext() if args.mode == "program"
                   else faults.planted(args.mode))
            with ctx:
                trainer, prog, _ = harness.checked_steps(cell, seed, device, hp)
                trainer.close()
                del trainer
        harness.free(device)
        ref = harness.follow_reference(cell, seed, device, hp)
        numbers = C.gaps(prog, ref, names)
        line = {"workload": args.workload, "mode": args.mode, "seed": seed,
                "seconds": time.perf_counter() - t0,
                **{n: numbers[n] for n in C.NAMES}}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(json.dumps(line) + "\n")
        harness.free(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
