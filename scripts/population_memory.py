"""Peak memory and step time of a population on the CUDA card at each
remat: ``PopulationTrainer`` of a published config (its depth cut with
``--layers``) over ``--trials`` trials, batch 1 from ``concrete_inputs``,
a few steps each at "full" and "none"; one JSON line a run with the
card's name and power limit.  A run that does not fit the card reports
``ok: false`` and the error.

    python3 scripts/population_memory.py --arch whisper-medium --trials 3
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import concrete_inputs, get_config  # noqa: E402
from repro_torch.core.vmap_trials import PopulationTrainer  # noqa: E402
from repro_torch.models import ShapeSpec  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(cfg, trials: int, text: int, steps: int) -> dict:
    dev = torch.device("cuda", 0)
    shape = ShapeSpec("train", text + cfg.n_img_tokens, 1, "train")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = dict(arch=cfg.name, layers=cfg.n_layers, remat=cfg.remat,
               trials=trials, text=text, steps=steps)
    t0 = time.perf_counter()
    try:
        objective = PopulationTrainer(cfg, device=dev).train(
            [{"lr": 1e-4, "weight_decay": 0.0, "seed": i}
             for i in range(trials)],
            lambda t: concrete_inputs(cfg, shape, seed=t, device=dev),
            steps, eval_last=steps)
        torch.cuda.synchronize()
        out.update(ok=True, objective=objective.tolist())
    except torch.OutOfMemoryError as e:
        out.update(ok=False, error=str(e).splitlines()[0])
    out.update(seconds=time.perf_counter() - t0,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--text", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("population_memory: no CUDA device", file=sys.stderr)
        return 1
    cfg = get_config(args.arch)
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    name = card()
    for remat in ("full", "none"):
        line = run(dataclasses.replace(cfg, remat=remat), args.trials,
                   args.text, args.steps)
        print(json.dumps(dict(line, card=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
