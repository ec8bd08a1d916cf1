"""The comparison that decides ``correct``: the program's first steps held
to the reference's, trial by trial.

Four numbers, each the worst over the trials; a cell's file names the
ones it compares, each with its limit:

- ``loss_gap``: |program − reference| / |reference| of each checked
  step's loss; ``loss1_gap``: the same of the first step's alone, before
  any update (the later steps' gaps swing with the trial's learning rate
  and the routing at an expert's capacity);
- ``grad_gap``: each parameter's gradient norm at the first step, before
  clipping (the program's worked out from its first moment after that
  step), |program − reference| over the larger of the reference's norm
  of that parameter and of the median parameter;
- ``change_gap``: the same of each parameter's change over the checked
  steps, leaving out the parameters whose reference gradient is under a
  thousandth of the median parameter's (a key bias under softmax: AdamW
  moves them by round-off alone).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

#: a parameter counts in ``change_gap`` where its reference gradient
#: norm is at least this share of the median parameter's
MOVED = 1e-3
NAMES = ("loss_gap", "loss1_gap", "grad_gap", "change_gap")


def _worst(prog: Sequence[float], ref: Sequence[float],
           keep: Sequence[bool]) -> Tuple[float, int]:
    kept = [r for r, k in zip(ref, keep) if k]
    floor = statistics.median(kept) if kept else 0.0
    worst, at = 0.0, -1
    for i, (p, r, k) in enumerate(zip(prog, ref, keep)):
        if not k:
            continue
        gap = abs(p - r) / max(r, floor, 1e-30)
        if not math.isfinite(gap):
            gap = math.inf
        if gap > worst or at < 0:
            worst, at = gap, i
    return worst, at


def gaps(prog: List[Dict[str, list]], ref: List[Dict[str, list]],
         names: Sequence[str]) -> Dict[str, Dict]:
    """prog, ref: one {"loss", "grad", "change"} a trial (lists of floats,
    the parameters in ``names``' order) -> {number: {"value", "trial",
    "where"}}."""
    out = {n: {"value": 0.0, "trial": None, "where": None} for n in NAMES}

    def note(name, value, trial, where):
        if not (value <= out[name]["value"]):   # NaN counts as worst
            out[name] = {"value": value, "trial": trial, "where": where}

    for t, (p, r) in enumerate(zip(prog, ref)):
        for s, (lp, lr) in enumerate(zip(p["loss"], r["loss"])):
            gap = abs(lp - lr) / max(abs(lr), 1e-30)
            gap = gap if math.isfinite(gap) else math.inf
            note("loss_gap", gap, t, f"step {s + 1}")
            if s == 0:
                note("loss1_gap", gap, t, "step 1")
        everyone = [True] * len(names)
        g, i = _worst(p["grad"], r["grad"], everyone)
        note("grad_gap", g, t, names[i])
        med = statistics.median(r["grad"])
        moved = [x >= MOVED * med for x in r["grad"]]
        c, i = _worst(p["change"], r["change"], moved)
        note("change_gap", c, t, names[i])
    return out


def verdict(numbers: Dict[str, Dict], limits: Optional[Dict[str, float]]
            ) -> bool:
    """Every compared number (those ``limits`` names) within its limit;
    with no limit set, nothing is correct."""
    return bool(limits) and all(numbers[n]["value"] <= lim
                                for n, lim in limits.items())
