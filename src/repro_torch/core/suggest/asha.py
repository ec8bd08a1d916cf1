"""ASHA-style asynchronous successive halving (paper §2.5: stop bad trials
early and free their resources).

This is a server-side
:class:`~repro_torch.core.suggest.base.StoppingPolicy`: the suggestion
service owns ONE instance per experiment, every worker's
``ctx.report(step, value)`` flows into it, and its rung table is
JSON-serializable so it survives service restarts (snapshot + metric-log
replay, exactly like the observation log).

Semantics:
* rungs are ``min_steps * eta**i``; a trial is *recorded* at a rung the
  first time a report's step reaches it, and must then be within the top
  ``1/eta`` of all values recorded at that rung to proceed;
* a report whose step jumps past several rungs is evaluated at every
  crossed rung up to its first failure — a stop at a low rung can never
  be masked by a pass at a higher one, and the value is never recorded
  above the failing rung (an unpromoted trial must not pad higher-rung
  populations);
* ``mode='stop'`` (default) makes the decision final; ``mode='pause'``
  answers ``'pause'`` instead, i.e. the classic promotion-based ASHA: the
  trial's resources are released but its suggestion stays pending, and a
  later re-report at the same rung is re-evaluated against the *current*
  rung population (promotion when enough worse trials arrived).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Set

from repro_torch.core.suggest.base import StoppingPolicy, register_stopping


@register_stopping("asha")
class ASHA(StoppingPolicy):
    def __init__(self, min_steps: int = 1, eta: int = 3, max_rungs: int = 6,
                 goal: str = "max", mode: str = "stop"):
        if mode not in ("stop", "pause"):
            raise ValueError(f"mode must be 'stop' or 'pause', got {mode!r}")
        self.eta = eta
        self.goal = goal
        self.mode = mode
        self.min_steps = min_steps
        self.rungs: List[int] = [min_steps * eta ** i for i in range(max_rungs)]
        self.version = 0
        self._values: Dict[int, List[float]] = {r: [] for r in self.rungs}
        self._recorded: Dict[str, Set[int]] = {}   # trial -> rungs recorded
        self._stopped: Set[str] = set()            # final decisions (mode=stop)

    # ------------------------------------------------------------- reporting
    def report(self, trial_id: str, step: int, value: float) -> str:
        """Returns 'continue' | 'stop' | 'pause'."""
        if trial_id in self._stopped:
            return "stop"
        v = value if self.goal == "max" else -value
        rec = self._recorded.setdefault(trial_id, set())
        failed_rung = None
        for rung in self.rungs:
            if step < rung:
                break
            vals = self._values[rung]
            newly = rung not in rec
            if newly:
                rec.add(rung)
                vals.append(v)
                self.version += 1
            # stop mode judges each rung exactly once, when first crossed:
            # a between-rung report (noisy dip, speculative twin catching
            # up) must not retro-fail a rung the trial already passed.
            # pause mode re-evaluates recorded rungs against the CURRENT
            # population — that re-check is the promotion mechanism for
            # resumed trials.
            if not newly and self.mode == "stop":
                continue
            k = max(1, len(vals) // self.eta)
            top_k = sorted(vals, reverse=True)[:k]
            if v < top_k[-1]:
                failed_rung = rung
                # never record above the first failing rung: the trial is
                # not promoted past it, so padding higher rungs would
                # loosen their top-1/eta cut for everyone else
                break
        if failed_rung is None:
            return "continue"
        if self.mode == "pause":
            return "pause"
        self._stopped.add(trial_id)
        self.version += 1
        return "stop"

    def next_rung(self, trial_id: str) -> Optional[int]:
        rec = self._recorded.get(trial_id, ())
        for rung in self.rungs:
            if rung not in rec:
                return rung
        return None

    # ----------------------------------------------------- snapshot/restore
    def state(self) -> Dict[str, Any]:
        return {"policy": "asha", "eta": self.eta, "goal": self.goal,
                "mode": self.mode, "min_steps": self.min_steps,
                "rungs": list(self.rungs),
                "values": {str(r): list(v) for r, v in self._values.items()
                           if v},
                "recorded": {t: sorted(r) for t, r in self._recorded.items()
                             if r},
                "stopped": sorted(self._stopped)}

    def restore(self, state: Dict[str, Any]) -> None:
        self.rungs = [int(r) for r in state.get("rungs", self.rungs)]
        self._values = {r: [] for r in self.rungs}
        for r, vals in state.get("values", {}).items():
            self._values[int(r)] = [float(v) for v in vals]
        self._recorded = {t: set(int(r) for r in rs)
                          for t, rs in state.get("recorded", {}).items()}
        self._stopped = set(state.get("stopped", []))
        self.version += 1
