"""The whole step's share of the card's bf16 peak: model FLOPs a step
(``work/``: 6 a parameter and position, active experts only, plus the
attention pairs; no recomputation) times the window's steps, over the
window's time times 989e12 FLOP/s."""
from portbench.work.common import PEAK_BF16_FLOPS


def read(run):
    if not run.window_steps:
        return None
    flops = run.work["model_flops"] * run.window_steps
    return 100.0 * flops / (run.window_s * PEAK_BF16_FLOPS)
