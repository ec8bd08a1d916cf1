"""Roofline terms of one H100 SXM from the per-device cost of a step.

The port's copy of the reference's ``distributed/roofline.py``, with the
card's constants in place of the TPU's (NVIDIA's H100 SXM data sheet,
dense, at 700 W): 989e12 bf16 FLOP/s on the tensor cores, 67e12 float32
FLOP/s, 3.35e12 B/s of HBM3, and NVLink 4 at 450e9 B/s a direction.  The
same formula and keys; ``hw`` is an argument, so a test can hold the
formula at the reference's constants.  The cost is per device because
``distributed/cost.py`` counts each rank's local shards:

  compute    = flops / peak_flops
  memory     = bytes_accessed / hbm_bw
  collective = per-device ring link bytes / ici_bw   (one-link model)

MODEL_FLOPS uses the 6*N*D rule (N = params, D = tokens; N_active for
MoE), so the useful-compute ratio exposes remat, padding and replication
waste.  ``PEAK_F32_FLOPS``, ``PEAK_BF16_FLOPS`` and ``PEAK_BYTES`` are the
peaks every bound of ``chip_smoke.py`` divides by.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

#: published peaks of one H100 SXM (NVIDIA data sheet, dense, 700 W)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
#: NVLink 4, bytes/s a direction per GPU
NVLINK_BYTES = 450e9


@dataclass(frozen=True)
class _HW:
    peak_flops: float = PEAK_BF16_FLOPS     # bf16 FLOP/s per card
    hbm_bw: float = PEAK_BYTES              # bytes/s per card
    ici_bw: float = NVLINK_BYTES            # bytes/s per link direction


HW = _HW()


def roofline_terms(cost: Dict[str, float], ici_bytes_per_chip: float,
                   *, model_flops_per_chip: Optional[float] = None,
                   hw: _HW = HW) -> Dict[str, float]:
    flops = float(cost.get("flops", 0.0) or 0.0)
    bytes_accessed = float(cost.get("bytes accessed", 0.0) or 0.0)
    t_compute = flops / hw.peak_flops
    t_memory = bytes_accessed / hw.hbm_bw
    t_coll = ici_bytes_per_chip / hw.ici_bw
    dominant = max((("compute", t_compute), ("memory", t_memory),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    out = {
        "hlo_flops_per_chip": flops,
        "hlo_bytes_per_chip": bytes_accessed,
        "ici_bytes_per_chip": ici_bytes_per_chip,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "bound_s": max(t_compute, t_memory, t_coll),
    }
    if model_flops_per_chip:
        out["model_flops_per_chip"] = model_flops_per_chip
        out["useful_ratio"] = (model_flops_per_chip / flops) if flops else 0.0
        # fraction of the compute roofline actually achieved at the bound
        out["roofline_fraction"] = (
            (model_flops_per_chip / hw.peak_flops) / out["bound_s"]
            if out["bound_s"] else 0.0)
    return out
