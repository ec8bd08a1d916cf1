"""Cells of the benchmark cut to a size the CPU tests can run in seconds:
the real configuration, traffic and cell files, with the widths, depths
and lengths below put over them."""
from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path
from typing import Dict

from portbench import harness

WIDTHS: Dict[str, Dict] = {
    "moe_decoder": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                        head_dim=16, n_experts=4, top_k=2, d_ff_expert=32,
                        d_ff=32, vocab_size=257),
    "encdec": dict(n_layers=2, encoder_layers=2, encoder_seq=24, d_model=64,
                   n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
                   vocab_size=257),
}
TRAFFIC = dict(seq=32, batch=2)
#: limits for these cells computing in float32: ten times the most that
#: float32's rounding read over six seeds of each cell (loss 2.5e-7,
#: gradient 5.2e-7; the change 5.4e-4, whisper's LayerNorm scales, whose
#: nearly-zero gradient elements AdamW moves by their sign); bf16 reads
#: 8e-5 to 6e-4 in the loss, 8e-3 to 8e-2 in the gradient
F32_LIMITS = {"loss_gap": 1e-5, "loss1_gap": 1e-5, "grad_gap": 1e-5,
              "change_gap": 5e-3}


def cut(config: Dict, traffic: Dict, dtype: str = "bfloat16"):
    """(config, traffic) at the tiny size, computing in ``dtype``."""
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["run"].update(WIDTHS[config["reference"]], dtype=dtype)
    traffic.update(TRAFFIC)
    return config, traffic


#: cells whose files the benchmark keeps without an entry in
#: BENCHMARK.json (whisper's population: its step is host-bound, and its
#: rate swings with the host's load; PERF.md), held here all the same
KEPT = {"configs": [{"name": "whisper-medium",
                     "source": "https://huggingface.co/openai/whisper-medium",
                     "file": "portbench/configs/whisper-medium.json",
                     "reduced": ["max_source_positions",
                                 "activation_function"]}],
        "workloads": [{"name": "whisper.pop", "config": "whisper-medium",
                       "traffic": "population-4x2-s448", "chips": 1}]}


def suite(root=harness.ROOT) -> harness.Suite:
    """The benchmark at ``root`` with the kept cells added."""
    s = harness.Suite(root)
    for key, entries in KEPT.items():
        names = {e["name"] for e in s.spec[key]}
        s.spec[key] += [e for e in entries if e["name"] not in names]
    return s


def cell(workload: str, dtype: str = "bfloat16") -> harness.Cell:
    """The workload's cell at the tiny size."""
    c = suite().cell(workload)
    c.config, c.traffic = cut(c.config, c.traffic, dtype)
    return c


def checkout(dest: Path, dtype: str = "bfloat16") -> Path:
    """A copy of the benchmark's files at ``dest`` (its BENCHMARK.json,
    with the kept cells added, and its folder), every configuration and
    traffic cut to the tiny size; returns ``dest``."""
    full = suite()
    dest = Path(dest)
    shutil.copytree(full.base, dest / full.base.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    (dest / "BENCHMARK.json").write_text(json.dumps(full.spec))
    configs = {c["name"]: c for c in full.spec["configs"]}
    for w in full.spec["workloads"]:
        cfg_path = dest / configs[w["config"]]["file"]
        tr_path = dest / full.base.name / "traffic" / f"{w['traffic']}.json"
        config, traffic = cut(json.loads(cfg_path.read_text()),
                              json.loads(tr_path.read_text()), dtype)
        cfg_path.write_text(json.dumps(config))
        tr_path.write_text(json.dumps(traffic))
    return dest
