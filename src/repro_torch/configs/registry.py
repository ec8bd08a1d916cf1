"""Architecture registry of the port: the architectures it runs.

The reference's registry has ten; the port lists the eight of the dense,
hybrid, MoE and encoder-decoder families, the parallel-block dense model
among them, whose layers it has ported.  Asking for any other name
(``llava-next-34b``, ``xlstm-125m``) raises, naming the ROADMAP item
that ports it.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "granite-8b": "granite_8b",
    "granite-3-8b": "granite_3_8b",
    "phi3-medium-14b": "phi3_medium_14b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "command-r-plus-104b": "command_r_plus_104b",
    "whisper-medium": "whisper_medium",
}


def list_archs():
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise NotImplementedError(
            f"arch {name!r} is not in the port, which runs {list(_MODULES)}; "
            "the other architectures of the JAX package (VLM, xLSTM) are "
            "queued in ROADMAP.md §1")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
