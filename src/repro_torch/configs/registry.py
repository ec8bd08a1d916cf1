"""Architecture registry of the port: the reference's ten architectures
(dense, parallel-block dense, hybrid, MoE, encoder-decoder, VLM and
xLSTM), in the reference's order, each config a field-for-field copy of
the reference's.  An unknown name raises ``KeyError``, as the
reference's ``get_config`` does.
"""
from __future__ import annotations

import importlib

from repro_torch.models.common import ModelConfig

_MODULES = {
    "phi3-medium-14b": "phi3_medium_14b",
    "command-r-plus-104b": "command_r_plus_104b",
    "granite-3-8b": "granite_3_8b",
    "granite-8b": "granite_8b",
    "whisper-medium": "whisper_medium",
    "llava-next-34b": "llava_next_34b",
    "xlstm-125m": "xlstm_125m",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
}


def list_archs():
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
