"""Step functions of the port's server: the reference's
``launch/steps.py`` without its mesh and sharding specs (the port serves
on one card) and without training, which is not ported yet."""
from __future__ import annotations

import torch

from repro_torch.models import LM
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import tree_map


def cast_params(params, dtype: torch.dtype, device=None):
    """Cast floating leaves (f32 masters) to the compute dtype, once, and
    move every leaf to ``device`` when one is given."""
    return tree_map(
        lambda a: a.to(device=device,
                       dtype=dtype if a.is_floating_point() else a.dtype),
        params)


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    model = LM(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, cache, tokens) -> (next, cache)."""
    model = LM(cfg)

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1), cache

    return model, serve_step
