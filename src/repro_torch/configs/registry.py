"""Architecture registry of the port: the reference's ten architectures
(dense, parallel-block dense, hybrid, MoE, encoder-decoder, VLM and
xLSTM), in the reference's order, each config a field-for-field copy of
the reference's.  An unknown name raises ``KeyError``, as the
reference's ``get_config`` does.

``input_specs(cfg, shape)`` names every model input of a (architecture x
input-shape) cell with its shape and torch dtype, as the reference's
does with ``jax.ShapeDtypeStruct``s; ``concrete_inputs`` draws a real
batch of those shapes from a numpy seed, number for number the
reference's, on a device (the card by default).  ``cache_specs(cfg,
shape)`` is the cell's decode cache as meta tensors (shapes and dtypes,
no storage), the dry run's decode cache.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.models.common import SHAPES, ModelConfig, ShapeSpec

#: an input's (shape, dtype)
Spec = Tuple[Tuple[int, ...], torch.dtype]

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


def _token_specs(batch: int, seq: int) -> Dict[str, Spec]:
    return {"tokens": ((batch, seq), torch.int32),
            "labels": ((batch, seq), torch.int32)}


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    """Model inputs for a cell -> {name: (shape, dtype)}.  train and
    prefill give a batch (a VLM's text is S - n_img tokens beside its
    ``img_embeds`` (B, n_img, d); an encoder-decoder's ``frames`` are (B,
    encoder_seq, d); both in the compute dtype; prefill has no
    ``labels``); decode gives {"tokens": (B,)}."""
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.compute_dtype
    if shape.kind == "decode":
        return {"tokens": ((B,), torch.int32)}
    if cfg.family == "vlm":
        specs = _token_specs(B, S - cfg.n_img_tokens)
        specs["img_embeds"] = ((B, cfg.n_img_tokens, cfg.d_model), dt)
    elif cfg.family == "encdec":
        specs = _token_specs(B, S)
        specs["frames"] = ((B, cfg.encoder_seq, cfg.d_model), dt)
    else:
        specs = _token_specs(B, S)
    if shape.kind == "prefill":
        specs.pop("labels")
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeSpec):
    """The decode cache of a cell, ``LM(cfg).init_cache`` on the meta
    device: each layer's entry is the reference's stacked entry with its
    leading ``repeats`` dim unstacked, ``pos`` (B,) int32."""
    from repro_torch.models.model import LM  # lazy, avoids cycle
    B, S = shape.global_batch, shape.seq_len
    enc = cfg.encoder_seq if cfg.family == "encdec" else 0
    return LM(cfg).init_cache(B, S, device="meta", enc_len=enc)


def concrete_inputs(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0,
                    device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A real batch of ``input_specs(cfg, shape)`` on ``device`` (the CUDA
    card by default): from ``np.random.default_rng(seed)``, in the specs'
    order, integers uniform over the vocabulary and floats standard
    normal (drawn in float64, rounded to float32, then cast, as the
    reference's ``jnp.asarray`` does), the reference's numbers."""
    dev = resolve(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (dims, dtype) in input_specs(cfg, shape).items():
        if dtype.is_floating_point:
            a = rng.normal(0, 1, dims).astype(np.float32)
        else:
            a = rng.integers(0, cfg.vocab_size, dims).astype(np.int32)
        out[name] = torch.from_numpy(a).to(device=dev, dtype=dtype)
    return out


__all__ = ["list_archs", "get_config", "input_specs", "cache_specs",
           "concrete_inputs", "SHAPES"]
