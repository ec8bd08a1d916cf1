"""The RG-LRU temporal-mixing block (Griffin / RecurrentGemma).

The port's copy of the RG-LRU part of the reference's
``models/recurrent.py``.  Training and the prefill run the linear
recurrence through ``ops.rglru_scan`` — the hand-written CUDA scan
forward and backward on the card, sequential loops on the CPU — where
the reference runs a parallel ``associative_scan`` (the same function);
decode is the O(1) state update.  xLSTM's mLSTM and
sLSTM blocks are not ported yet (ROADMAP.md §1).

Deviation from the source, as in the reference: RG-LRU gates are dense
rather than block-diagonal.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig

Params = Dict[str, torch.Tensor]
_RGLRU_C = 8.0


# ==========================================================================
# temporal causal conv (depthwise)
# ==========================================================================
def init_conv(init: L.Init, width: int, channels: int, cfg) -> Params:
    return {"w": init.normal((width, channels), 0.1),
            "b": init.zeros((channels,))}


def causal_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B,S,C); width-W depthwise causal conv as W shifted adds."""
    W = p["w"].shape[0]
    w = p["w"].to(x.dtype)
    y = x * w[W - 1]
    for j in range(W - 1):
        shift = W - 1 - j
        y = y + F.pad(x, (0, 0, shift, 0))[:, :-shift] * w[j]
    return y + p["b"].to(x.dtype)


def conv_decode(p: Params, x1: torch.Tensor, buf: torch.Tensor):
    """x1: (B,C) new input; buf: (B,W-1,C) previous inputs (oldest first)."""
    w = p["w"].to(x1.dtype)
    hist = torch.cat([buf, x1[:, None]], dim=1)               # (B,W,C)
    y = torch.einsum("bwc,wc->bc", hist, w) + p["b"].to(x1.dtype)
    return y, hist[:, 1:]


# ==========================================================================
# RG-LRU (Griffin recurrent block: two branches, conv, gated LRU)
# ==========================================================================
def init_rglru_block(init: L.Init, cfg: ModelConfig) -> Params:
    d, r = cfg.d_model, cfg.d_rnn
    p = {
        "in_x": L.init_dense(init, d, r, cfg),
        "in_gate": L.init_dense(init, d, r, cfg),
        "conv": init_conv(init, cfg.conv_width, r, cfg),
        "w_a": L.init_dense(init, r, r, cfg),
        "w_i": L.init_dense(init, r, r, cfg),
    }
    # Λ init so a = exp(-c softplus(Λ)) is in (0.9, 0.999)
    u = init.uniform((r,), 0.9, 0.999)
    lam = torch.log(torch.exp(-torch.log(u) / _RGLRU_C) - 1.0)  # inv softplus
    p["lam"] = lam.to(init.dtype)
    p["out"] = L.init_dense(init, r, d, cfg)
    return p


def _rglru_coeffs(p, xr):
    """xr: (...,r) conv output -> log_a, b (both float32)."""
    x32 = xr.float()
    a_gate = torch.sigmoid(L.dense(p["w_a"], x32, dtype=torch.float32))
    i_gate = torch.sigmoid(L.dense(p["w_i"], x32, dtype=torch.float32))
    log_a = -_RGLRU_C * F.softplus(p["lam"].float()) * a_gate
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = beta * (i_gate * x32)
    return log_a, b


def rglru_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_cache: bool = False):
    """Training / prefill pass.  x: (B,S,d) -> y, and with
    ``return_cache`` (y, the decode cache): the last state h (float32)
    and the conv buffer, ``in_x`` of the last W-1 inputs, left-padded
    with zeros when the prompt is shorter."""
    gate = L.gelu(L.dense(p["in_gate"], x))
    pre = L.dense(p["in_x"], x)
    xr = causal_conv(p["conv"], pre)
    log_a, b = _rglru_coeffs(p, xr)
    h = ops.rglru_scan(log_a, b)
    y = L.dense(p["out"], h.to(x.dtype) * gate)
    if not return_cache:
        return y
    # copies, not views: a view would keep the prompt-long h and in_x
    # alive for as long as the cache (3.3 GB over recurrentgemma-2b's
    # 18 RG-LRU layers at batch 4 x 3000)
    W = cfg.conv_width
    pre = pre[:, -(W - 1):].clone()
    pad = W - 1 - pre.shape[1]
    if pad:
        pre = F.pad(pre, (0, 0, pad, 0))
    return y, {"h": h[:, -1].clone(), "conv": pre}


def rglru_decode(p: Params, x: torch.Tensor, cache: Dict, cfg: ModelConfig):
    """x: (B,1,d) -> (y, new_cache); O(1) per step."""
    x1 = x[:, 0]
    gate = L.gelu(L.dense(p["in_gate"], x1))
    xr_raw = L.dense(p["in_x"], x1)
    xr, conv_buf = conv_decode(p["conv"], xr_raw, cache["conv"])
    log_a, b = _rglru_coeffs(p, xr)
    h = cache["h"] * torch.exp(log_a) + b
    y = L.dense(p["out"], h.to(x.dtype) * gate)
    return y[:, None], {"h": h, "conv": conv_buf}


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    return {"h": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_rnn),
                                dtype=cfg.compute_dtype, device=device)}
