"""Grouped-query attention, global and sliding-window: training, prefill
and decode.

The port's copy of the GQA part of the reference's
``models/attention.py``.  Training's and the prefill's self-attention go
through ``ops.flash_attention`` — the hand-written CUDA kernels forward
and backward on the card, the dense oracle and its plain gradient on the
CPU — which computes what the reference's chunked
``multihead_attention`` computes when positions are ``arange(S)``, as
they always are there; its scores are float32 inside the kernel
whatever the compute dtype.  Decode is plain torch, as the reference's is
XLA: one query against the whole cache, float32 scores.  MLA and
cross-attention are not ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig

Params = Dict[str, torch.Tensor]

NEG_INF = -2.0 ** 30  # safe for f32/bf16 masks (avoid actual -inf NaN paths)


# ==========================================================================
# parameter init
# ==========================================================================
def init_attention(init: L.Init, cfg: ModelConfig) -> Params:
    hd = cfg.hd
    return {
        "wq": L.init_dense(init, cfg.d_model, cfg.n_heads * hd, cfg),
        "wk": L.init_dense(init, cfg.d_model, cfg.n_kv_heads * hd, cfg),
        "wv": L.init_dense(init, cfg.d_model, cfg.n_kv_heads * hd, cfg),
        "wo": L.init_dense(init, cfg.n_heads * hd, cfg.d_model, cfg),
    }


# ==========================================================================
# prefill
# ==========================================================================
def dense3(p: Params, x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    y = L.dense(p, x)
    return y.reshape(*x.shape[:-1], heads, hd)


def attn_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, window: int = 0,
                 return_kv: bool = False):
    """Causal self-attention over a whole sequence (training / prefill).
    x: (B,S,d); positions: (S,) = arange(S), which is what the kernel
    assumes (its query and key positions count from 0).  Returns y, and
    with ``return_kv`` (y, {"k", "v"}), the keys and values the decode
    cache is built from."""
    hd = cfg.hd
    q = dense3(p["wq"], x, cfg.n_heads, hd)
    k = dense3(p["wk"], x, cfg.n_kv_heads, hd)
    v = dense3(p["wv"], x, cfg.n_kv_heads, hd)
    if cfg.pos_kind == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, window=window,
                              softcap=cfg.attn_softcap)
    y = L.dense(p["wo"], out.reshape(*x.shape[:-1], -1))
    if return_kv:
        return y, {"k": k, "v": v}
    return y


# ==========================================================================
# decode
# ==========================================================================
def init_cache_attn(cfg: ModelConfig, batch: int, cache_len: int, *,
                    window: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache entry for one attention layer: a ring of
    min(cache_len, window) slots when a window is set."""
    S = min(cache_len, window) if window else cache_len
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


def decode_attend(q, k, v, q_pos, kv_pos, *, scale, softcap=0.0,
                  window: int = 0):
    """One-token attention over the whole cache.

    q: (B,H,D); k,v: (B,S,K,D); kv_pos: (B,S) absolute positions (< 0 or
    > q_pos entries are masked) -> (B,H,Dv) float32.  Scores, max and
    denominator are float32 and the weighted sum is in v's dtype, as in
    the reference's single-chunk ``decode_attend_chunk`` +
    ``combine_decode``, whose merge does no work on one chunk.
    """
    B, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * scale
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window:
        valid &= (q_pos[:, None] - kv_pos) < window
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.exp(s - s.amax(dim=-1, keepdim=True))
    den = w.sum(dim=-1, keepdim=True)
    num = torch.einsum("bkgs,bskd->bkgd", w.to(v.dtype), v)
    return (num.float() / torch.clamp(den, min=1e-37)).reshape(B, H, -1)


def attn_decode(p: Params, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                pos: torch.Tensor, cfg: ModelConfig, *, window: int = 0):
    """Single-token decode.  x: (B,1,d); pos: (B,) absolute position.
    Returns (y (B,1,d), new_cache).  The new row is written into the
    cache's own tensors (the reference returns new arrays): a serving
    cache is owned by its decode loop, and this saves a copy of every
    attention layer's cache a step."""
    hd = cfg.hd
    B = x.shape[0]
    q = dense3(p["wq"], x, cfg.n_heads, hd)[:, 0]              # (B,H,D)
    k1 = dense3(p["wk"], x, cfg.n_kv_heads, hd)[:, 0]
    v1 = dense3(p["wv"], x, cfg.n_kv_heads, hd)[:, 0]
    if cfg.pos_kind == "rope":
        q = L.apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k1 = L.apply_rope(k1[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    S = cache["k"].shape[1]
    slot = (pos % S) if window else pos                        # ring buffer
    k = _cache_insert(cache["k"], k1, slot)
    v = _cache_insert(cache["v"], v1, slot)
    kv_pos = _cache_positions(pos, S, window)
    out = decode_attend(q, k, v, pos, kv_pos, scale=1.0 / math.sqrt(hd),
                        softcap=cfg.attn_softcap, window=window).to(x.dtype)
    y = L.dense(p["wo"], out.reshape(B, 1, -1)[:, 0])[:, None]
    return y, {"k": k, "v": v}


def _cache_insert(buf: torch.Tensor, new: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """Write per-batch row ``new`` at per-batch index ``slot``, in place."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, slot] = new.to(buf.dtype)
    return buf


def _cache_positions(pos: torch.Tensor, S: int, window: int) -> torch.Tensor:
    """Absolute position of every cache slot; -1 marks unwritten slots."""
    idx = torch.arange(S, device=pos.device)[None, :]         # (1,S)
    if window:
        # slot s holds the most recent position p with p % S == s, p <= pos
        cur = pos[:, None]
        cand = cur - ((cur % S) - idx) % S
        return torch.where(cand >= 0, cand, -1)
    return torch.where(idx <= pos[:, None], idx, -1)
