"""Attention: grouped-query (global and sliding-window), cross-attention
and MLA, for training, prefill and decode.

The port's copy of the reference's ``models/attention.py``.  Training's
and the prefill's attention — causal self-attention, the encoder's
non-causal self-attention and the decoder's cross-attention over the
encoder output — go through ``ops.flash_attention``: the hand-written
CUDA kernels forward and backward on the card, the dense oracle and its
plain gradient on the CPU.  It computes what the reference's chunked
``multihead_attention`` computes when query and key positions are
``arange(Sq)`` and ``arange(Skv)``, as they always are there (the
encoder's frames and a prompt both count from 0; cross-attention masks
nothing); its scores are float32 inside the kernel whatever the compute
dtype.  A sequence-parallel step (``models/model.py``) splits the two
halves, ``qkv`` on each rank's shard of the sequence and ``attend`` of
those queries over the gathered keys and values, the kernel told where
the shard starts (``q_offset``): the rows of the reference's
partitioned attention that the shard holds.  Decode is plain torch, as
the reference's is XLA: one query against the whole cache (against
every encoder position for cross-attention), float32 scores; over a
cache sharded on its sequence, each rank attends its chunk
(``decode_attend_chunk``) and the chunks are combined across the ranks
(a ``Chunk``'s ``combine``), as the reference's ``combine_decode``
merges them.

MLA (DeepSeek): prefill and training use the expanded form, whose query
and key heads (``qk_nope_dim + qk_rope_dim`` wide) and value heads
(``v_head_dim``) the kernel takes zero-padded to one of its head dims,
with the scale of the unpadded width (zero columns add nothing to a dot
product); decode uses the absorbed form, whose cache is the compressed
latent (``kv_lora_rank`` + ``qk_rope_dim`` floats a token).  A
cross-attention layer is plain GQA whatever ``cfg.mla`` says, as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import kernel_head_dim
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig

Params = Dict[str, torch.Tensor]

NEG_INF = -2.0 ** 30  # safe for f32/bf16 masks (avoid actual -inf NaN paths)


# ==========================================================================
# parameter init
# ==========================================================================
def init_attention(init: L.Init, cfg: ModelConfig, *,
                   cross: bool = False) -> Params:
    """Projections of one attention layer; ``cross`` (an encoder-decoder
    layer's cross-attention) is plain GQA even in an MLA config."""
    if cfg.mla and not cross:
        return _init_mla(init, cfg)
    hd = cfg.hd
    return {
        "wq": L.init_dense(init, cfg.d_model, cfg.n_heads * hd, cfg),
        "wk": L.init_dense(init, cfg.d_model, cfg.n_kv_heads * hd, cfg),
        "wv": L.init_dense(init, cfg.d_model, cfg.n_kv_heads * hd, cfg),
        "wo": L.init_dense(init, cfg.n_heads * hd, cfg.d_model, cfg),
    }


def _init_mla(init: L.Init, cfg: ModelConfig) -> Params:
    H, R, d = cfg.n_heads, cfg.kv_lora_rank, cfg.d_model
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "wq": L.init_dense(init, d, H * qd, cfg),
        "w_dkv": L.init_dense(init, d, R, cfg),
        "w_kr": L.init_dense(init, d, cfg.qk_rope_dim, cfg),
        "w_uk": L.init_dense(init, R, H * cfg.qk_nope_dim, cfg),
        "w_uv": L.init_dense(init, R, H * cfg.v_head_dim, cfg),
        "wo": L.init_dense(init, H * cfg.v_head_dim, d, cfg),
    }


# ==========================================================================
# prefill
# ==========================================================================
def dense3(p: Params, x: torch.Tensor, heads: int, hd: int) -> torch.Tensor:
    y = L.dense(p, x)
    return y.reshape(*x.shape[:-1], heads, hd)


def attn_forward(p: Params, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig, *, causal: bool = True, window: int = 0,
                 kv_source: Optional[torch.Tensor] = None,
                 return_kv: bool = False):
    """Attention over a whole sequence (training / prefill).  x: (B,S,d);
    positions: (S,) = arange(S), which is what the kernel assumes (its
    query and key positions count from 0).  ``causal=False`` is the
    encoder's self-attention.  ``kv_source`` (B,Skv,d), the encoder
    output, makes it cross-attention: keys and values projected from it
    with no RoPE, never causal.  Returns y, and with ``return_kv`` (y,
    {"k", "v"}), the keys and values the decode cache is built from
    ({"ckv", "kr"} for MLA)."""
    cross = kv_source is not None
    q, k, v, latent = qkv(p, x, positions, cfg, kv_source=kv_source)
    y = attend(p, q, k, v, cfg, causal=causal and not cross, window=window,
               cross=cross)
    if return_kv:
        return y, (latent if latent else {"k": k, "v": v})
    return y


def qkv(p: Params, x: torch.Tensor, positions: torch.Tensor,
        cfg: ModelConfig, *, kv_source: Optional[torch.Tensor] = None):
    """Attention's projections of x (B,S,d) at ``positions`` (S,) ->
    (q (B,S,H,Dqk), k, v (B,Skv,heads,Dqk / Dv), latent): RoPE'd as
    ``attn_forward`` takes them, keys and values from ``kv_source`` when
    given (cross-attention, no RoPE); MLA's expanded heads unpadded, its
    ``latent`` {"ckv", "kr"} the decode cache's rows, {} otherwise."""
    if cfg.mla and kv_source is None:
        return _mla_qkv(p, x, positions, cfg)
    hd = cfg.hd
    src = x if kv_source is None else kv_source
    q = dense3(p["wq"], x, cfg.n_heads, hd)
    k = dense3(p["wk"], src, cfg.n_kv_heads, hd)
    v = dense3(p["wv"], src, cfg.n_kv_heads, hd)
    if kv_source is None and cfg.pos_kind == "rope":
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v, {}


def attend(p: Params, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, *, causal: bool = True, window: int = 0,
           q_offset: int = 0, cross: bool = False) -> torch.Tensor:
    """``qkv``'s queries (B,Sq,...) over its keys and values through the
    flash kernel, query row i at position ``q_offset`` + i, and the
    output projection -> y (B,Sq,d); ``cross``: plain GQA in an MLA
    config."""
    at = {"q_offset": q_offset} if q_offset else {}
    if cfg.mla and not cross:
        return _mla_attend(p, q, k, v, cfg, **at)
    out = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=cfg.attn_softcap, **at)
    return L.dense(p["wo"], out.reshape(*q.shape[:-2], -1))


# ==========================================================================
# decode
# ==========================================================================
def init_cache_attn(cfg: ModelConfig, batch: int, cache_len: int, *,
                    window: int = 0, device=None) -> Dict[str, torch.Tensor]:
    """Zeroed KV cache entry for one attention layer: a ring of
    min(cache_len, window) slots when a window is set; for MLA the latent
    ``ckv`` (B,S,kv_lora_rank) and the shared rope key ``kr``
    (B,S,qk_rope_dim)."""
    S = min(cache_len, window) if window else cache_len
    dt = cfg.compute_dtype
    if cfg.mla:
        return {"ckv": torch.zeros((batch, S, cfg.kv_lora_rank), dtype=dt,
                                   device=device),
                "kr": torch.zeros((batch, S, cfg.qk_rope_dim), dtype=dt,
                                  device=device)}
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.compute_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.compute_dtype, device=device)}


@dataclasses.dataclass(frozen=True)
class Chunk:
    """A rank's chunk of a decode cache whose sequence (slot) dim is
    sharded: its first slot ``offset``, the whole cache's ``total``
    slots, and ``combine(num, mx, den)``, which merges the chunk's
    ``decode_attend_chunk`` stats with every other chunk's into the
    float32 attention output (``combine_decode`` across the ranks)."""
    offset: int
    total: int
    combine: Callable


def decode_attend_chunk(q, k, v, q_pos, kv_pos, *, scale, softcap=0.0,
                        window: int = 0):
    """One-token attention over a chunk of the cache, as combinable
    stats: the reference's ``decode_attend_chunk``.  q: (B,H,D); k, v:
    (B,S,K,D); kv_pos: (B,S) absolute positions (< 0 or > q_pos entries
    are masked) -> (num (B,H,Dv) in v's dtype, mx (B,H), den (B,H)
    float32)."""
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
    mx = s.amax(dim=-1)
    w = torch.exp(s - mx[..., None])
    num = torch.einsum("bkgs,bskd->bkgd", w.to(v.dtype), v)
    return num.reshape(B, H, -1), mx.reshape(B, H), w.sum(-1).reshape(B, H)


def combine_decode(parts):
    """Per-chunk (num, mx, den) stats -> the (B,H,Dv) float32 output:
    the reference's ``combine_decode``."""
    mx = torch.stack([m for _, m, _ in parts]).amax(0)
    num, den = 0.0, 0.0
    for n, m, d in parts:
        c = torch.exp(m - mx)
        num = num + n.float() * c[..., None]
        den = den + d * c
    return num / torch.clamp(den, min=1e-37)[..., None]


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
    attention layer's cache a step.  Three steps, which a step over a
    cache sharded on its slots runs as three regions: ``decode_rows``,
    ``decode_cache`` and ``decode_out``."""
    queries, rows = decode_rows(p, x, pos, cfg)
    out, new = decode_cache(queries, rows, cache, pos, cfg, window=window)
    return decode_out(p, out.to(x.dtype), cfg), new


def decode_rows(p: Params, x: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig):
    """A decode step's projections of x (B,1,d) at ``pos`` -> (queries,
    the cache's new rows): ((q (B,H,D),), {"k", "v"} (B,K,D)), RoPE'd;
    MLA's absorbed ((q_lat (B,H,R), q_rope (B,H,rope)), {"ckv", "kr"})."""
    if cfg.mla:
        return _mla_rows(p, x, pos, cfg)
    hd = cfg.hd
    q = dense3(p["wq"], x, cfg.n_heads, hd)[:, 0]              # (B,H,D)
    k1 = dense3(p["wk"], x, cfg.n_kv_heads, hd)[:, 0]
    v1 = dense3(p["wv"], x, cfg.n_kv_heads, hd)[:, 0]
    if cfg.pos_kind == "rope":
        q = L.apply_rope(q[:, None], pos[:, None], cfg.rope_theta)[:, 0]
        k1 = L.apply_rope(k1[:, None], pos[:, None], cfg.rope_theta)[:, 0]
    return (q,), {"k": k1, "v": v1}


def decode_cache(queries, rows, cache: Dict[str, torch.Tensor],
                 pos: torch.Tensor, cfg: ModelConfig, *, window: int = 0,
                 chunk: Optional[Chunk] = None):
    """``decode_rows``' rows written into the cache at ``pos``'s slot
    (a ring's for a window) and its queries attended over the cache ->
    (out (B,H,Dv) float32, MLA's (B,H,R) latent in the cache's dtype;
    the new cache).  With ``chunk`` the cache is this rank's chunk of the
    slots: a row is written only where its slot falls in the chunk, and
    the chunk's attention is combined with the other ranks' (``Chunk``).
    """
    if cfg.mla:
        return _mla_cache(queries, rows, cache, pos, cfg, chunk)
    (q,) = queries
    S = cache["k"].shape[1] if chunk is None else chunk.total
    slot = (pos % S) if window else pos                        # ring buffer
    scale = 1.0 / math.sqrt(cfg.hd)
    if chunk is None:
        k = _cache_insert(cache["k"], rows["k"], slot)
        v = _cache_insert(cache["v"], rows["v"], slot)
        kv_pos = _cache_positions(pos, S, window)
        out = decode_attend(q, k, v, pos, kv_pos, scale=scale,
                            softcap=cfg.attn_softcap, window=window)
    else:
        k = _chunk_insert(cache["k"], rows["k"], slot - chunk.offset)
        v = _chunk_insert(cache["v"], rows["v"], slot - chunk.offset)
        kv_pos = _cache_positions(pos, S, window, chunk.offset, k.shape[1])
        out = chunk.combine(*decode_attend_chunk(
            q, k, v, pos, kv_pos, scale=scale, softcap=cfg.attn_softcap,
            window=window))
    return out, {"k": k, "v": v}


def decode_out(p: Params, out: torch.Tensor, cfg: ModelConfig
               ) -> torch.Tensor:
    """``decode_cache``'s output (B,H,Dv) in the compute dtype (MLA's
    latent (B,H,R), expanded by W_uv) through the output projection ->
    y (B,1,d)."""
    B = out.shape[0]
    if cfg.mla:
        H, R = cfg.n_heads, cfg.kv_lora_rank
        w_uv = p["w_uv"]["w"].reshape(R, H, cfg.v_head_dim).to(out.dtype)
        out = torch.einsum("bhr,rhd->bhd", out, w_uv)
    return L.dense(p["wo"], out.reshape(B, 1, -1)[:, 0])[:, None]


def cross_decode(p: Params, x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One decode step's cross-attention: x (B,1,d) against the encoder's
    keys and values ck, cv (B,S_enc,K,D) from the cache, every encoder
    position visible (the reference's query position 1 << 30) -> (B,1,d).
    The cache is read, never written."""
    B, S_enc = x.shape[0], ck.shape[1]
    q = dense3(p["wq"], x, cfg.n_heads, cfg.hd)[:, 0]
    kv_pos = torch.arange(S_enc, device=x.device).expand(B, S_enc)
    out = decode_attend(q, ck, cv, torch.full((B,), 1 << 30,
                                              device=x.device),
                        kv_pos, scale=1.0 / math.sqrt(cfg.hd)).to(x.dtype)
    return L.dense(p["wo"], out.reshape(B, -1))[:, None]


def _cache_insert(buf: torch.Tensor, new: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """Write per-batch row ``new`` at per-batch index ``slot``, in place."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    buf[rows, slot] = new.to(buf.dtype)
    return buf


def _chunk_insert(buf: torch.Tensor, new: torch.Tensor,
                  at: torch.Tensor) -> torch.Tensor:
    """Write per-batch row ``new`` at per-batch index ``at`` of this
    chunk of the slots, in place, where ``at`` falls in the chunk (the
    rank that owns the slot writes it; the others keep their rows)."""
    n = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    inside = ((at >= 0) & (at < n)).reshape(-1, *[1] * (new.dim() - 1))
    at = at.clamp(0, n - 1)
    buf[rows, at] = torch.where(inside, new.to(buf.dtype), buf[rows, at])
    return buf


def _cache_positions(pos: torch.Tensor, S: int, window: int, start: int = 0,
                     n: Optional[int] = None) -> torch.Tensor:
    """Absolute position of every cache slot (of slots start .. start + n
    - 1 when given: a chunk of the S); -1 marks unwritten slots."""
    idx = torch.arange(start, start + (S if n is None else n),
                       device=pos.device)[None, :]            # (1,n)
    if window:
        # slot s holds the most recent position p with p % S == s, p <= pos
        cur = pos[:, None]
        cand = cur - ((cur % S) - idx) % S
        return torch.where(cand >= 0, cand, -1)
    return torch.where(idx <= pos[:, None], idx, -1)


# ==========================================================================
# MLA
# ==========================================================================
def _mla_qkr(p, x, positions, cfg):
    q = dense3(p["wq"], x, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                 dim=-1)
    return q_nope, L.apply_rope(q_rope, positions, cfg.rope_theta)


def padded_head_dim(cfg: ModelConfig) -> int:
    """The kernel's head dim that MLA's query/key and value heads are
    zero-padded to: the smallest of ``HEAD_DIMS`` that holds both."""
    return kernel_head_dim(max(cfg.qk_nope_dim + cfg.qk_rope_dim,
                               cfg.v_head_dim))


def _mla_qkv(p, x, positions, cfg):
    """Expanded MLA's projections for training and prefill: every head's
    keys and values rebuilt from the latent, one rope key shared by all
    heads -> (q, k (B,S,H,qk_nope + qk_rope), v (B,S,H,v_head), {"ckv",
    "kr"})."""
    B, S, _ = x.shape
    H, rope = cfg.n_heads, cfg.qk_rope_dim
    q_nope, q_rope = _mla_qkr(p, x, positions, cfg)
    ckv = L.dense(p["w_dkv"], x)                               # (B,S,R)
    kr = L.dense(p["w_kr"], x).reshape(B, S, 1, rope)
    kr = L.apply_rope(kr, positions, cfg.rope_theta)           # shared head
    k_nope = L.dense(p["w_uk"], ckv).reshape(B, S, H, cfg.qk_nope_dim)
    v = L.dense(p["w_uv"], ckv).reshape(B, S, H, cfg.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr.expand(B, S, H, rope)], dim=-1)
    return q, k, v, {"ckv": ckv, "kr": kr[:, :, 0]}


def _mla_attend(p, q, k, v, cfg, **at):
    """Expanded MLA's attention: heads zero-padded to the kernel's width
    at the scale of their own, causal (``at``: the queries' ``q_offset``
    when not 0), and the output projection."""
    qd = q.shape[-1]
    Dp = padded_head_dim(cfg)
    out = ops.flash_attention(F.pad(q, (0, Dp - qd)), F.pad(k, (0, Dp - qd)),
                              F.pad(v, (0, Dp - cfg.v_head_dim)),
                              causal=True, scale=1.0 / math.sqrt(qd), **at)
    return L.dense(p["wo"],
                   out[..., :cfg.v_head_dim].reshape(*q.shape[:-2], -1))


def _mla_rows(p, x, pos, cfg):
    """Absorbed MLA decode's projections (``decode_rows``): W_uk folded
    into the query, q_lat[b,h,r] = sum_d q_nope[b,h,d] W_uk[r, h*d]; the
    new latent row and rope key."""
    H, R = cfg.n_heads, cfg.kv_lora_rank
    q_nope, q_rope = _mla_qkr(p, x, pos[:, None], cfg)        # (B,1,H,*)
    w_uk = p["w_uk"]["w"].reshape(R, H, cfg.qk_nope_dim).to(x.dtype)
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)
    ckv1 = L.dense(p["w_dkv"], x)[:, 0]                        # (B,R)
    kr1 = L.dense(p["w_kr"], x)                                # (B,1,rope)
    kr1 = L.apply_rope(kr1[:, :, None], pos[:, None],
                       cfg.rope_theta)[:, 0, 0]
    return (q_lat, q_rope[:, 0]), {"ckv": ckv1, "kr": kr1}


def _mla_cache(queries, rows, cache, pos, cfg, chunk: Optional[Chunk] = None):
    """Absorbed MLA decode over the cache (``decode_cache``): scores in
    the compressed latent space, the cache holding kv_lora_rank +
    qk_rope_dim floats a token, the new latent row written into the
    cache's own tensors -> (the attended latent (B,H,R) in the cache's
    dtype, the new cache)."""
    q_lat, q_rope = queries
    dt = q_lat.dtype
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if chunk is None:
        ckv = _cache_insert(cache["ckv"], rows["ckv"], pos)
        kr = _cache_insert(cache["kr"], rows["kr"], pos)
        kv_pos = _cache_positions(pos, ckv.shape[1], 0)
    else:
        ckv = _chunk_insert(cache["ckv"], rows["ckv"], pos - chunk.offset)
        kr = _chunk_insert(cache["kr"], rows["kr"], pos - chunk.offset)
        kv_pos = _cache_positions(pos, chunk.total, 0, chunk.offset,
                                  ckv.shape[1])
    s = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv.float())
         + torch.einsum("bhe,bse->bhs", q_rope.float(), kr.float())
         ) * scale
    valid = (kv_pos >= 0) & (kv_pos <= pos[:, None])
    s = torch.where(valid[:, None, :], s, NEG_INF)
    if chunk is None:
        prob = torch.softmax(s, dim=-1).to(dt)
        out_lat = torch.einsum("bhs,bsr->bhr", prob, ckv)      # (B,H,R)
    else:
        mx = s.amax(dim=-1)
        w = torch.exp(s - mx[..., None])
        num = torch.einsum("bhs,bsr->bhr", w.to(dt), ckv)
        out_lat = chunk.combine(num, mx, w.sum(-1)).to(dt)
    return out_lat, {"ckv": ckv, "kr": kr}
