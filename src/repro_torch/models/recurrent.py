"""Recurrent temporal-mixing blocks: RG-LRU (Griffin / RecurrentGemma)
and xLSTM's mLSTM / sLSTM cells.

The port's copy of the reference's ``models/recurrent.py``.

* RG-LRU: training and the prefill run the linear recurrence through
  ``ops.rglru_scan`` — the hand-written CUDA scan forward and backward on
  the card, sequential loops on the CPU — where the reference runs a
  parallel ``associative_scan`` (the same function); decode is the O(1)
  state update.
* mLSTM: the stabilized chunkwise-recurrent form (a parallel D-matrix
  inside a chunk of ``_MLSTM_CHUNK`` steps, the exact state carried
  across chunks), a Python loop over chunks where the reference runs
  ``lax.scan``; decode is the O(1) recurrent step.  Plain torch, float32
  inside: the reference has no Pallas kernel for it.
* sLSTM: a true hidden-to-hidden recurrence (block-diagonal per head), a
  Python loop over time steps as the reference's ``lax.scan`` over time;
  every step issues its own run of small launches on the card.

Deviations from the sources, as in the reference: RG-LRU gates are dense
rather than block-diagonal; sLSTM omits its causal conv.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig

Params = Dict[str, torch.Tensor]
_RGLRU_C = 8.0
_MLSTM_CHUNK = 256


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


# ==========================================================================
# mLSTM (xLSTM matrix memory) — stabilized chunkwise recurrent
# ==========================================================================
def init_mlstm_block(init: L.Init, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    di = cfg.d_rnn or 2 * d                 # inner width (pf=2)
    H = cfg.n_heads
    return {
        "up_m": L.init_dense(init, d, di, cfg),
        "up_g": L.init_dense(init, d, di, cfg),
        "conv": init_conv(init, cfg.conv_width, di, cfg),
        "wq": L.init_dense(init, di, di, cfg),
        "wk": L.init_dense(init, di, di, cfg),
        "wv": L.init_dense(init, di, di, cfg),
        "w_if": L.init_dense(init, di, 2 * H, cfg, bias=True),
        "skip": init.ones((di,)),
        "down": L.init_dense(init, di, d, cfg),
    }


def _mlstm_qkvif(p, x, cfg):
    """x (B,S,d) -> q, k, v (B,S,H,D) in x's dtype; the input and forget
    pre-activations i and log f (B,S,H) in float32; the output gate; the
    conv branch xc and the ``up_m`` projection xm (B,S,di)."""
    H = cfg.n_heads
    xm = L.dense(p["up_m"], x)
    gate = F.silu(L.dense(p["up_g"], x))
    xc = F.silu(causal_conv(p["conv"], xm))
    B, S = x.shape[:2]
    q = L.dense(p["wq"], xc).reshape(B, S, H, -1)
    k = L.dense(p["wk"], xc).reshape(B, S, H, -1)
    v = L.dense(p["wv"], xm).reshape(B, S, H, -1)
    i_f = L.dense(p["w_if"], xc.float(), dtype=torch.float32)
    i_t, f_t = i_f.chunk(2, dim=-1)                           # (B,S,H)
    log_f = F.logsigmoid(f_t + 1.0)
    return q, k, v, i_t, log_f, gate, xc, xm


def _mlstm_chunk(carry, inp, scale):
    """One chunk of stabilized chunkwise mLSTM.  All float32.
    carry: (C (B,H,D,D), n (B,H,D), m (B,H)); inp: q,k,v (B,L,H,D),
    i, log f (B,L,H) -> (the carry into the next chunk, h (B,L,H,D))."""
    C_in, n_in, m_in = carry
    q, k, v, i_t, lf = inp
    Lc = q.shape[1]
    cums = torch.cumsum(lf, dim=1)                             # (B,L,H)
    total = cums[:, -1]                                        # (B,H)
    # intra-chunk log weights D~[t,s] = cums_t - cums_s + i_s (s<=t)
    dt = cums[:, :, None] - cums[:, None, :, :] + i_t[:, None]  # (B,t,s,H)
    tri = torch.ones((Lc, Lc), dtype=torch.bool, device=q.device).tril()
    dt = dt.masked_fill(~tri[None, :, :, None], -math.inf)
    m_intra = dt.amax(dim=2)                                   # (B,t,H)
    m_t = torch.maximum(m_intra, m_in[:, None] + cums)         # (B,t,H)
    m_t = torch.clamp(m_t, min=-60.0)                          # floor
    w_intra = torch.exp(dt - m_t[:, :, None])                  # (B,t,s,H)
    w_inter = torch.exp(cums + m_in[:, None] - m_t)            # (B,t,H)

    qs = q * scale
    sw = torch.einsum("bthd,bshd->btsh", qs, k) * w_intra      # (B,t,s,H)
    num = (torch.einsum("btsh,bshd->bthd", sw, v)
           + torch.einsum("bthd,bhde->bthe", qs, C_in) * w_inter[..., None])
    den = sw.sum(dim=2) + torch.einsum("bthd,bhd->bth", qs, n_in) * w_inter
    h = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None]

    # state carry to the next chunk
    m_out = torch.maximum(m_in + total,
                          (total[:, None] - cums + i_t).amax(dim=1))
    m_out = torch.clamp(m_out, min=-60.0)
    w_st = torch.exp(total[:, None] - cums + i_t - m_out[:, None])  # (B,s,H)
    decay = torch.exp(m_in + total - m_out)                    # (B,H)
    C_out = (C_in * decay[..., None, None]
             + torch.einsum("bshd,bshe->bhde", k * w_st[..., None], v))
    n_out = n_in * decay[..., None] + torch.einsum("bshd,bsh->bhd", k, w_st)
    return (C_out, n_out, m_out), h


def mlstm_cell(q, k, v, i_t, log_f, state, chunk: int = _MLSTM_CHUNK):
    """Full-sequence stabilized mLSTM over chunks of ``chunk`` steps (the
    last one padded: padded steps get i = -1e9 and log f = 0, so they
    leave the state as it is) -> (h (B,S,H,D) float32, the final state
    (C, n, m)).  ``state`` None starts from C = 0, n = 0, m = -60.
    float32 inside, as the reference; float64 inputs stay float64."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    dt = torch.promote_types(q.dtype, torch.float32)
    q, k, v = q.to(dt), k.to(dt), v.to(dt)
    if state is None:
        state = (q.new_zeros((B, H, D, D)), q.new_zeros((B, H, D)),
                 q.new_full((B, H), -60.0))
    Lc = min(chunk, S)
    n_chunks = math.ceil(S / Lc)
    pad = n_chunks * Lc - S

    def pad_t(a, fill=0.0):
        return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad),
                     value=fill) if pad else a

    xs = (pad_t(q), pad_t(k), pad_t(v), pad_t(i_t, -1e9), pad_t(log_f, 0.0))
    hs = []
    for c in range(n_chunks):
        state, h = _mlstm_chunk(state, tuple(a[:, c * Lc:(c + 1) * Lc]
                                             for a in xs), scale)
        hs.append(h)
    return torch.cat(hs, dim=1)[:, :S], state


def mlstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_cache: bool = False):
    """Training / prefill pass.  x: (B,S,d) -> y, and with
    ``return_cache`` (y, the decode cache): the state C, n, m (float32)
    and the conv buffer, ``up_m`` of the last W-1 inputs (the conv's own
    inputs), left-padded with zeros when the prompt is shorter."""
    q, k, v, i_t, log_f, gate, xc, xm = _mlstm_qkvif(p, x, cfg)
    h, state = mlstm_cell(q, k, v, i_t, log_f, None)
    h = h.reshape(*x.shape[:2], -1).to(x.dtype)
    h = h + xc * p["skip"].to(x.dtype)
    y = L.dense(p["down"], h * gate)
    if not return_cache:
        return y
    W = cfg.conv_width
    xm = xm[:, -(W - 1):].clone()
    pad = W - 1 - xm.shape[1]
    if pad:
        xm = F.pad(xm, (0, 0, pad, 0))
    return y, {"C": state[0], "n": state[1], "m": state[2], "conv": xm}


def mlstm_decode(p: Params, x: torch.Tensor, cache: Dict, cfg: ModelConfig):
    """x: (B,1,d) -> (y, new_cache); the O(1) recurrent step (no floor on
    m, as in the reference)."""
    x1 = x[:, 0]
    H = cfg.n_heads
    xm = L.dense(p["up_m"], x1)
    gate = F.silu(L.dense(p["up_g"], x1))
    xc_raw, conv_buf = conv_decode(p["conv"], xm, cache["conv"])
    xc = F.silu(xc_raw)
    B = x1.shape[0]
    q = L.dense(p["wq"], xc).reshape(B, H, -1).float()
    k = L.dense(p["wk"], xc).reshape(B, H, -1).float()
    v = L.dense(p["wv"], xm).reshape(B, H, -1).float()
    i_f = L.dense(p["w_if"], xc.float(), dtype=torch.float32)
    i_t, f_t = i_f.chunk(2, dim=-1)
    log_f = F.logsigmoid(f_t + 1.0)
    D = q.shape[-1]
    C_in, n_in, m_in = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(log_f + m_in, i_t)
    fp = torch.exp(log_f + m_in - m_new)[..., None]
    ip = torch.exp(i_t - m_new)[..., None]
    C = (C_in * fp[..., None]
         + ip[..., None] * k[..., :, None] * v[..., None, :])
    n = n_in * fp + ip * k
    qs = q / math.sqrt(D)
    num = torch.einsum("bhd,bhde->bhe", qs, C)
    den = (qs * n).sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    h = h.reshape(B, -1).to(x.dtype) + xc * p["skip"].to(x.dtype)
    y = L.dense(p["down"], h * gate)
    return y[:, None], {"C": C, "n": n, "m": m_new, "conv": conv_buf}


def init_mlstm_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    di = cfg.d_rnn or 2 * cfg.d_model
    H = cfg.n_heads
    D = di // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, D, D), **f32),
            "n": torch.zeros((batch, H, D), **f32),
            "m": torch.full((batch, H), -60.0, **f32),
            "conv": torch.zeros((batch, cfg.conv_width - 1, di),
                                dtype=cfg.compute_dtype, device=device)}


# ==========================================================================
# sLSTM (xLSTM scalar memory; a true recurrence -> a loop over time)
# ==========================================================================
def init_slstm_block(init: L.Init, cfg: ModelConfig) -> Params:
    d = cfg.d_model
    H = cfg.n_heads
    dh = d // H
    ffd = max(1, int(math.ceil(4 * d / 3 / 64)) * 64)   # pf 4/3, rounded
    return {
        "w_in": L.init_dense(init, d, 4 * d, cfg, bias=True),
        # block-diagonal recurrence, per head: (4, H, dh, dh)
        "r": init.normal((4, H, dh, dh), 1.0 / math.sqrt(dh)),
        "gn": init.ones((d,)),
        "ffn": L.init_mlp(init, d, ffd, cfg),
        "ffn_norm": L.init_norm(init, d, cfg),
    }


def _slstm_step(p, cfg, carry, zx):
    """carry: (c, n, h, m) each (B,H,dh) float32; zx: the pre-activations
    (B,4d) of the gates i, f, z, o -> (the new carry, h)."""
    c, n, h, m = carry
    B = zx.shape[0]
    H = cfg.n_heads
    dh = c.shape[-1]
    rec = torch.einsum("bhd,ghde->gbhe", h, p["r"].float())    # (4,B,H,dh)
    z = zx.float().reshape(B, 4, H, dh)
    zi, zf, zz, zo = (z[:, g] + rec[g] for g in range(4))
    log_f = F.logsigmoid(zf)
    m_new = torch.maximum(log_f + m, zi)
    i_p = torch.exp(zi - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(zz)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(zo) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new), h_new


def _group_norm(scale, x, eps):
    """Per-head group norm over the last dim of x (B,S,H,dh), population
    variance; ``scale`` (``gn``) is applied by the caller afterwards."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, unbiased=False, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def _slstm_out(p, h, x, cfg):
    """The sLSTM's hidden states h (B,S,H,dh) -> its output: group norm,
    ``gn``, then the block's own FFN on a residual."""
    B, S, d = x.shape
    h = _group_norm(p["gn"], h, cfg.norm_eps).reshape(B, S, d)
    y = (h * p["gn"].float()).to(x.dtype)
    return y + L.mlp(p["ffn"], L.apply_norm(p["ffn_norm"], y, cfg.norm_eps),
                     cfg)


def slstm_forward(p: Params, x: torch.Tensor, cfg: ModelConfig,
                  return_cache: bool = False):
    """Training / prefill pass: one ``_slstm_step`` a time step.  x:
    (B,S,d) -> y, and with ``return_cache`` (y, the last carry c, n, h, m
    as the decode cache)."""
    B, S, d = x.shape
    zx = L.dense(p["w_in"], x)                                 # (B,S,4d)
    carry = init_slstm_cache(cfg, B, device=x.device)
    carry = tuple(carry[k] for k in ("c", "n", "h", "m"))
    step_p = dict(p, r=p["r"].float())     # cast once, not once a step
    hs = []
    for t in range(S):
        carry, h = _slstm_step(step_p, cfg, carry, zx[:, t])
        hs.append(h)
    y = _slstm_out(p, torch.stack(hs, dim=1), x, cfg)
    if return_cache:
        c, n, hh, m = carry
        return y, {"c": c, "n": n, "h": hh, "m": m}
    return y


def slstm_decode(p: Params, x: torch.Tensor, cache: Dict, cfg: ModelConfig):
    """x: (B,1,d) -> (y, new_cache); one ``_slstm_step``."""
    zx = L.dense(p["w_in"], x[:, 0])
    carry = (cache["c"], cache["n"], cache["h"], cache["m"])
    (c, n, hh, m), h = _slstm_step(p, cfg, carry, zx)
    y = _slstm_out(p, h[:, None], x, cfg)
    return y, {"c": c, "n": n, "h": hh, "m": m}


def init_slstm_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    H = cfg.n_heads
    dh = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, dh), **f32),
            "n": torch.zeros((batch, H, dh), **f32),
            "h": torch.zeros((batch, H, dh), **f32),
            "m": torch.full((batch, H, dh), -30.0, **f32)}
