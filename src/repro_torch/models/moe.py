"""Mixture-of-Experts FFN: top-k routing with per-sequence capacity.

The port's copy of the reference's ``models/moe.py``, with its layouts,
so that reference weights carry over untouched: ``router.w`` (d,E),
``gate`` / ``up`` (E,d,f), ``down`` (E,f,d), ``shared`` an MLP.

* Routing is per sequence: each (token, choice) pair takes the next slot
  of its expert in its own sequence, in s-major, k-minor order, and the
  pairs past an expert's capacity C = ceil(S·k/E·cf) (at least 8, at
  most S) are dropped.
* Dispatch writes the kept pairs into a buffer of E·B·C + 1 rows, expert
  major (the reference's is (B, E·C) a sequence: the same slots, ordered
  so that each expert's B·C rows are one matrix), whose last row is the
  drop slot, by row copies (``index_copy``): kept destinations are
  unique, so no atomic scatter-add is needed and the result does not
  depend on the order of writes (the drop slot's does, and it is never
  read).  The three expert products are batched matrix
  products over E on the expert weights as they are stored (the
  reference's einsums; it computes them outside any Pallas kernel); the
  combine gathers back with the drop slot reading zero.
* Decode (S == 1) is the reference's dense masked combine over all
  experts: one token a sequence reads every expert's weights either way,
  once a step (the tokens broadcast over E, never the weights copied).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.common import ModelConfig
from repro_torch.spans import span

Params = Dict[str, torch.Tensor]


def init_moe(init: L.Init, cfg: ModelConfig) -> Params:
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
    scale = 1.0 / math.sqrt(d)
    p = {
        "router": {"w": init.normal((d, E), scale)},
        "gate": init.normal((E, d, f), scale),
        "up": init.normal((E, d, f), scale),
        "down": init.normal((E, f, d), 1.0 / math.sqrt(f)),
    }
    if cfg.n_shared_experts:
        p["shared"] = L.init_mlp(init, d, cfg.n_shared_experts * f, cfg)
    return p


def _top_k(probs: torch.Tensor, k: int):
    """The router's choices: each token's k largest probabilities and
    their experts (B,S,k).  ``torch.topk`` promises no order among ties
    on the card, where ``jax.lax.top_k`` puts the lower index first; a
    check that holds one routed run against another replays a run's
    choices here."""
    return torch.topk(probs, k, dim=-1)


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(idx, n)`` as a comparison with ``arange(n)``: the same
    0/1 values, and ``torch.func.vmap`` maps it (``F.one_hot`` reads the
    largest index with ``.item()``, which a population's vmap refuses)."""
    return idx[..., None] == torch.arange(n, device=idx.device)


def _router(p: Params, x: torch.Tensor, cfg: ModelConfig):
    """-> (weights (B,S,k) in x's dtype, expert indices (B,S,k), the
    Switch load-balance loss, float32 scalar).  Logits in x's dtype,
    softmax in float32; the top k weights renormalised (floor 1e-9)."""
    logits = torch.matmul(x, L.cast_param(p["router"]["w"], x.dtype))
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = _top_k(probs, cfg.top_k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # load-balance loss, per sequence, then averaged over the batch
    E = cfg.n_experts
    onehot = _one_hot(idx, E).float()                           # (B,S,k,E)
    frac = onehot.sum(2).mean(1)                                # (B,E)
    pmean = probs.mean(1)                                       # (B,E)
    aux = E * (frac * pmean).sum(-1).mean()
    return w.to(x.dtype), idx, aux


def capacity(cfg: ModelConfig, seq: int) -> int:
    c = math.ceil(seq * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, min(seq, int(c)))


def slots(idx: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """Each (token, choice) pair's row of the dispatch buffer: idx (B,S,k)
    -> (B, S·k), s-major and k-minor; ``expert · cap + position`` where
    the pair's position among its expert's pairs in its sequence is below
    ``cap``, else the drop slot ``n_experts · cap``."""
    B = idx.shape[0]
    flat_e = idx.reshape(B, -1)                                 # (B,Sk)
    # the one-hot expert-major, (B,E,Sk), so that the running count is a
    # scan along the innermost axis (CUDA's scan along an outer axis of
    # (B,Sk,E) took over half of a prefill)
    experts = torch.arange(n_experts, device=idx.device)
    onehot = (flat_e[:, None, :] == experts[None, :, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=-1, dtype=torch.int32)
    pos = torch.gather(pos, 1, flat_e[:, None, :])[:, 0] - 1    # (B,Sk)
    return torch.where(pos < cap, flat_e * cap + pos, n_experts * cap)


def moe_forward(p: Params, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (y (B,S,d), aux loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    with span("moe.router"):
        w, idx, aux = _router(p, x, cfg)
    if S == 1:
        return _moe_decode(p, x, w, idx, cfg), aux

    with span("moe.dispatch"):
        C = capacity(cfg, S)
        dest = slots(idx, E, C)                                 # (B,Sk)
        # slot (b, e, pos) -> row (e, b, pos) of the expert-major buffer
        b = torch.arange(B, device=x.device)[:, None]
        n = E * B * C
        rows = torch.where(dest < E * C,
                           (dest // C) * (B * C) + b * C + dest % C,
                           n).reshape(-1)
        xk = torch.repeat_interleave(x, k, dim=1)               # (B,Sk,d)
        buf = x.new_zeros((n + 1, d)).index_copy(0, rows,
                                                 xk.reshape(-1, d))
        h = buf[:n].view(E, B * C, d)

    # expert MLPs (SwiGLU), batched over experts
    dt = x.dtype
    with span("moe.experts"):
        g = torch.bmm(h, L.cast_param(p["gate"], dt))
        u = torch.bmm(h, L.cast_param(p["up"], dt))
        o = torch.bmm(F.silu(g) * u, L.cast_param(p["down"], dt))  # (E,BC,d)

    # combine: gather back (the drop slot reads 0) and weight
    with span("moe.combine"):
        o = torch.cat([o.reshape(n, d), x.new_zeros((1, d))])
        gathered = o.index_select(0, rows).view(B, S * k, d)
        y = (gathered * w.reshape(B, S * k)[..., None]).reshape(
            B, S, k, d).sum(2)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, cfg)
    return y, aux


def _moe_decode(p: Params, x: torch.Tensor, w, idx, cfg: ModelConfig):
    """Dense masked combine for single-token steps (memory-bound)."""
    B, S, d = x.shape
    dt = x.dtype
    mask = (_one_hot(idx, cfg.n_experts).to(dt) * w[..., None]).sum(2)
    xs = x.reshape(1, B * S, d)                  # broadcast over experts
    g = torch.matmul(xs, L.cast_param(p["gate"], dt))           # (E,BS,f)
    u = torch.matmul(xs, L.cast_param(p["up"], dt))
    o = torch.bmm(F.silu(g) * u, L.cast_param(p["down"], dt))   # (E,BS,d)
    y = torch.einsum("ned,ne->nd", o.transpose(0, 1),
                     mask.reshape(B * S, -1)).reshape(B, S, d)
    if "shared" in p:
        y = y + L.mlp(p["shared"], x, cfg)
    return y
