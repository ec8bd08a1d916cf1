"""Shared primitive layers: norms, dense, RoPE, MLPs, embeddings, loss.

The port's copy of the reference's ``models/layers.py``.  Parameters are
plain nested dicts of tensors, laid out as in the reference so that
reference weights carry over unchanged (``models/convert.py``): a dense
weight is (d_in, d_out) and applies as ``x @ w``.  ``Init`` makes every
parameter from one seeded ``torch.Generator`` on the target device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.act_sharding import constrain
from repro_torch.spans import span

Params = Dict[str, torch.Tensor]


# --------------------------------------------------------------------------
# init helpers
# --------------------------------------------------------------------------
class Init:
    """Parameter factory: draws from one ``torch.Generator`` seeded with
    ``seed`` on ``device`` in float32 and stores each tensor in ``dtype``
    (a cast per tensor, so a bf16 model never holds a float32 copy of
    itself).  On the meta device it makes shapes only."""

    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = None
        if self.device.type != "meta":
            self.gen = torch.Generator(device=self.device)
            self.gen.manual_seed(seed)

    def normal(self, shape, std: float) -> torch.Tensor:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return t.mul_(std).to(self.dtype)

    def uniform(self, shape, lo: float, hi: float) -> torch.Tensor:
        """float32 uniform draws in [lo, hi), left in float32 for the caller
        to transform before it stores them."""
        t = torch.rand(shape, generator=self.gen, device=self.device,
                       dtype=torch.float32)
        return lo + (hi - lo) * t

    def ones(self, shape) -> torch.Tensor:
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, shape) -> torch.Tensor:
        return torch.zeros(shape, device=self.device, dtype=self.dtype)


def init_dense(init: Init, d_in: int, d_out: int, cfg, *,
               scale: Optional[float] = None,
               bias: Optional[bool] = None) -> Params:
    scale = 1.0 / math.sqrt(d_in) if scale is None else scale
    p = {"w": init.normal((d_in, d_out), scale)}
    if cfg.use_bias if bias is None else bias:
        p["b"] = init.zeros((d_out,))
    return p


def cast_param(w: torch.Tensor, dtype, device=None) -> torch.Tensor:
    """A parameter in ``dtype`` (on ``device`` when one is given): every
    cast of a float32 master to the compute dtype goes through here, and
    a real cast is the span ``cast``."""
    if w.dtype == dtype and device is None:
        return w
    with span("cast"):
        return w.to(device=device, dtype=dtype)


def dense(p: Params, x: torch.Tensor, dtype=None) -> torch.Tensor:
    """x (..., d_in) @ w (d_in, d_out) in ``dtype`` (x's by default)."""
    dtype = dtype or x.dtype
    y = torch.matmul(x, cast_param(p["w"], dtype))
    if "b" in p:
        y = y + cast_param(p["b"], dtype)
    return constrain(y)  # anchor to batch/seq sharding (no-op off-mesh)


def init_norm(init: Init, d: int, cfg, kind: Optional[str] = None) -> Params:
    kind = kind or cfg.norm
    p = {"scale": init.ones((d,))}
    if kind == "layernorm":
        p["bias"] = init.zeros((d,))
    return p


def apply_norm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm or LayerNorm (decided by presence of a bias), float32
    statistics.  RMSNorm multiplies by ``scale``, not ``1 + scale``."""
    dt = x.dtype
    x32 = x.float()
    if "bias" in p:  # LayerNorm
        mu = x32.mean(-1, keepdim=True)
        var = (x32 - mu).square().mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:            # RMSNorm
        ms = x32.square().mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(dt)


# --------------------------------------------------------------------------
# rotary position embedding
# --------------------------------------------------------------------------
def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of head_dim (not interleaved pairs)."""
    dim = x.shape[-1]
    freqs = rope_freqs(dim, theta, x.device)                  # (dim/2,)
    angles = positions[..., :, None].float() * freqs          # (..., S, dim/2)
    sin = torch.sin(angles)[..., :, None, :]                  # (..., S, 1, dim/2)
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def init_mlp(init: Init, d_model: int, d_ff: int, cfg) -> Params:
    if cfg.act in ("swiglu", "geglu"):
        return {
            "gate": init_dense(init, d_model, d_ff, cfg),
            "up": init_dense(init, d_model, d_ff, cfg),
            "down": init_dense(init, d_ff, d_model, cfg),
        }
    return {
        "up": init_dense(init, d_model, d_ff, cfg),
        "down": init_dense(init, d_ff, d_model, cfg),
    }


def mlp(p: Params, x: torch.Tensor, cfg) -> torch.Tensor:
    if "gate" in p:
        act = gelu if cfg.act == "geglu" else F.silu
        return dense(p["down"], act(dense(p["gate"], x)) * dense(p["up"], x))
    return dense(p["down"], gelu(dense(p["up"], x)))


# --------------------------------------------------------------------------
# embeddings
# --------------------------------------------------------------------------
def init_embedding(init: Init, vocab: int, d_model: int, cfg) -> Params:
    return {"table": init.normal((vocab, d_model), 0.02)}


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The rows of ``tokens`` in ``dtype``.  Gathered, then cast: the same
    values as a gather from the cast table, without a compute-dtype copy
    of a float32 table (2.6 GB at recurrentgemma-2b's width, per trial of
    a population), and its gradient accumulates in the table's dtype."""
    return F.embedding(tokens, p["table"]).to(dtype)


def cross_entropy_sums(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None):
    """(summed next-token cross entropy in float32, the count of the
    positions summed); labels < 0 are ignored (and positions where
    ``mask`` is not > 0)."""
    logits = logits.float()
    valid = labels >= 0
    if mask is not None:
        valid = valid & (mask > 0)
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    nll = (logz - gold) * valid
    return nll.sum(), valid.sum()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in float32 (``cross_entropy_sums``'
    sum over its count)."""
    nll, n = cross_entropy_sums(logits, labels, mask)
    return nll / torch.clamp(n, min=1)


def unembed(p: Params, x: torch.Tensor, *,
            softcap: float = 0.0) -> torch.Tensor:
    """Logits x @ tableᵀ in x's dtype, then cap·tanh(logits/cap)."""
    logits = torch.matmul(x, cast_param(p["table"], x.dtype).t())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
