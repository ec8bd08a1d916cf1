"""Plain float32 reference of a decoder-only transformer whose every FFN
is a mixture of experts (IBM's Granite 3.0 MoE layout): token embedding,
then per layer RMSNorm, causal self-attention with grouped key/value
heads and rotary positions, a residual, RMSNorm, the expert FFN and a
residual; a final RMSNorm and logits against the tied embedding table.

The expert FFN routes each token to its ``top_k`` most probable experts
(softmax over the router's logits, the chosen probabilities
renormalised to sum to one) and runs each expert as a SwiGLU MLP.
Routing is per sequence with a capacity, as the configuration's
``capacity_factor`` states: each expert takes at most C = ceil(S·k/E·cf)
(at least 8, at most S) of a sequence's (token, choice) pairs, the pairs
counted token by token and, within a token, choice by choice; a pair past
its expert's capacity adds nothing.  The loss is the mean cross entropy
plus ``router_aux_weight`` times the sum over layers of the Switch
load-balance term E·Σ_e f_e·p_e (f_e the share of a sequence's choices
that went to e, p_e its mean router probability), averaged over the
batch.

Each layer is recomputed in the backward (``torch.utils.checkpoint``) so
that the reference fits beside nothing else on one card.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference import common as C

SUPPORTED = {"family": "moe", "act": "swiglu", "norm": "rmsnorm",
             "pos_kind": "rope", "mla": False, "window": 0,
             "logit_softcap": 0.0, "attn_softcap": 0.0,
             "parallel_block": False, "n_shared_experts": 0,
             "first_dense_layers": 0, "use_bias": False,
             "tie_embeddings": True, "scale_embed": False}


def check(run: Dict) -> None:
    bad = {k: run.get(k) for k, v in SUPPORTED.items() if run.get(k) != v}
    if bad:
        raise NotImplementedError(f"moe_decoder reference: {bad}")


def leaves(run: Dict) -> List[C.Leaf]:
    check(run)
    d, hd = run["d_model"], run["head_dim"]
    H, K, E, f = run["n_heads"], run["n_kv_heads"], run["n_experts"], \
        run["d_ff_expert"]
    out = [(("embed", "table"), (run["vocab_size"], d), ("normal", 0.02))]
    out += C.norm_leaves(("final_norm",), d, False)
    for i in range(run["n_layers"]):
        p = ("layers", i)
        out += C.norm_leaves(p + ("ln1",), d, False)
        out += C.dense_leaves(p + ("attn", "wq"), d, H * hd, False)
        out += C.dense_leaves(p + ("attn", "wk"), d, K * hd, False)
        out += C.dense_leaves(p + ("attn", "wv"), d, K * hd, False)
        out += C.dense_leaves(p + ("attn", "wo"), H * hd, d, False)
        out += C.norm_leaves(p + ("ln2",), d, False)
        out += C.dense_leaves(p + ("ffn", "router"), d, E, False)
        out += [(p + ("ffn", "gate"), (E, d, f), ("normal", d ** -0.5)),
                (p + ("ffn", "up"), (E, d, f), ("normal", d ** -0.5)),
                (p + ("ffn", "down"), (E, f, d), ("normal", f ** -0.5))]
    return out


def capacity(S: int, run: Dict) -> int:
    c = math.ceil(S * run["top_k"] / run["n_experts"] * run["capacity_factor"])
    return max(8, min(S, c))


def experts(p: Dict, x: torch.Tensor, run: Dict, prec: str):
    """The expert FFN of x (B,S,d) -> (y, load-balance term)."""
    B, S, d = x.shape
    E, k = run["n_experts"], run["top_k"]
    probs = torch.softmax(C.mm(x, p["router"]["w"], prec), dim=-1)
    top, idx = torch.topk(probs, k, dim=-1)                     # (B,S,k)
    top = top / torch.clamp(top.sum(-1, keepdim=True), min=1e-9)
    chosen = F.one_hot(idx, E).float()                          # (B,S,k,E)
    aux = E * (chosen.sum(2).mean(1) * probs.mean(1)).sum(-1).mean()

    # a pair's place in its expert's queue within its sequence
    pairs = chosen.reshape(B, S * k, E)
    place = ((pairs.cumsum(1) * pairs).sum(-1) - 1).reshape(B, S, k)
    kept = place < capacity(S, run)
    y = torch.zeros(B * S, d, dtype=x.dtype, device=x.device)
    xf = x.reshape(B * S, d)
    token = torch.arange(B * S, device=x.device).reshape(B, S, 1).expand(B, S, k)
    for e in range(E):
        sel = (idx == e) & kept
        rows = token[sel]
        if rows.numel() == 0:
            continue
        h = xf[rows]
        g = C.mm(h, p["gate"][e], prec)
        u = C.mm(h, p["up"][e], prec)
        o = C.mm(F.silu(g) * u, p["down"][e], prec)
        y = y.index_add(0, rows, o * top[sel][:, None])
    return y.reshape(B, S, d), aux


def layer(p: Dict, x: torch.Tensor, run: Dict, prec: str):
    B, S, d = x.shape
    hd, H, K = run["head_dim"], run["n_heads"], run["n_kv_heads"]
    eps, theta = run["norm_eps"], run["rope_theta"]
    h = C.rms_norm(x, p["ln1"], eps)
    q = C.rotary(C.linear(h, p["attn"]["wq"], prec).reshape(B, S, H, hd), theta)
    kk = C.rotary(C.linear(h, p["attn"]["wk"], prec).reshape(B, S, K, hd), theta)
    v = C.linear(h, p["attn"]["wv"], prec).reshape(B, S, K, hd)
    a = C.attention(q, kk, v, causal=True, prec=prec).reshape(B, S, H * hd)
    x = x + C.linear(a, p["attn"]["wo"], prec)
    y, aux = experts(p["ffn"], C.rms_norm(x, p["ln2"], eps), run, prec)
    return x + y, aux


def loss(tree: Dict, batch: Dict[str, torch.Tensor], run: Dict,
         prec: str = "f32") -> torch.Tensor:
    """Mean cross entropy of ``batch["labels"]`` plus the weighted
    load-balance terms; batch {"tokens", "labels"} (B,S)."""
    table = tree["embed"]["table"]
    x = table[batch["tokens"].long()]
    aux = 0.0
    for p in tree["layers"]:
        x, a = checkpoint(layer, p, x, run, prec, use_reentrant=False)
        aux = aux + a
    x = C.rms_norm(x, tree["final_norm"], run["norm_eps"])
    logits = C.mm(x, table.t(), prec)
    return C.cross_entropy(logits, batch["labels"]) + run["router_aux_weight"] * aux
