"""Plain float32 reference of Whisper's encoder-decoder transformer
(Radford et al., arXiv:2212.04356), from its stub frame embeddings on.

Encoder: the frame embeddings (B, S_enc, d) plus the sinusoid table, then
per layer LayerNorm, bidirectional self-attention, a residual,
LayerNorm, a GELU MLP and a residual; a final LayerNorm.  Decoder: token
embeddings plus the sinusoid table (the configuration's positions), then
per layer LayerNorm, causal self-attention, a residual, LayerNorm,
attention over the encoder output, a residual, LayerNorm, the GELU MLP
and a residual; a final LayerNorm and logits against the tied embedding
table.  Every projection has a bias; heads are ``head_dim`` wide and the
scores are over sqrt(head_dim); the GELU is the tanh form.  The loss is
the mean cross entropy of the labels.

Each layer is recomputed in the backward (``torch.utils.checkpoint``).
"""
from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import common as C

SUPPORTED = {"family": "encdec", "act": "gelu", "norm": "layernorm",
             "pos_kind": "sincos", "use_bias": True, "tie_embeddings": True,
             "mla": False, "moe": False, "window": 0, "logit_softcap": 0.0,
             "attn_softcap": 0.0, "parallel_block": False,
             "scale_embed": False}


def check(run: Dict) -> None:
    bad = {k: run.get(k) for k, v in SUPPORTED.items() if run.get(k) != v}
    if bad:
        raise NotImplementedError(f"encdec reference: {bad}")


def _attn_leaves(prefix, d, inner):
    out = []
    for name, (a, b) in (("wq", (d, inner)), ("wk", (d, inner)),
                         ("wv", (d, inner)), ("wo", (inner, d))):
        out += C.dense_leaves(prefix + (name,), a, b, True)
    return out


def _mlp_leaves(prefix, d, f):
    return (C.dense_leaves(prefix + ("up",), d, f, True)
            + C.dense_leaves(prefix + ("down",), f, d, True))


def leaves(run: Dict) -> List[C.Leaf]:
    check(run)
    d, f = run["d_model"], run["d_ff"]
    inner = run["n_heads"] * run["head_dim"]
    out = [(("embed", "table"), (run["vocab_size"], d), ("normal", 0.02))]
    out += C.norm_leaves(("final_norm",), d, True)
    for i in range(run["n_layers"]):
        p = ("layers", i)
        out += C.norm_leaves(p + ("ln1",), d, True)
        out += _attn_leaves(p + ("attn",), d, inner)
        out += C.norm_leaves(p + ("ln_x",), d, True)
        out += _attn_leaves(p + ("cross",), d, inner)
        out += C.norm_leaves(p + ("ln2",), d, True)
        out += _mlp_leaves(p + ("ffn",), d, f)
    for i in range(run["encoder_layers"]):
        p = ("encoder", "layers", i)
        out += C.norm_leaves(p + ("ln1",), d, True)
        out += _attn_leaves(p + ("attn",), d, inner)
        out += C.norm_leaves(p + ("ln2",), d, True)
        out += _mlp_leaves(p + ("ffn",), d, f)
    out += C.norm_leaves(("encoder", "norm"), d, True)
    return out


def _attend(p, x, src, run, causal, prec):
    B, S, _ = x.shape
    H, hd = run["n_heads"], run["head_dim"]
    q = C.linear(x, p["wq"], prec).reshape(B, S, H, hd)
    k = C.linear(src, p["wk"], prec).reshape(B, src.shape[1], H, hd)
    v = C.linear(src, p["wv"], prec).reshape(B, src.shape[1], H, hd)
    a = C.attention(q, k, v, causal=causal, prec=prec).reshape(B, S, H * hd)
    return C.linear(a, p["wo"], prec)


def _mlp(p, x, prec):
    return C.linear(C.gelu_tanh(C.linear(x, p["up"], prec)), p["down"], prec)


def encoder_layer(p, x, run, prec):
    eps = run["norm_eps"]
    h = C.layer_norm(x, p["ln1"], eps)
    x = x + _attend(p["attn"], h, h, run, False, prec)
    return x + _mlp(p["ffn"], C.layer_norm(x, p["ln2"], eps), prec)


def decoder_layer(p, x, enc, run, prec):
    eps = run["norm_eps"]
    h = C.layer_norm(x, p["ln1"], eps)
    x = x + _attend(p["attn"], h, h, run, True, prec)
    x = x + _attend(p["cross"], C.layer_norm(x, p["ln_x"], eps), enc, run,
                    False, prec)
    return x + _mlp(p["ffn"], C.layer_norm(x, p["ln2"], eps), prec)


def loss(tree: Dict, batch: Dict[str, torch.Tensor], run: Dict,
         prec: str = "f32") -> torch.Tensor:
    """Mean cross entropy of ``batch["labels"]``; batch {"tokens",
    "labels"} (B,S) and "frames" (B,S_enc,d)."""
    d = run["d_model"]
    frames = batch["frames"].float()
    x = frames + C.sinusoids(frames.shape[1], d, frames.device)
    for p in tree["encoder"]["layers"]:
        x = checkpoint(encoder_layer, p, x, run, prec, use_reentrant=False)
    enc = C.layer_norm(x, tree["encoder"]["norm"], run["norm_eps"])

    table = tree["embed"]["table"]
    tokens = batch["tokens"].long()
    x = table[tokens] + C.sinusoids(tokens.shape[1], d, tokens.device)
    for p in tree["layers"]:
        x = checkpoint(decoder_layer, p, x, enc, run, prec, use_reentrant=False)
    x = C.layer_norm(x, tree["final_norm"], run["norm_eps"])
    return C.cross_entropy(C.mm(x, table.t(), prec), batch["labels"])
