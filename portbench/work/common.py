"""The yardstick's arithmetic: the card's peaks, the work of an attention
launch, and a training step's model FLOPs by family.

The peaks are one H100 SXM's, from NVIDIA's data sheet (dense, 700 W):
989e12 bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3.  The
attention formulas count the (query, key) pairs the mask lets through:
the forward takes 2·(D + Dv) operations a pair and a head (S = q·k and
P·v), the backward 2·(3·D + 2·Dv) (S again, dP, dV, dQ, dK); q, k, v
and o are read or written once, the backward also reading dO and the
row log-sum-exp and writing dq, dk, dv once.

A step's model FLOPs are 6 per parameter a position it acts on (forward
and backward), over every matrix it multiplies by, biases included and
the embedding lookup and the norms not, plus the attention pairs' three
forward-sized products (forward, and the backward's two of the same
size each for the query and value sides): 6·(D + Dv) a visible pair and
a head.  Recomputation is not model work and is not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

#: one attention launch: (batch, Sq, Skv, heads, kv heads, head dim,
#: causal)
Launch = Tuple[int, int, int, int, int, int, bool]


def visible_pairs(Sq: int, Skv: int, causal: bool) -> int:
    """(query, key) pairs of one sequence and head that the mask lets
    through, query i and key j both counted from 0."""
    if not causal:
        return Sq * Skv
    full = min(Sq, Skv)
    return full * (full + 1) // 2 + max(0, Sq - Skv) * Skv


def attn_fwd_work(B, Sq, Skv, H, K, D, causal, elem=2) -> Tuple[float, float]:
    flops = 2 * B * H * visible_pairs(Sq, Skv, causal) * (D + D)
    nbytes = elem * (2 * B * Sq * H * D + 2 * B * Skv * K * D)
    return flops, nbytes


def attn_bwd_work(B, Sq, Skv, H, K, D, causal, elem=2) -> Tuple[float, float]:
    flops = 2 * (3 * D + 2 * D) * B * H * visible_pairs(Sq, Skv, causal)
    nbytes = elem * 2 * (D + D) * (B * Sq * H + B * Skv * K) + 4 * B * H * Sq
    return flops, nbytes


def bound_s(work: Tuple[float, float]) -> float:
    """The least time a launch's (FLOPs, bytes) need on the card."""
    return max(work[0] / PEAK_BF16_FLOPS, work[1] / PEAK_BYTES)


def step_bounds(launches: List[Launch]) -> Dict[str, float]:
    """The least time of one step's attention forward and backward, each
    launch bounded on its own, each layer's launch counted once."""
    return {"attn_fwd": sum(bound_s(attn_fwd_work(*l)) for l in launches),
            "attn_bwd": sum(bound_s(attn_bwd_work(*l)) for l in launches)}


def _attn_params(run: Dict, kv_heads: int) -> int:
    d, hd = run["d_model"], run["head_dim"]
    return 2 * d * run["n_heads"] * hd + 2 * d * kv_heads * hd


def moe_decoder(run: Dict, seqs: int, S: int) -> Dict:
    """``seqs`` sequences of S tokens through a decoder whose FFNs are
    all experts (top-k of them active a token)."""
    d, L = run["d_model"], run["n_layers"]
    H, K, hd = run["n_heads"], run["n_kv_heads"], run["head_dim"]
    layer = (_attn_params(run, K) + d * run["n_experts"]
             + run["top_k"] * 3 * d * run["d_ff_expert"])
    active = L * layer + run["vocab_size"] * d
    tokens = seqs * S
    pairs = L * seqs * H * visible_pairs(S, S, True)
    launches = [(seqs, S, S, H, K, hd, True)] * L
    return {"model_flops": 6 * active * tokens + 6 * 2 * hd * pairs,
            "params_active": active, "launches": launches,
            "split": {"decoder": 6 * active * tokens + 6 * 2 * hd * pairs}}


def encdec(run: Dict, seqs: int, S: int) -> Dict:
    """``seqs`` rows of ``encoder_seq`` frames and S tokens through an
    encoder-decoder: the encoder over the frames; the decoder's
    self-attention, cross-attention queries and output, MLP and
    unembedding over the tokens; its cross-attention keys and values
    over the frames."""
    d, f, hd, H = run["d_model"], run["d_ff"], run["head_dim"], run["n_heads"]
    F_, Le, Ld = run["encoder_seq"], run["encoder_layers"], run["n_layers"]
    inner = H * hd
    bias = 1 if run["use_bias"] else 0
    attn = 4 * d * inner + bias * (3 * inner + d)
    mlp = 2 * d * f + bias * (f + d)
    frames, tokens = seqs * F_, seqs * S
    enc = 6 * Le * (attn + mlp) * frames \
        + 6 * 2 * hd * Le * seqs * H * visible_pairs(F_, F_, False)
    cross_kv = 2 * d * inner + bias * 2 * inner
    cross_q_o = 2 * d * inner + bias * (inner + d)
    dec = 6 * Ld * cross_kv * frames \
        + 6 * (Ld * (attn + cross_q_o + mlp) + run["vocab_size"] * d) * tokens \
        + 6 * 2 * hd * Ld * seqs * H * (visible_pairs(S, S, True)
                                        + visible_pairs(S, F_, False))
    launches = ([(seqs, F_, F_, H, H, hd, False)] * Le
                + [(seqs, S, S, H, H, hd, True)] * Ld
                + [(seqs, S, F_, H, H, hd, False)] * Ld)
    return {"model_flops": enc + dec, "launches": launches,
            "split": {"encoder": enc, "decoder": dec}}
