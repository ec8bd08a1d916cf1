"""The yardstick's arithmetic against counts made by hand: attention pairs
and launch work, each configuration's model FLOPs a position, whisper's
split between its encoder and decoder, and the peaks."""
import pytest

from portbench import tiny
from portbench.work import common as W


def test_visible_pairs():
    assert W.visible_pairs(4, 4, True) == 4 + 3 + 2 + 1
    assert W.visible_pairs(4, 4, False) == 16
    assert W.visible_pairs(3, 5, False) == 15        # cross-attention
    assert W.visible_pairs(4096, 4096, True) == 4096 * 4097 // 2


def test_attention_launch_work():
    # one sequence, one head of 64, causal over 2 positions: 3 pairs
    fl, by = W.attn_fwd_work(1, 2, 2, 1, 1, 64, True)
    assert fl == 3 * 2 * (64 + 64)
    assert by == 2 * (2 * 2 * 64 + 2 * 2 * 64)
    fl, by = W.attn_bwd_work(1, 2, 2, 1, 1, 64, True)
    assert fl == 3 * 2 * (3 * 64 + 2 * 64)
    assert by == 2 * 2 * 128 * (2 + 2) + 4 * 2
    assert W.bound_s((989e12, 0.0)) == pytest.approx(1.0)
    assert W.bound_s((0.0, 3.35e12)) == pytest.approx(1.0)


def _step(workload):
    cell = tiny.suite().cell(workload)
    t = cell.traffic
    seqs = t["trials"] * t["batch"]
    return cell, cell.work.step_work(cell.run_config, seqs, t["seq"]), seqs


def test_granite_moe_d4_flops_a_position():
    cell, w, seqs = _step("granite-moe.pop")
    # by hand: a layer's q, k, v, o (1536·1536·2 + 1536·512·2), router
    # (1536·40) and 8 experts (8·3·1536·512); 4 layers; the unembedding
    # 49155·1536; 6 a parameter; attention 6·128 a pair, 24 heads, 4
    # layers, 4097/2 pairs a position on average
    layer = 2 * 1536 * 1536 + 2 * 1536 * 512 + 1536 * 40 \
        + 8 * 3 * 1536 * 512
    dense = 6 * (4 * layer + 49155 * 1536)
    attn = 6 * 128 * 24 * 4 * 4097 / 2
    per_position = w["model_flops"] / (seqs * 4096)
    assert per_position == pytest.approx(dense + attn, rel=1e-12)
    assert per_position == pytest.approx(1.21e9, rel=0.005)
    assert len(w["launches"]) == 4


def test_whisper_split():
    cell, w, seqs = _step("whisper.pop")
    d, f, S, F_, V = 1024, 4096, 448, 1536, 51865
    attn = 4 * d * d + 3 * d + d                 # q, k, v, o and biases
    mlp = 2 * d * f + f + d
    pair = 6 * 128 * 16                          # a pair, 16 heads of 64
    enc = 6 * 24 * (attn + mlp) * seqs * F_ + 24 * pair * seqs * F_ * F_
    dec = (6 * 24 * (2 * d * d + 2 * d) * seqs * F_          # cross k, v
           + 6 * (24 * (attn + 2 * d * d + 2 * d + mlp) + V * d) * seqs * S
           + 24 * pair * seqs * (S * (S + 1) // 2 + S * F_))
    assert w["split"]["encoder"] == pytest.approx(enc, rel=1e-12)
    assert w["split"]["decoder"] == pytest.approx(dec, rel=1e-12)
    assert w["model_flops"] == pytest.approx(42.2e12, rel=0.01)
    # the encoder over 1536 frames holds two thirds of the step
    assert w["split"]["encoder"] / w["model_flops"] == pytest.approx(
        0.661, abs=0.002)
    assert len(w["launches"]) == 24 * 3


def test_peaks_are_the_data_sheets():
    assert W.PEAK_BF16_FLOPS == 989e12
    assert W.PEAK_BYTES == 3.35e12
