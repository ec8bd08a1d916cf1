"""The attention backward at the layouts the MoE, encoder-decoder,
parallel-block and VLM families train at, at a small size, on the CPU.

Each layout keeps its family's shape of the problem -- query heads a KV
head (G 3, 7, 12), head dim (64, 128; MLA's 24/16 zero-padded to 64 at
its own scale), causal or not, Sq ≠ Skv -- at a few dozen positions:

* ``ref.flash_attention_bwd_ref`` (the kernel's plain version) and the
  gradient of ``ops.flash_attention`` by autograd against ``jax.vjp`` of
  the reference's ``kernels/ref.py`` ``flash_attention_ref``, float32.
  That oracle scales by 1/√D of the width it is given, so for a layout
  with a scale of its own the differentiated function multiplies q by
  scale·√D before the oracle (its dq carries that factor back).  Tolerance 2e-5 of each gradient's largest magnitude:
  both sides are dense float32 in other orders, as
  ``test_torch_kernels_lm.py`` holds its cases.
* On a CUDA card only (the test decides in its body, and skips here):
  the backward kernel at each layout against its plain version on the
  float32 values of the same inputs, in float32 (2e-5) and bfloat16
  (2e-2, one rounding of the output); one launch a call.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref

#: name -> (B, Sq, Skv, H, K, D, causal, true q/k and v widths or None,
#: the scale's width or None): each family's train layout, small
LAYOUTS = {
    # granite-moe-3b-a800m: 24 query heads over 8 KV heads of 64
    "granite_moe": (1, 70, 70, 6, 2, 64, True, None, None),
    # deepseek's MLA: q/k 24 and v 16 wide (192 and 128 published) in
    # heads zero-padded to the kernel's 64 (256), scaled by 1/√24
    "mla": (1, 50, 50, 4, 4, 64, True, (24, 16), 24),
    # whisper-medium: the encoder's non-causal self-attention, the
    # decoder's cross-attention over more (or fewer) encoder positions
    # than it has queries, and its causal self-attention; 16 heads of 64
    "whisper_encoder": (2, 48, 48, 4, 4, 64, False, None, None),
    "whisper_cross": (1, 64, 24, 4, 4, 64, False, None, None),
    "whisper_cross_wide": (1, 24, 72, 4, 4, 64, False, None, None),
    "whisper_decoder": (1, 64, 64, 4, 4, 64, True, None, None),
    # command-r-plus-104b: 96 query heads over 8 KV heads of 128 (G 12)
    "command_r": (1, 40, 40, 24, 2, 128, True, None, None),
    # llava-next-34b: 56 query heads over 8 KV heads of 128 (G 7)
    "llava": (1, 40, 40, 14, 2, 128, True, None, None),
}
BWD_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, seed=5):
    """float32 (q, k, v, dO) of a layout as numpy arrays, the padded
    columns of an MLA layout zero; and its scale (None: 1/√D)."""
    B, Sq, Skv, H, K, D, _, widths, scale_width = LAYOUTS[name]
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(s).astype(np.float32) for s in
                   ((B, Sq, H, D), (B, Skv, K, D), (B, Skv, K, D),
                    (B, Sq, H, D)))
    if widths:
        qk, vw = widths
        q[..., qk:] = k[..., qk:] = 0.0
        v[..., vw:] = do[..., vw:] = 0.0
    scale = None if scale_width is None else 1.0 / math.sqrt(scale_width)
    return (q, k, v, do), scale


def _jax_grads(q, k, v, do, causal, scale):
    """jax.vjp of the reference's oracle -> (dq, dk, dv), q pre-scaled so
    that its 1/√D is ``scale``."""
    c = 1.0 if scale is None else scale * math.sqrt(q.shape[-1])
    _, vjp = jax.vjp(lambda a, b, d: jref.flash_attention_ref(
        a * c, b, d, causal=causal), *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _close_rel(got, want, rtol):
    got = got.detach().float().cpu().numpy()
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rtol * max(np.abs(want).max(), 1e-30), (err, rtol)


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_backward_matches_jax_vjp(name):
    (q, k, v, do), scale = _inputs(name)
    causal = LAYOUTS[name][6]
    want = _jax_grads(q, k, v, do, causal, scale)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=causal, scale=scale)
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    got = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    for g, w in zip(got, want):
        _close_rel(g, w, BWD_RTOL)
    if LAYOUTS[name][7]:
        # the padded columns' gradients are exactly zero, as MLA needs
        qk, vw = LAYOUTS[name][7]
        for g, width in zip(got, (qk, qk, vw)):
            assert not g[..., width:].any()


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_autograd_through_ops_matches_jax_vjp(name):
    """The training path's gradient: ``ops.flash_attention``'s
    autograd.Function (its scale kept for the backward) on the CPU."""
    (q, k, v, do), scale = _inputs(name, seed=6)
    causal = LAYOUTS[name][6]
    want = _jax_grads(q, k, v, do, causal, scale)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=causal, scale=scale)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for g, w in zip(got, want):
        _close_rel(g, w, BWD_RTOL)


def test_layouts_keep_their_families_shapes():
    """Each small layout keeps what its family's train layout exercises:
    the query heads a KV head, the head dim the kernel runs, causality,
    and cross-attention's Sq ≠ Skv both ways."""
    groups = {n: c[3] // c[4] for n, c in LAYOUTS.items()}
    assert (groups["granite_moe"], groups["llava"],
            groups["command_r"]) == (3, 7, 12)
    assert {kfa.kernel_head_dim(c[5]) for c in LAYOUTS.values()} == {64, 128}
    cross = [LAYOUTS[n] for n in ("whisper_cross", "whisper_cross_wide")]
    assert all(not c[6] for c in cross)
    assert cross[0][1] > cross[0][2] and cross[1][1] < cross[1][2]
    B, Sq, Skv, H, K, D, _, (qk, vw), width = LAYOUTS["mla"]
    assert D == kfa.kernel_head_dim(max(qk, vw)) and width == qk


def test_cuda_backward_kernel_at_the_train_layouts():
    """The backward kernel at each layout against its plain version on
    the card, float32 and bfloat16; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    n0 = kfa.flash_attention_bwd_launches.count
    for name, case in LAYOUTS.items():
        arrs, scale = _inputs(name, seed=3)
        kw = dict(causal=case[6], scale=scale)
        for dt, rtol in ((torch.float32, BWD_RTOL), (torch.bfloat16, 2e-2)):
            q, k, v, do = (torch.from_numpy(a).to(dev, dt) for a in arrs)
            o, lse = kfa.flash_attention(q, k, v, return_lse=True, **kw)
            got = kfa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            want = ref.flash_attention_bwd_ref(
                *(t.float() for t in (q, k, v, o)), lse, do.float(), **kw)
            for g, w in zip(got, want):
                _close_rel(g, w.cpu().numpy(), rtol)
    assert kfa.flash_attention_bwd_launches.count == n0 + 2 * len(LAYOUTS)
