"""The port's MLA attention (``repro_torch.models.attention``) against the
JAX reference's, on the CPU, and the ``scale`` of the attention oracle
and op that MLA's padded heads need.

* ``flash_attention_ref`` with a non-default scale, on heads zero-padded
  to one of the kernel's head dims, against the reference's
  ``multihead_attention`` on the unpadded heads (q/k 24 wide, v 16 at the
  reduced width, 1/√24): forward, and backward through
  ``ops.flash_attention``'s ``autograd.Function`` (the plain backward,
  ``flash_attention_bwd_ref``, with the same scale) against ``jax.vjp``.
* ``_mla_forward`` (the expanded form, through ``ops.flash_attention``
  with q, k, v padded to 64 and scale 1/√24) and its cache entry
  (``ckv``, ``kr``); the absorbed ``_mla_decode`` for three steps.
* ``_pad_kv`` on 3-D cache entries (MLA's), dense and ring buffers, and
  the MLA decode cache an ``LM.prefill`` builds, for prompts shorter
  than the cache and as long as it.

Tolerances, float32: 1e-5 absolute for one layer's outputs (O(1) values,
the same operations in other orders), 1e-4 for a whole model's caches,
as ``tests/test_torch_lm.py`` states them; gradients 2e-5 absolute (O(1),
as ``tests/test_torch_kernels_lm.py`` holds the plain backward).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_config as jget_config
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.models import LM
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_reference, unstack_groups
from repro_torch.models.model import tree_map

ATOL_LAYER = 1e-5
ATOL_MODEL = 1e-4
ATOL_GRAD = 2e-5
ARCH = "deepseek-v2-lite-16b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    return (jget_config(ARCH).reduced(**over),
            get_config(ARCH).reduced(**over))


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    jax.tree.map(np.asarray, tree))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], atol)
        return
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def test_padded_head_dim():
    _, tc = _cfgs()
    assert TA.padded_head_dim(tc) == 64              # q/k 24, v 16
    assert TA.padded_head_dim(get_config(ARCH)) == 256   # q/k 192, v 128


@pytest.mark.parametrize("Sq", [1, 37])
def test_scaled_attention_on_padded_heads_matches_reference(Sq):
    """The oracle and the op, forward and backward, with scale 1/√24 on
    heads zero-padded from 24 (v from 16) to 64, against the reference's
    attention on the unpadded heads: its scale is 1/√24 of its own."""
    B, H, Dqk, Dv, Dp = 2, 4, 24, 16, 64
    q, k = _x((B, Sq, H, Dqk), 1), _x((B, Sq, H, Dqk), 2)
    v, do = _x((B, Sq, H, Dv), 3), _x((B, Sq, H, Dv), 4)
    pos = jnp.arange(Sq)
    jout, vjp = jax.vjp(lambda a, b, c: JA.multihead_attention(
        a, b, c, q_positions=pos, kv_positions=pos, causal=True),
        *(jnp.asarray(a) for a in (q, k, v)))
    jgrads = vjp(jnp.asarray(do))

    scale = 1.0 / math.sqrt(Dqk)
    pad = lambda a, d: F.pad(torch.from_numpy(a), (0, Dp - d))  # noqa: E731
    tq, tk, tv = pad(q, Dqk), pad(k, Dqk), pad(v, Dv)
    out = ref.flash_attention_ref(tq, tk, tv, causal=True, scale=scale)
    _close(out[..., :Dv], jout, ATOL_LAYER)
    assert not out[..., Dv:].any()
    # the default scale is 1/√64 here: a different function (at Sq = 1
    # both give the one value row)
    default = ref.flash_attention_ref(tq, tk, tv, causal=True)
    assert Sq == 1 or not torch.allclose(default, out, atol=1e-3)

    ins = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    o = ops.flash_attention(*ins, causal=True, scale=scale)
    grads = torch.autograd.grad(o, ins, pad(do, Dv))
    for g, w, d in zip(grads, jgrads, (Dqk, Dqk, Dv)):
        _close(g[..., :d], w, ATOL_GRAD)
        assert not g[..., d:].any()


def test_mla_forward_matches_reference(monkeypatch):
    """The expanded form through the op: q, k and v padded to 64, scale
    1/√24; y and the cache entry (the latent and the shared rope key)."""
    jc, tc = _cfgs()
    p = JA.init_attention(jax.random.key(4), jc)
    x = _x((2, 20, jc.d_model), 5)
    calls = []
    op = ops.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], k.shape[-1], v.shape[-1], kw))
        return op(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", spy)
    y, kv = TA.attn_forward(_t(p), torch.from_numpy(x), torch.arange(20), tc,
                            return_kv=True)
    jy, jkv = JA.attn_forward(p, jnp.asarray(x), jnp.arange(20), jc,
                              return_kv=True)
    _close(y, jy, ATOL_LAYER)
    _close(kv, jkv, ATOL_LAYER)
    assert calls == [(64, 64, 64, dict(causal=True,
                                       scale=1.0 / math.sqrt(24)))]


def test_mla_decode_matches_reference():
    """Three absorbed decode steps from a filled latent cache, the batch's
    rows at different positions; the cache written in place."""
    jc, tc = _cfgs()
    p = JA.init_attention(jax.random.key(6), jc)
    tp = _t(p)
    S = 24
    cache = {"ckv": _x((2, S, jc.kv_lora_rank), 7),
             "kr": _x((2, S, jc.qk_rope_dim), 8)}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    pos = np.array([5, 17])
    for step in range(3):
        x = _x((2, 1, jc.d_model), 30 + step)
        y, new = TA.attn_decode(tp, torch.from_numpy(x), tcache,
                                torch.from_numpy(pos + step), tc)
        assert all(new[n] is tcache[n] for n in tcache)
        jy, jcache = JA.attn_decode(p, jnp.asarray(x), jcache,
                                    jnp.asarray(pos + step), jc)
        _close(y, jy, ATOL_LAYER)
        _close(new, jcache, ATOL_LAYER)
        tcache = new


@pytest.mark.parametrize("S,cache_len,window", [
    (10, 30, 0), (30, 30, 0), (10, 30, 16), (20, 30, 16), (37, 40, 16)])
def test_pad_kv_3d_entries(S, cache_len, window):
    """MLA's cache entries are (B,S,R): only the sequence axis is padded
    (a ring for a window, past its length too), never the batch axis."""
    jc, tc = _cfgs()
    kv = {"ckv": _x((2, S, 32), 1), "kr": _x((2, S, 8), 2)}
    got = TM._pad_kv({n: torch.from_numpy(a) for n, a in kv.items()},
                     cache_len, window, tc)
    want = JM._pad_kv({n: jnp.asarray(a) for n, a in kv.items()},
                      cache_len, window, jc)
    _close(got, want, 0.0)


@pytest.mark.parametrize("S,cache_len", [(12, 20), (20, 20)])
def test_prefill_builds_the_mla_cache(S, cache_len):
    """``LM.prefill`` of reduced deepseek-v2-lite (a dense layer, then an
    MoE layer) on the reference's weights: its logits and every layer's
    ``ckv`` / ``kr`` of shape (B, cache_len, ·), zeros past the prompt."""
    jc, tc = _cfgs()
    jparams = JM.LM(jc).init(jax.random.key(9))
    tokens = np.random.default_rng(9).integers(0, jc.vocab_size, (2, S))
    jcache, jlogits = JM.LM(jc).prefill(
        jparams, {"tokens": jnp.asarray(tokens)}, cache_len)
    params = params_from_reference(tc, jax.tree.map(np.asarray, jparams))
    with torch.inference_mode():
        cache, logits = LM(tc).prefill(
            params, {"tokens": torch.from_numpy(tokens)}, cache_len)
    _close(logits, jlogits, ATOL_MODEL)
    want = unstack_groups(tc, jax.tree.map(np.asarray, jcache["layers"]))
    assert len(cache["layers"]) == len(want) == tc.n_layers
    for got, w in zip(cache["layers"], want):
        assert got["ckv"].shape == (2, cache_len, tc.kv_lora_rank)
        assert got["kr"].shape == (2, cache_len, tc.qk_rope_dim)
        _close(got, w, ATOL_MODEL)
        assert not got["ckv"][:, S:].any()


def test_kernel_scale_argument():
    """The C entry points take the scale the wrapper resolves: 1/√D for
    None (1/16 at MLA's padded 256), else the caller's, which must be a
    finite positive number."""
    assert kfa._scale(None, 256) == 1.0 / 16
    assert kfa._scale(1.0 / math.sqrt(192), 256) == 1.0 / math.sqrt(192)
    for bad in (0.0, -1.0, float("nan"), float("inf")):
        with pytest.raises(ValueError, match="scale"):
            kfa._scale(bad, 64)
