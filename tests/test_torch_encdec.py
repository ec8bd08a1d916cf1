"""The port's encoder-decoder family and parallel block against the JAX
reference, on the CPU.

whisper-medium (``encdec``: a non-causal encoder over stub frames,
sinusoidal positions, ``XATTN`` decoder layers that cross-attend to the
encoder output) and command-r-plus-104b (a dense stack of parallel
attention+FFN blocks) at ``cfg.reduced()`` (whisper 2 encoder + 2
decoder layers over 24 frames; command-r 2 and 3 layers), on the
reference's own float32 weights carried over by ``params_from_reference``
and inputs made with numpy from fixed seeds: ``_sincos``; cross-attention
forward and decode; the non-causal encoder; one ``XATTN`` layer and one
parallel-block layer, forward (with its cache entry) and decode; the
whole ``LM`` — prefill logits and every cache entry (``ck``/``cv``
included), then 8 greedy decode steps; ``init_cache(enc_len=)``;
``forward`` and ``loss`` with its gradients; ``serve`` against the
reference's ``serve`` token for token, and the serve CLI.  No test draws
at random.

Tolerances, float32 throughout, as ``tests/test_torch_lm.py`` holds the
other families: ``ATOL_LAYER`` 1e-5 absolute for one layer's outputs
(O(1) values, the same operations in other orders); ``ATOL_MODEL`` 1e-4
absolute for whole-model logits and caches, through up to 4 layers;
greedy tokens equal; the loss 1e-5 relative and its gradients 1e-4 of
each leaf's largest magnitude, as ``tests/test_torch_train.py`` holds the
dense LM's, with a floor of 1e-6 of the largest gradient of all: a key
projection's bias (whisper's ``use_bias``) has a gradient of exactly zero
(it adds q·b to every score of a row, which the softmax ignores), so both
sides hold float32 rounding there and nothing else.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch import serve as jserve
from repro.models import attention as JA
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import LM
from repro_torch.models import attention as TA
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_reference, unstack_groups

ATOL_LAYER = 1e-5
ATOL_MODEL = 1e-4
WHISPER = "whisper-medium"
COMMAND_R = "command-r-plus-104b"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread is enough, and the suite runs
    beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _t(tree):
    """A reference pytree (dicts of arrays) as the same dicts of tensors."""
    return TM.tree_map(lambda a: torch.from_numpy(np.array(a)), _np(tree))


def _close(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], atol)
        return
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def _cfgs(arch, **over):
    return (jget_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _frames(cfg, B, seed=8):
    return _x((B, cfg.encoder_seq, cfg.d_model), seed=seed)


# ------------------------------------------------------------- configs
def test_reduced_configs_are_the_issue_sizes():
    jw, tw = _cfgs(WHISPER)
    assert (tw.n_layers, tw.encoder_layers, tw.encoder_seq) == (2, 2, 24)
    assert jw.encoder_seq == 24
    jc, tc = _cfgs(COMMAND_R)
    assert tc.parallel_block and jc.parallel_block and tc.n_layers == 2


# ------------------------------------------------------------- sincos
@pytest.mark.parametrize("d", [64, 1024, 2])
def test_sincos(d):
    """Prefill positions (S,) and decode positions (B,1), and the
    degenerate half = 1 (denominator max(half - 1, 1)).  Up to the
    positions the reduced models reach, ``ATOL_LAYER``; at whisper's
    last decode position (447) and past it, the two float32 ``exp``s of
    a frequency may differ by one ulp (2^-23 relative), which the angle
    carries times the position: ``ATOL_LAYER`` + pos x 2^-23."""
    pos = np.arange(37)
    _close(TM._sincos(torch.from_numpy(pos), d, torch.float32),
           JM._sincos(jnp.asarray(pos), d, jnp.float32), ATOL_LAYER)
    dpos = np.array([[0], [447], [2000]])
    got = TM._sincos(torch.from_numpy(dpos), d, torch.float32).numpy()
    want = np.asarray(JM._sincos(jnp.asarray(dpos), d, jnp.float32))
    assert got.shape == want.shape == (3, 1, d)
    lim = ATOL_LAYER + dpos[..., None] * 2.0 ** -23
    assert (np.abs(got - want) <= lim).all()


# ------------------------------------------------------ cross-attention
def test_cross_attention_init_ignores_mla():
    """A cross-attention layer is plain GQA even in an MLA config."""
    jc, tc = _cfgs("deepseek-v2-lite-16b")
    want = JA.init_attention(jax.random.key(0), jc, cross=True)
    got = TA.init_attention(TM.L.Init(0, "cpu", torch.float32), tc,
                            cross=True)
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in got.items()} == \
        {k: {n: v[n].shape for n in v} for k, v in want.items()}
    assert "w_dkv" in TA.init_attention(TM.L.Init(0, "cpu", torch.float32),
                                        tc)


@pytest.mark.parametrize("Sq", [1, 13, 40])
def test_cross_attention_forward(Sq):
    """Queries from the decoder, keys and values from the encoder output
    (24 frames): no RoPE, never causal (also when Sq > S_enc), the
    projected K/V returned for the cache."""
    jc, tc = _cfgs(WHISPER)
    p = JA.init_attention(jax.random.key(4), jc, cross=True)
    x, enc = _x((2, Sq, 64)), _frames(jc, 2)
    y, kv = TA.attn_forward(_t(p), torch.from_numpy(x), torch.arange(Sq), tc,
                            kv_source=torch.from_numpy(enc), return_kv=True)
    jy, jkv = JA.attn_forward(p, jnp.asarray(x), jnp.arange(Sq), jc,
                              kv_source=jnp.asarray(enc),
                              kv_positions=jnp.arange(24), return_kv=True)
    _close(y, jy, ATOL_LAYER)
    _close(kv, jkv, ATOL_LAYER)


def test_cross_attention_decode():
    """One query against the cached encoder K/V, every position visible,
    as the reference's XATTN decode computes it."""
    jc, tc = _cfgs(WHISPER)
    p = JA.init_attention(jax.random.key(5), jc, cross=True)
    x = _x((3, 1, 64))
    ck, cv = _x((3, 24, 2, 16), seed=1), _x((3, 24, 2, 16), seed=2)
    q = JA.dense3(p["wq"], jnp.asarray(x), 4, 16)[:, 0]
    stats = JA.decode_attend_chunk(
        q, jnp.asarray(ck), jnp.asarray(cv), jnp.full((3,), 1 << 30),
        jnp.broadcast_to(jnp.arange(24)[None], (3, 24)), scale=0.25)
    out = JA.combine_decode([stats])
    want = JM.L.dense(p["wo"], out.reshape(3, -1))[:, None]
    got = TA.cross_decode(_t(p), torch.from_numpy(x), torch.from_numpy(ck),
                          torch.from_numpy(cv), tc)
    _close(got, want, ATOL_LAYER)


def test_noncausal_self_attention():
    jc, tc = _cfgs(WHISPER)
    p = JA.init_attention(jax.random.key(6), jc)
    x = _x((2, 24, 64))
    got = TA.attn_forward(_t(p), torch.from_numpy(x), torch.arange(24), tc,
                          causal=False)
    want = JA.attn_forward(p, jnp.asarray(x), jnp.arange(24), jc,
                           causal=False)
    _close(got, want, ATOL_LAYER)
    causal = TA.attn_forward(_t(p), torch.from_numpy(x), torch.arange(24),
                             tc)
    assert float((causal - got).abs().max()) > 1e-2


def test_encoder_matches_reference():
    """``LM.encode``: sincos added to the frames, 2 non-causal layers, the
    final norm."""
    jc, tc = _cfgs(WHISPER)
    jparams = JM.LM(jc).init(jax.random.key(9))
    frames = _frames(jc, 2)
    want = JM.LM(jc).encode(jparams, jnp.asarray(frames))
    params = params_from_reference(tc, _np(jparams))
    assert len(params["encoder"]["layers"]) == tc.encoder_layers
    got = LM(tc).encode(params, torch.from_numpy(frames))
    _close(got, want, ATOL_LAYER)


# ------------------------------------------------------------- layers
def _layer_case(arch, kind):
    jc, tc = _cfgs(arch)
    jspec, tspec = JM.LayerSpec(kind, "mlp"), TM.LayerSpec(kind, "mlp")
    p = JM._init_layer(jax.random.key(3), jspec, jc)
    return jc, tc, jspec, tspec, p


@pytest.mark.parametrize("arch,kind", [(WHISPER, JM.XATTN),
                                       (COMMAND_R, "attn")])
def test_layer_forward_cache_and_decode(arch, kind):
    """One XATTN layer (self, cross over the encoder output, MLP) and one
    parallel block (one norm, ``x + att + ffn(h)``, no ``ln2``): the
    prefill output and cache entry, then two decode steps from it."""
    jc, tc, jspec, tspec, p = _layer_case(arch, kind)
    tp = _t(p)
    assert set(tp) == set(p)
    assert ("ln2" in tp) != tc.parallel_block
    S, cache_len = 11, 16
    x = _x((2, S, 64))
    enc = _frames(jc, 2) if kind == JM.XATTN else None
    y, _, entry = TM._layer_fwd(
        tspec, tp, torch.from_numpy(x), torch.arange(S), tc,
        enc=None if enc is None else torch.from_numpy(enc),
        collect_cache=True, cache_len=cache_len)
    jy, _, jentry = JM._layer_fwd(
        jspec, p, jnp.asarray(x), jnp.arange(S), jc,
        enc=None if enc is None else jnp.asarray(enc),
        enc_positions=None if enc is None else jnp.arange(24),
        collect_cache=True, cache_len=cache_len)
    _close(y, jy, ATOL_LAYER)
    _close(entry, jentry, ATOL_LAYER)
    assert ("ck" in entry) == (kind == JM.XATTN)
    pos = np.array([S, S])
    for step in range(2):
        x1 = _x((2, 1, 64), seed=30 + step)
        y, entry = TM._layer_decode(tspec, tp, torch.from_numpy(x1), entry,
                                    torch.from_numpy(pos + step), tc)
        jy, jentry = JM._layer_decode(jspec, p, jnp.asarray(x1), jentry,
                                      jnp.asarray(pos + step), jc)
        _close(y, jy, ATOL_LAYER)
        _close(entry, jentry, ATOL_LAYER)


# ------------------------------------------------------------ whole LM
LM_CASES = {
    # name: (arch, overrides, prompt length)
    "whisper": (WHISPER, {}, 20),
    "command_r2": (COMMAND_R, {}, 24),
    "command_r3": (COMMAND_R, {"n_layers": 3}, 20),
}
GEN = 8


def _batch(jc, tokens, B):
    batch = {"tokens": tokens}
    if jc.family == "encdec":
        batch["frames"] = _frames(jc, B)
    return batch


@pytest.fixture(scope="module")
def lm_runs():
    """Each case once through the JAX reference: weights, inputs,
    prefill logits and cache, 8 greedy decode steps' logits and the cache
    after them."""
    runs = {}
    for name, (arch, over, S) in LM_CASES.items():
        jc, tc = _cfgs(arch, **over)
        model = JM.LM(jc)
        params = model.init(jax.random.key(7))
        tokens = np.random.default_rng(7).integers(0, jc.vocab_size, (2, S))
        batch = _batch(jc, tokens, 2)
        prefill_fn = jax.jit(model.prefill, static_argnums=2)
        decode_fn = jax.jit(model.decode_step)
        cache, logits = prefill_fn(params, jax.tree.map(jnp.asarray, batch),
                                   S + GEN)
        prefill = (_np(cache), np.asarray(logits))
        steps, toks = [], []
        for _ in range(GEN):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            logits, cache = decode_fn(params, cache, tok)
            toks.append(np.asarray(tok))
            steps.append(np.asarray(logits))
        runs[name] = dict(tcfg=tc, params=_np(params), batch=batch,
                          prefill=prefill, steps=steps, toks=toks,
                          final=_np(cache))
    return runs


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_prefill_and_decode_match_reference(lm_runs, name):
    run = lm_runs[name]
    tc = run["tcfg"]
    S = run["batch"]["tokens"].shape[1]
    model = LM(tc)
    params = params_from_reference(tc, run["params"])
    assert len(params["layers"]) == tc.n_layers
    n0 = kfa.flash_attention_launches.count
    with torch.inference_mode():
        cache, logits = model.prefill(
            params, {k: torch.from_numpy(v) for k, v in run["batch"].items()},
            S + GEN)
    assert kfa.flash_attention_launches.count == n0  # plain on the CPU
    jcache, jlogits = run["prefill"]
    _close(logits, jlogits, ATOL_MODEL)
    assert cache["pos"].tolist() == jcache["pos"].tolist()
    want_layers = unstack_groups(tc, jcache["layers"])
    assert len(cache["layers"]) == len(want_layers) == tc.n_layers
    for got, want in zip(cache["layers"], want_layers):
        assert set(got) == ({"k", "v", "ck", "cv"} if tc.family == "encdec"
                            else {"k", "v"})
        _close(got, want, ATOL_MODEL)
    with torch.inference_mode():
        for tok, want in zip(run["toks"], run["steps"]):
            got_tok = torch.argmax(logits, dim=-1)
            assert got_tok.tolist() == tok.tolist()
            logits, cache = model.decode_step(params, cache, got_tok)
            _close(logits, want, ATOL_MODEL)
    assert cache["pos"].tolist() == run["final"]["pos"].tolist()
    for got, want in zip(cache["layers"],
                         unstack_groups(tc, run["final"]["layers"])):
        _close(got, want, ATOL_MODEL)


@pytest.mark.parametrize("arch", [WHISPER, COMMAND_R])
def test_init_cache_matches_reference(arch):
    """Zeroed decode caches of the same shapes and values, layer by layer;
    whisper's hold ``enc_len`` encoder positions."""
    jc, tc = _cfgs(arch)
    enc_len = jc.encoder_seq if jc.family == "encdec" else 0
    want = JM.LM(jc).init_cache(3, 50, enc_len=enc_len)
    got = LM(tc).init_cache(3, 50, device="cpu", enc_len=enc_len)
    assert got["pos"].tolist() == np.asarray(want["pos"]).tolist()
    want_layers = unstack_groups(tc, _np(want["layers"]))
    assert len(got["layers"]) == len(want_layers) == tc.n_layers
    for g, w in zip(got["layers"], want_layers):
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: v.shape for k, v in w.items()}
        _close(g, w, 0.0)
    if enc_len:
        assert tuple(got["layers"][0]["ck"].shape) == (3, 24, 2, 16)


@pytest.mark.parametrize("arch", [WHISPER, COMMAND_R])
def test_forward_loss_and_gradients_match_reference(arch):
    """``LM.forward`` logits, ``LM.loss`` and its gradients (the encoder's
    and the cross-attention's included), remat "none" and "full"."""
    jc, tc = _cfgs(arch)
    jparams = JM.LM(jc).init(jax.random.key(11))
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (2, 17))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = _batch(jc, toks[:, :-1].astype(np.int32), 2)
    batch["labels"] = labels.astype(np.int32)
    jbatch = jax.tree.map(jnp.asarray, batch)
    jlogits, _ = JM.LM(jc).forward(jparams, jbatch)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        JM.LM(jc).loss, has_aux=True)(jparams, jbatch)
    want = params_from_reference(tc, _np(jgrads))
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["tokens"], tbatch["labels"] = (tbatch["tokens"].long(),
                                          tbatch["labels"].long())
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tc, remat=remat)
        params = params_from_reference(cfg, _np(jparams))
        with torch.no_grad():
            logits, _ = LM(cfg).forward(params, tbatch)
        _close(logits, jlogits, ATOL_MODEL)
        loss, metrics, grads = tsteps.loss_and_grads(LM(cfg), params, tbatch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["ce"]),
                                   float(jmetrics["ce"]), rtol=1e-5)
        got, ref_ = list(TM.tensors(grads)), list(TM.tensors(want))
        assert len(got) == len(ref_)
        scale = max(float(w.abs().max()) for w in ref_)
        for g, w in zip(got, ref_):
            w = w.numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= max(1e-4 * np.abs(w).max(), 1e-6 * scale), \
                (err, g.shape, scale)


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("arch,prompt_len", [(WHISPER, 12), (COMMAND_R, 12)])
def test_serve_matches_reference_tokens(arch, prompt_len):
    """``serve(..., device="cpu", params=...)`` on the reference's own
    weights (converted) gives the reference ``serve``'s tokens: whisper's
    frames drawn from the same generator right after the prompts."""
    jc = jget_config(arch).reduced()
    want = jserve.serve(arch, 2, prompt_len, 6, reduced=True, seed=3,
                        log=lambda *a: None)
    params = _np(JM.LM(jc).init(jax.random.key(3)))
    got = tserve.serve(arch, 2, prompt_len, 6, reduced=True, seed=3,
                       device="cpu",
                       params=params_from_reference(get_config(arch)
                                                    .reduced(), params),
                       log=lambda *a: None)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", [WHISPER, COMMAND_R])
def test_serve_cli_runs_the_new_archs(arch, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch ...`` serves both
    (reduced, on the CPU); at full size with no ``--device`` it asks for
    the card before it makes anything."""
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "10", "--gen", "3"])
    assert "generated shape: (2, 3)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(arch, 4, 384, 64, reduced=False)
