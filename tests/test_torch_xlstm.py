"""The port's xLSTM family (mLSTM and sLSTM blocks) against the JAX
reference, on the CPU.

xlstm-125m at ``cfg.reduced()`` (4 layers m, m, m, s; d 64, inner width
64, 4 heads: mLSTM head dim 16, sLSTM head dim 16), float32, on the
reference's own weights carried over by ``params_from_reference`` and
inputs made with numpy from fixed seeds:
  * ``mlstm_cell`` (from a zero state and from a given one), the mLSTM
    block's forward with its cache and decode steps from it, the sLSTM
    block's likewise, each at S = 40 (one chunk of 40) and S = 300 (a
    full 256-step chunk and a padded one: the state carry and the
    padding), and the zeroed caches;
  * the whole ``LM``: ``forward``, then ``prefill`` and 6 greedy
    ``decode_step``s, at S = 300; ``loss`` and its gradients with remat
    "none" and "full"; ``serve`` token for token against the
    reference's ``serve`` (xLSTM has no prefix, so the reference's cache
    length is sound here); ``launch.train.train`` against the reference's
    ``train`` from the same state on the same batches.
No test draws at random.

Tolerances, float32 throughout: 1e-5 absolute for one block's outputs
(O(1) values, the same operations in other orders); the cell's states
C, n, m (sums over up to 300 steps) at 1e-5 of their largest magnitude,
its h against float64 (``test_mlstm_cell``); the whole model's logits
and caches at rtol 1e-5 / atol 1e-5 (the reference's own prefill and
decode agree with its forward to ~5e-7 here); greedy tokens equal; the
loss 1e-5 relative and its gradients 1e-4 of each leaf's largest
magnitude, as ``tests/test_torch_train.py`` holds the dense LM's, with a
floor of 1e-6 of the largest gradient of all; ``train``'s last loss 1e-5
relative and each logged loss (4 decimals) within 1.5e-4.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.launch import serve as jserve
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.models import model as JM
from repro.models import recurrent as JR
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rglru_scan as krg
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as T
from repro_torch.models import LM
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference,
                                        unstack_groups)

ARCH = "xlstm-125m"
ATOL_LAYER = 1e-5
TOL_MODEL = dict(rtol=1e-5, atol=1e-5)
SEQS = [40, 300]


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


def _close(got, want, atol=ATOL_LAYER, rtol=0.0):
    if isinstance(want, (dict, tuple, list)):
        keys = want.keys() if isinstance(want, dict) else range(len(want))
        if isinstance(want, dict):
            assert set(got) == set(want)
        for k in keys:
            _close(got[k], want[k], atol, rtol)
        return
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _scaled(want) -> float:
    """``ATOL_LAYER`` times the largest magnitude of ``want`` (at least
    1): a sum over many steps, or a ratio num / den of such sums."""
    return ATOL_LAYER * max(1.0, float(np.abs(np.asarray(want)).max()))


def _cfgs(**over):
    return jget_config(ARCH).reduced(**over), get_config(ARCH).reduced(**over)


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------- configs
def test_reduced_config_sizes():
    jc, tc = _cfgs()
    assert (tc.n_layers, tc.d_model, tc.d_rnn, tc.n_heads) == (4, 64, 64, 4)
    assert tc.pattern == jc.pattern == ("mlstm", "mlstm", "mlstm", "slstm")
    assert TR._MLSTM_CHUNK == JR._MLSTM_CHUNK == 256
    assert [s.kind for s in LM(tc).specs] == list(tc.pattern)
    assert {s.ffn for s in LM(tc).specs} == {"none"}


# ------------------------------------------------------------- mLSTM
def _cell_inputs(S, seed):
    B, H, D = 2, 4, 16
    q, k, v = (_x((B, S, H, D), seed=seed + i) for i in range(3))
    i_t = _x((B, S, H), seed=seed + 3)
    f_t = _x((B, S, H), seed=seed + 4, scale=2.0)
    log_f = np.array(jax.nn.log_sigmoid(jnp.asarray(f_t) + 1.0))
    return q, k, v, i_t, log_f


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", SEQS)
def test_mlstm_cell(S, with_state):
    """h and the final state (C, n, m) of the chunkwise cell, from the
    zero state (m = -60) and from a given state.  h = num / max(|den|,
    e^-m) loses float32 digits wherever den cancels, in both packages, so
    h is held to the same cell in float64: the port no further from it
    than twice the reference's float32 run, plus 1e-6 of max |h|."""
    args = _cell_inputs(S, seed=S)
    state = None
    if with_state:
        state = (_x((2, 4, 16, 16), seed=50), _x((2, 4, 16), seed=51),
                 _x((2, 4), seed=52))
    want_h, want_state = JR.mlstm_cell(
        *map(jnp.asarray, args),
        None if state is None else tuple(map(jnp.asarray, state)))
    got_h, got_state = TR.mlstm_cell(
        *map(torch.from_numpy, args),
        None if state is None else tuple(map(torch.from_numpy, state)))
    for g, w in zip(got_state, want_state):
        _close(g, w, atol=_scaled(w))
    h64, _ = TR.mlstm_cell(
        *(torch.from_numpy(a).double() for a in args),
        None if state is None else tuple(torch.from_numpy(a).double()
                                         for a in state))
    h64 = h64.numpy()
    assert h64.dtype == np.float64 and got_h.dtype == torch.float32
    ref_err = np.abs(np.asarray(want_h, np.float64) - h64).max()
    err = np.abs(got_h.numpy().astype(np.float64) - h64).max()
    assert err <= 2 * ref_err + 1e-6 * np.abs(h64).max(), (err, ref_err)


def _block_case(kind, seed):
    jc, tc = _cfgs()
    init = {"mlstm": JR.init_mlstm_block, "slstm": JR.init_slstm_block}[kind]
    return jc, tc, init(jax.random.key(seed), jc)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("S", SEQS)
def test_block_forward_cache_and_decode(kind, S):
    """A block's forward (and with its cache: the mLSTM's C, n, m and
    the conv's pre-conv ``up_m`` inputs; the sLSTM's c, n, h, m), then
    three decode steps from that cache."""
    jc, tc, p = _block_case(kind, seed=S)
    tp = _t(p)
    assert set(tp) == set(p)
    fwd = {"mlstm": (JR.mlstm_forward, TR.mlstm_forward),
           "slstm": (JR.slstm_forward, TR.slstm_forward)}[kind]
    dec = {"mlstm": (JR.mlstm_decode, TR.mlstm_decode),
           "slstm": (JR.slstm_decode, TR.slstm_decode)}[kind]
    x = _x((2, S, 64), seed=S + 1)
    jy, jcache = fwd[0](p, jnp.asarray(x), jc, return_cache=True)
    y, cache = fwd[1](tp, torch.from_numpy(x), tc, return_cache=True)
    _close(y, jy)
    assert set(cache) == set(jcache)
    for name in jcache:
        _close(cache[name], jcache[name], atol=_scaled(jcache[name]))
    assert torch.equal(fwd[1](tp, torch.from_numpy(x), tc), y)
    for step in range(3):
        x1 = _x((2, 1, 64), seed=100 + step)
        jy, jcache = dec[0](p, jnp.asarray(x1), jcache, jc)
        y, cache = dec[1](tp, torch.from_numpy(x1), cache, tc)
        _close(y, jy)
        for name in jcache:
            _close(cache[name], jcache[name], atol=_scaled(jcache[name]))


def test_short_prompt_conv_cache_is_left_padded():
    """A prompt shorter than the conv's W - 1 = 3 inputs: the mLSTM cache's
    conv buffer is zero-padded on the left, as the reference's."""
    jc, tc, p = _block_case("mlstm", seed=7)
    x = _x((2, 2, 64), seed=8)
    _, jcache = JR.mlstm_forward(p, jnp.asarray(x), jc, return_cache=True)
    _, cache = TR.mlstm_forward(_t(p), torch.from_numpy(x), tc,
                                return_cache=True)
    assert tuple(cache["conv"].shape) == (2, 3, 64)
    assert float(cache["conv"][:, 0].abs().max()) == 0.0
    _close(cache, jcache)


def test_slstm_step_and_group_norm():
    """One ``_slstm_step`` from a random carry, and the per-head group
    norm (population variance, ``gn`` not applied)."""
    jc, tc, p = _block_case("slstm", seed=9)
    carry = tuple(_x((3, 4, 16), seed=20 + i) for i in range(4))
    zx = _x((3, 256), seed=30)
    jcarry, jh = JR._slstm_step(p, jc, tuple(map(jnp.asarray, carry)),
                                jnp.asarray(zx))
    tcarry, th = TR._slstm_step(_t(p), tc, tuple(map(torch.from_numpy,
                                                     carry)),
                                torch.from_numpy(zx))
    _close(th, jh)
    _close(tcarry, jcarry)
    x = _x((2, 5, 4, 16), seed=31, scale=3.0)
    _close(TR._group_norm(None, torch.from_numpy(x), 1e-5),
           JR._group_norm(None, jnp.asarray(x), 1e-5))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_init_block_and_cache_shapes(kind):
    """Parameter shapes of both blocks (the sLSTM's FFN ceil(4d/3/64)·64
    wide, its ``r`` (4, H, dh, dh)) and the zeroed caches (the mLSTM's m
    at -60, the sLSTM's at -30), at the published width too."""
    for jc, tc in (_cfgs(), (jget_config(ARCH), get_config(ARCH))):
        jinit = {"mlstm": JR.init_mlstm_block,
                 "slstm": JR.init_slstm_block}[kind]
        tinit = {"mlstm": TR.init_mlstm_block,
                 "slstm": TR.init_slstm_block}[kind]
        want = jax.eval_shape(lambda: jinit(jax.random.key(0), jc))
        got = tinit(TM.L.Init(0, "meta", torch.float32), tc)
        assert TM.tree_map(lambda t: tuple(t.shape), got) == \
            jax.tree.map(lambda s: tuple(s.shape), want,
                         is_leaf=lambda s: hasattr(s, "shape"))
        jcache = {"mlstm": JR.init_mlstm_cache,
                  "slstm": JR.init_slstm_cache}[kind](jc, 2)
        tcache = {"mlstm": TR.init_mlstm_cache,
                  "slstm": TR.init_slstm_cache}[kind](tc, 2, device="meta")
        assert {k: tuple(v.shape) for k, v in tcache.items()} == \
            {k: v.shape for k, v in jcache.items()}
    _close({k: v for k, v in
            {"mlstm": TR.init_mlstm_cache,
             "slstm": TR.init_slstm_cache}[kind](_cfgs()[1], 2).items()},
           {"mlstm": JR.init_mlstm_cache,
            "slstm": JR.init_slstm_cache}[kind](_cfgs()[0], 2), atol=0.0)
    if kind == "slstm":
        assert tuple(got["ffn"]["up"]["w"].shape) == (768, 1024)
        assert tuple(got["r"].shape) == (4, 4, 192, 192)


def test_convert_unstacks_the_published_groups():
    """At xlstm-125m's depth of 12 the reference stacks (m, m, m, s) x 3:
    ``params_from_reference`` unstacks it into 12 layers in stack order,
    each sLSTM's ``r`` (4, H, dh, dh) and its nested ``ffn`` /
    ``ffn_norm`` carried leaf for leaf."""
    jc, tc = _cfgs(n_layers=12)
    assert TM.model_groups(tc) == ((tuple(
        TM.LayerSpec(k, "none") for k in ("mlstm",) * 3 + ("slstm",)), 3),)
    jparams = _np(JM.LM(jc).init(jax.random.key(4)))
    params = params_from_reference(tc, jparams)
    assert [next(k for k in lp if k != "ln1") for lp in params["layers"]] \
        == list(jget_config(ARCH).pattern)
    for i, lp in enumerate(params["layers"]):
        group = jparams["groups"][0][str(i % 4)]
        want = jax.tree.map(lambda a, r=i // 4: a[r], group)
        _close(lp, want, atol=0.0)
    assert tuple(params["layers"][3]["slstm"]["r"].shape) == (4, 4, 16, 16)
    assert set(params["layers"][3]["slstm"]) == {"w_in", "r", "gn", "ffn",
                                                 "ffn_norm"}


# ------------------------------------------------------------ whole LM
S_LM = 300
GEN = 6


@pytest.fixture(scope="module")
def lm_run():
    """The reference once: weights, prompt, forward logits, prefill logits
    and cache, 6 greedy decode steps' logits and the cache after them."""
    jc, tc = _cfgs()
    model = JM.LM(jc)
    params = model.init(jax.random.key(7))
    tokens = np.random.default_rng(7).integers(0, jc.vocab_size, (2, S_LM))
    jtok = jnp.asarray(tokens, jnp.int32)
    flogits, _ = jax.jit(model.forward)(params, {"tokens": jtok})
    cache, logits = jax.jit(model.prefill, static_argnums=2)(
        params, {"tokens": jtok}, S_LM + GEN)
    prefill = (_np(cache), np.asarray(logits))
    decode_fn = jax.jit(model.decode_step)
    steps, toks = [], []
    for _ in range(GEN):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = decode_fn(params, cache, tok)
        toks.append(np.asarray(tok))
        steps.append(np.asarray(logits))
    return dict(tcfg=tc, params=_np(params), tokens=tokens,
                forward=np.asarray(flogits), prefill=prefill, steps=steps,
                toks=toks, final=_np(cache))


def test_lm_forward_prefill_and_decode_match_reference(lm_run):
    run = lm_run
    tc = run["tcfg"]
    model = LM(tc)
    params = params_from_reference(tc, run["params"])
    assert len(params["layers"]) == tc.n_layers
    tokens = torch.from_numpy(run["tokens"])
    counters = (kfa.flash_attention_launches, krg.rglru_scan_launches)
    n0 = [c.count for c in counters]
    with torch.inference_mode():
        logits, aux = model.forward(params, {"tokens": tokens})
        _close(logits, run["forward"], **TOL_MODEL)
        assert float(aux) == 0.0
        cache, logits = model.prefill(params, {"tokens": tokens}, S_LM + GEN)
    assert [c.count for c in counters] == n0  # no kernel in the family
    jcache, jlogits = run["prefill"]
    _close(logits, jlogits, **TOL_MODEL)
    assert cache["pos"].tolist() == jcache["pos"].tolist() == [S_LM] * 2
    want_layers = unstack_groups(tc, jcache["layers"])
    assert len(cache["layers"]) == len(want_layers) == tc.n_layers
    for got, want in zip(cache["layers"], want_layers):
        _close(got, want, **TOL_MODEL)
    with torch.inference_mode():
        for tok, want in zip(run["toks"], run["steps"]):
            got_tok = torch.argmax(logits, dim=-1)
            assert got_tok.tolist() == tok.tolist()
            logits, cache = model.decode_step(params, cache, got_tok)
            _close(logits, want, **TOL_MODEL)
    assert cache["pos"].tolist() == run["final"]["pos"].tolist()
    for got, want in zip(cache["layers"],
                         unstack_groups(tc, run["final"]["layers"])):
        _close(got, want, **TOL_MODEL)


def test_init_cache_matches_reference():
    jc, tc = _cfgs()
    want = JM.LM(jc).init_cache(3, 50)
    got = LM(tc).init_cache(3, 50, device="cpu")
    want_layers = unstack_groups(tc, _np(want["layers"]))
    assert len(got["layers"]) == len(want_layers) == 4
    for g, w in zip(got["layers"], want_layers):
        _close(g, w, atol=0.0)


def test_loss_and_gradients_match_reference():
    """``LM.loss`` and its gradients (every block's, the tied table's),
    remat "none" and "full"."""
    jc, tc = _cfgs()
    jparams = JM.LM(jc).init(jax.random.key(11))
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (2, 41))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": labels.astype(np.int32)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        JM.LM(jc).loss, has_aux=True)(jparams, jbatch)
    want = params_from_reference(tc, _np(jgrads))
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tc, remat=remat)
        params = params_from_reference(cfg, _np(jparams))
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
def test_serve_matches_reference_tokens():
    """``serve(..., device="cpu", params=...)`` on the reference's own
    weights (converted) gives the reference ``serve``'s tokens."""
    jc = jget_config(ARCH).reduced()
    want = jserve.serve(ARCH, 2, 20, 6, reduced=True, seed=3,
                        log=lambda *a: None)
    params = _np(JM.LM(jc).init(jax.random.key(3)))
    got = tserve.serve(ARCH, 2, 20, 6, reduced=True, seed=3, device="cpu",
                       params=params_from_reference(_cfgs()[1], params),
                       log=lambda *a: None)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_cli_runs_xlstm(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch xlstm-125m --reduced
    --device cpu``; at full size with no ``--device`` it asks for the
    card before it makes anything."""
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "10", "--gen", "3"])
    assert "generated shape: (2, 3)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(ARCH, 4, 3000, 64, reduced=False)


# ------------------------------------------------------------ training
def test_train_matches_reference(monkeypatch):
    """``launch.train.train("xlstm-125m", reduced=True, device="cpu")``
    from the reference's initial state (its ``init_train_state`` at the
    same seed, carried over) on the reference pipeline's batches: every
    step's logged loss, and the last loss at 1e-5 relative."""
    jc, _ = _cfgs()
    monkeypatch.setattr(T.S, "init_train_state", lambda cfg, seed, dev:
                        train_state_from_reference(cfg, _np(
                            JS.init_train_state(jc, jax.random.key(seed)))))
    kw = dict(reduced=True, warmup=1, seed=2, log_every=1)
    jlog, tlog = [], []
    want = JT.train(ARCH, 3, 2, 24, log=jlog.append, **kw)
    got = T.train(ARCH, 3, 2, 24, device="cpu", log=tlog.append, **kw)
    losses = [[float(re.search(r"loss=([\d.]+)", line).group(1))
               for line in log] for log in (jlog, tlog)]
    assert len(losses[0]) == len(losses[1]) == 3
    np.testing.assert_allclose(losses[1], losses[0], rtol=0, atol=1.5e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
