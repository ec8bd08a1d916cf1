"""The port's LM serving path against the JAX reference, on the CPU.

Each model module of ``repro_torch.models`` is held against its
counterpart in ``repro.models`` on the same float32 weights and inputs
(weights drawn by the reference's own init, carried over as numpy;
inputs made with numpy from a seed); then the whole ``LM`` — prefill
logits and caches, then 8 decode steps — for reduced ``recurrentgemma-2b``
(3 layers, and 8 layers so that a group repeats and a tail group
follows), reduced ``granite-8b``, ``granite-3-8b`` and
``phi3-medium-14b``, with prompts shorter and longer than
the reduced window of 32, and the MoE family: reduced
``granite-moe-3b-a800m`` (GQA, MoE) and ``deepseek-v2-lite-16b`` (MLA,
a dense first layer, then MoE layers) at depth 3; the registry's ten
architectures, each served reduced on the CPU; ``serve`` against the
reference's ``serve`` token for token; and, for the MoE family, ``loss``
(its router aux loss included) and its gradients against
``jax.value_and_grad``.  The JAX outputs are made once per module
(fixtures).

Tolerances, float32 throughout: 1e-5 absolute for one layer's outputs
(O(1) values, the same operations in other orders); 1e-4 absolute for
whole-model logits and caches, where those differences pass through up
to 8 layers.  Greedy tokens must be equal.  The MoE loss 1e-5 relative
and its gradients 1e-4 of each leaf's largest magnitude, as
``tests/test_torch_train.py`` holds the dense LM's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import list_archs as jlist_archs
from repro.launch import serve as jserve
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import recurrent as JR
from repro_torch.configs import get_config, list_archs
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rglru_scan as krg
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import LM
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import recurrent as TR
from repro_torch.models.convert import params_from_reference, unstack_groups

ATOL_LAYER = 1e-5
ATOL_MODEL = 1e-4


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
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _cfgs(arch, **over):
    return (jget_config(arch).reduced(**over),
            get_config(arch).reduced(**over))


def _x(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-8b",
                                  "granite-3-8b", "phi3-medium-14b",
                                  "granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b",
                                  "command-r-plus-104b", "whisper-medium",
                                  "llava-next-34b", "xlstm-125m"])
def test_configs_match_reference(arch):
    """The port's copies of the configs are the reference's, field for
    field (less ``use_pallas``), full size and reduced, with the same
    layer groups and parameter count (full size too)."""
    for jc, tc in ((jget_config(arch), get_config(arch)), _cfgs(arch),
                   _cfgs(arch, n_layers=8)):
        want = dataclasses.asdict(jc)
        want.pop("use_pallas")
        assert dataclasses.asdict(tc) == want
        assert tc.layer_groups() == jc.layer_groups()
        assert tc.pattern == jc.pattern
    jc, tc = _cfgs(arch, n_layers=8)
    assert tc.param_count() == jc.param_count()
    assert get_config(arch).param_count() == jget_config(arch).param_count()


def test_registry_lists_the_reference_archs():
    """All ten of the reference's architectures, in its order; an unknown
    name raises ``KeyError`` as the reference's ``get_config`` does;
    ``LM`` constructs for each, and refuses a family, position kind or
    layer kind the reference does not define."""
    assert list_archs() == jlist_archs()
    assert len(list_archs()) == 10
    for get in (get_config, jget_config):
        with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
            get("no-such-arch")
    for name in list_archs():
        assert LM(get_config(name)).cfg.name == name
    cfg = get_config("granite-8b")
    for bad in (dict(family="rnn"), dict(pos_kind="alibi"),
                dict(block_pattern=("mamba",))):
        with pytest.raises(NotImplementedError, match="not defined by the "
                           "reference"):
            LM(dataclasses.replace(cfg, **bad))


@pytest.mark.parametrize("arch", jlist_archs())
def test_serve_runs_every_arch_on_the_cpu(arch):
    """``serve(arch, reduced=True, device="cpu")`` for each of the
    reference's ten architectures: greedy tokens of the right shape, in
    the vocabulary."""
    seqs = tserve.serve(arch, 2, 12, 4, reduced=True, device="cpu",
                        log=lambda *a: None)
    assert seqs.shape == (2, 4)
    assert 0 <= seqs.min() and seqs.max() < get_config(arch).reduced(
    ).vocab_size


# ------------------------------------------------------------- layers
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm(kind):
    jc, tc = _cfgs("granite-8b", norm=kind)
    p = JL.init_norm(64, jc)
    rng = np.random.default_rng(1)
    p = {k: jnp.asarray(rng.normal(1, 0.3, v.shape), jnp.float32)
         for k, v in p.items()}
    x = _x((2, 5, 64), scale=3.0)
    _close(TL.apply_norm(_t(p), torch.from_numpy(x), 1e-5),
           JL.apply_norm(p, jnp.asarray(x), 1e-5), ATOL_LAYER)


def test_rope_prefill_and_decode_positions():
    x = _x((2, 7, 3, 16))
    want = JL.apply_rope(jnp.asarray(x), jnp.arange(7), 10_000.0)
    got = TL.apply_rope(torch.from_numpy(x), torch.arange(7), 10_000.0)
    _close(got, want, ATOL_LAYER)
    x1 = _x((2, 1, 3, 16), seed=2)
    pos = np.array([[5], [40]])
    _close(TL.apply_rope(torch.from_numpy(x1), torch.from_numpy(pos), 1e4),
           JL.apply_rope(jnp.asarray(x1), jnp.asarray(pos), 1e4), ATOL_LAYER)


@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_mlp(act):
    jc, tc = _cfgs("granite-8b", act=act)
    p = JL.init_mlp(jax.random.key(0), 64, 128, jc)
    x = _x((2, 5, 64))
    _close(TL.mlp(_t(p), torch.from_numpy(x), tc),
           JL.mlp(p, jnp.asarray(x), jc), ATOL_LAYER)


def test_embed_and_unembed_with_softcap():
    jc, tc = _cfgs("recurrentgemma-2b")
    p = JL.init_embedding(jax.random.key(1), 257, 64, jc)
    tok = np.random.default_rng(0).integers(0, 257, (2, 6))
    _close(TL.embed(_t(p), torch.from_numpy(tok), torch.float32),
           JL.embed(p, jnp.asarray(tok), jnp.float32), ATOL_LAYER)
    x = _x((2, 64), scale=40.0)  # logits large enough for the cap to bite
    _close(TL.unembed(_t(p), torch.from_numpy(x), softcap=30.0),
           JL.unembed(p, jnp.asarray(x), softcap=30.0), ATOL_LAYER)


# ----------------------------------------------------------- recurrent
def test_causal_conv_and_conv_decode():
    jc, _ = _cfgs("recurrentgemma-2b")
    p = JR.init_conv(jax.random.key(2), 4, 64, jc)
    x = _x((2, 9, 64))
    _close(TR.causal_conv(_t(p), torch.from_numpy(x)),
           JR.causal_conv(p, jnp.asarray(x)), ATOL_LAYER)
    buf, x1 = _x((2, 3, 64), seed=3), _x((2, 64), seed=4)
    y, nb = TR.conv_decode(_t(p), torch.from_numpy(x1), torch.from_numpy(buf))
    jy, jnb = JR.conv_decode(p, jnp.asarray(x1), jnp.asarray(buf))
    _close(y, jy, ATOL_LAYER)
    _close(nb, jnb, 0.0)


@pytest.mark.parametrize("S", [2, 11])
def test_rglru_forward_cache_and_decode(S):
    """Prompts shorter than the conv width (a left-padded conv buffer) and
    longer; then two decode steps from the prefill's cache."""
    jc, tc = _cfgs("recurrentgemma-2b")
    p = JR.init_rglru_block(jax.random.key(3), jc)
    tp = _t(p)
    x = _x((2, S, 64))
    y, cache = TR.rglru_forward(tp, torch.from_numpy(x), tc,
                                return_cache=True)
    jy, jcache = JR.rglru_forward(p, jnp.asarray(x), jc, return_cache=True)
    _close(y, jy, ATOL_LAYER)
    _close(cache, jcache, ATOL_LAYER)
    for t in cache.values():  # owns its memory: no view of a (B,S,·) tensor
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    for step in range(2):
        x1 = _x((2, 1, 64), seed=10 + step)
        y, cache = TR.rglru_decode(tp, torch.from_numpy(x1), cache, tc)
        jy, jcache = JR.rglru_decode(p, jnp.asarray(x1), jcache, jc)
        _close(y, jy, ATOL_LAYER)
        _close(cache, jcache, ATOL_LAYER)


# ----------------------------------------------------------- attention
@pytest.mark.parametrize("window", [0, 8])
def test_attn_forward(window):
    jc, tc = _cfgs("recurrentgemma-2b")
    p = JA.init_attention(jax.random.key(4), jc)
    x = _x((2, 20, 64))
    y, kv = TA.attn_forward(_t(p), torch.from_numpy(x), torch.arange(20), tc,
                            window=window, return_kv=True)
    jy, jkv = JA.attn_forward(p, jnp.asarray(x), jnp.arange(20), jc,
                              window=window, return_kv=True)
    _close(y, jy, ATOL_LAYER)
    _close(kv, jkv, ATOL_LAYER)


@pytest.mark.parametrize("S,cache_len,window", [
    (10, 30, 0), (10, 30, 16), (20, 30, 16), (37, 40, 16), (16, 20, 16)])
def test_pad_kv(S, cache_len, window):
    """Dense caches zero-padded; window caches a ring whose offset is
    (S - keep) % buf_len, shorter and longer prompts than the ring."""
    jc, tc = _cfgs("recurrentgemma-2b")
    kv = {"k": _x((2, S, 1, 16)), "v": _x((2, S, 1, 16), seed=1)}
    got = TM._pad_kv({n: torch.from_numpy(a) for n, a in kv.items()},
                     cache_len, window, tc)
    want = JM._pad_kv({n: jnp.asarray(a) for n, a in kv.items()},
                      cache_len, window, jc)
    _close(got, want, 0.0)


@pytest.mark.parametrize("window", [0, 8])
def test_cache_positions(window):
    pos = np.array([0, 3, 7, 8, 21])
    got = TA._cache_positions(torch.from_numpy(pos), 8, window)
    want = JA._cache_positions(jnp.asarray(pos), 8, window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window", [0, 8])
def test_attn_decode(window):
    """Two decode steps from a filled cache, past the ring's end when a
    window is set, with GQA (4 query heads over 2 KV heads)."""
    jc, tc = _cfgs("granite-8b")
    p = JA.init_attention(jax.random.key(5), jc)
    tp = _t(p)
    S = 8 if window else 24
    cache = {"k": _x((2, S, 2, 16), seed=1), "v": _x((2, S, 2, 16), seed=2)}
    jcache = {n: jnp.asarray(a) for n, a in cache.items()}
    tcache = {n: torch.from_numpy(a.copy()) for n, a in cache.items()}
    pos = np.array([11, 12]) if window else np.array([5, 12])
    for step in range(2):
        x = _x((2, 1, 64), seed=20 + step)
        y, tcache = TA.attn_decode(tp, torch.from_numpy(x), tcache,
                                   torch.from_numpy(pos + step), tc,
                                   window=window)
        jy, jcache = JA.attn_decode(p, jnp.asarray(x), jcache,
                                    jnp.asarray(pos + step), jc,
                                    window=window)
        _close(y, jy, ATOL_LAYER)
        _close(tcache, jcache, ATOL_LAYER)


# ------------------------------------------------------------ whole LM
LM_CASES = {
    # name: (arch, overrides, prompt length)
    "rg3_short": ("recurrentgemma-2b", {}, 20),
    "rg3_long": ("recurrentgemma-2b", {}, 45),
    "rg8_long": ("recurrentgemma-2b", {"n_layers": 8}, 45),
    "granite": ("granite-8b", {}, 24),
    "granite3": ("granite-3-8b", {}, 24),
    "phi3": ("phi3-medium-14b", {}, 20),
    "granite_moe": ("granite-moe-3b-a800m", {"n_layers": 3}, 24),
    "deepseek": ("deepseek-v2-lite-16b", {"n_layers": 3}, 20),
}
GEN = 8


@pytest.fixture(scope="module")
def lm_runs():
    """Each case once through the JAX reference: weights, prompts,
    prefill logits and cache, and 8 greedy decode steps' logits."""
    runs = {}
    for name, (arch, over, S) in LM_CASES.items():
        jc, tc = _cfgs(arch, **over)
        model = JM.LM(jc)
        params = model.init(jax.random.key(7))
        tokens = np.random.default_rng(7).integers(0, jc.vocab_size, (2, S))
        prefill_fn = jax.jit(model.prefill, static_argnums=2)
        decode_fn = jax.jit(model.decode_step)
        cache, logits = prefill_fn(params, {"tokens": jnp.asarray(tokens)},
                                   S + GEN)
        prefill = (_np(cache), np.asarray(logits))
        steps, toks = [], []
        for _ in range(GEN):
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            logits, cache = decode_fn(params, cache, tok)
            toks.append(np.asarray(tok))
            steps.append(np.asarray(logits))
        runs[name] = dict(jcfg=jc, tcfg=tc, params=_np(params), tokens=tokens,
                          prefill=prefill, steps=steps, toks=toks)
    return runs


@pytest.mark.parametrize("name", list(LM_CASES))
def test_lm_prefill_and_decode_match_reference(lm_runs, name):
    run = lm_runs[name]
    tc, S = run["tcfg"], run["tokens"].shape[1]
    model = LM(tc)
    params = params_from_reference(tc, run["params"])
    assert len(params["layers"]) == tc.n_layers
    with torch.inference_mode():
        cache, logits = model.prefill(
            params, {"tokens": torch.from_numpy(run["tokens"])}, S + GEN)
    jcache, jlogits = run["prefill"]
    _close(logits, jlogits, ATOL_MODEL)
    assert cache["pos"].tolist() == jcache["pos"].tolist()
    want_layers = unstack_groups(tc, jcache["layers"])
    assert len(cache["layers"]) == len(want_layers)
    for got, want in zip(cache["layers"], want_layers):
        _close(got, want, ATOL_MODEL)
    with torch.inference_mode():
        for tok, want in zip(run["toks"], run["steps"]):
            got_tok = torch.argmax(logits, dim=-1)
            assert got_tok.tolist() == tok.tolist()
            logits, cache = model.decode_step(params, cache, got_tok)
            _close(logits, want, ATOL_MODEL)


@pytest.mark.parametrize("arch,over", [("recurrentgemma-2b", {"n_layers": 8}),
                                       ("granite-8b", {}),
                                       ("deepseek-v2-lite-16b",
                                        {"n_layers": 3})])
def test_init_cache_matches_reference(arch, over):
    """Zeroed decode caches of the same shapes and values, layer by layer
    (a window ring of min(cache_len, window) slots for local attention)."""
    jc, tc = _cfgs(arch, **over)
    want = JM.LM(jc).init_cache(3, 50)
    got = LM(tc).init_cache(3, 50, device="cpu")
    assert got["pos"].tolist() == np.asarray(want["pos"]).tolist()
    want_layers = unstack_groups(tc, _np(want["layers"]))
    assert len(got["layers"]) == len(want_layers) == tc.n_layers
    for g, w in zip(got["layers"], want_layers):
        assert {k: tuple(v.shape) for k, v in g.items()} == \
            {k: v.shape for k, v in w.items()}
        _close(g, w, 0.0)


@pytest.mark.parametrize("arch,prompt_len", [("recurrentgemma-2b", 40),
                                             ("granite-8b", 12),
                                             ("granite-moe-3b-a800m", 12),
                                             ("deepseek-v2-lite-16b", 12)])
def test_serve_matches_reference_tokens(arch, prompt_len):
    """``serve(..., device="cpu", params=...)`` on the reference's own
    weights (converted) gives the reference ``serve``'s tokens, and its
    prefill reaches both kernels' wrappers (which take their plain
    versions on the CPU, so the launch counters do not move)."""
    jc = jget_config(arch).reduced()
    want = jserve.serve(arch, 2, prompt_len, 6, reduced=True, seed=3,
                        log=lambda *a: None)
    params = _np(JM.LM(jc).init(jax.random.key(3)))
    n_fa = kfa.flash_attention_launches.count
    n_rg = krg.rglru_scan_launches.count
    got = tserve.serve(arch, 2, prompt_len, 6, reduced=True, seed=3,
                       device="cpu",
                       params=params_from_reference(get_config(arch)
                                                    .reduced(), params),
                       log=lambda *a: None)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert kfa.flash_attention_launches.count == n_fa
    assert krg.rglru_scan_launches.count == n_rg


def test_serve_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve("recurrentgemma-2b", 1, 4, 2)


def test_serve_own_weights_run_the_cli(capsys):
    tserve.main(["--arch", "recurrentgemma-2b", "--reduced", "--device",
                 "cpu", "--batch", "2", "--prompt-len", "40", "--gen", "4"])
    assert "generated shape: (2, 4)" in capsys.readouterr().out


# ------------------------------------------------------------- MoE loss
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_loss_and_gradients_match_reference(arch):
    """``LM.loss`` (cross entropy plus ``router_aux_weight`` x the aux
    loss summed over the MoE layers) and its gradients, at depth 3, on
    the reference's weights; remat "full" gives the same."""
    jc, tc = _cfgs(arch, n_layers=3)
    jparams = JM.LM(jc).init(jax.random.key(11))
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (2, 25))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": labels.astype(np.int32)}
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        JM.LM(jc).loss, has_aux=True)(
            jparams, jax.tree.map(jnp.asarray, batch))
    assert float(jmetrics["aux"]) > 0
    want = params_from_reference(tc, _np(jgrads))
    tbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(tc, remat=remat)
        params = params_from_reference(cfg, _np(jparams))
        loss, metrics, grads = tsteps.loss_and_grads(LM(cfg), params, tbatch)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["aux"]),
                                   float(jmetrics["aux"]), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["ce"]),
                                   float(jmetrics["ce"]), rtol=1e-5)
        got, ref_ = list(TM.tensors(grads)), list(TM.tensors(want))
        assert len(got) == len(ref_)
        for g, w in zip(got, ref_):
            w = w.numpy()
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-4 * max(np.abs(w).max(), 1e-12), (err, g.shape)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_serve_cli_runs_the_moe_family(arch, capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch ...`` serves the MoE
    family (reduced, on the CPU); at full size with no ``--device`` it
    asks for the card before it makes anything."""
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "20", "--gen", "3"])
    assert "generated shape: (2, 3)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(arch, 4, 3000, 64, reduced=False)
