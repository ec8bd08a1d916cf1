"""The port's VLM family (llava-next-34b: a decoder over a prefix of
precomputed patch embeddings) against the JAX reference, on the CPU.

llava-next-34b at ``cfg.reduced()`` (2 layers, d 64, GQA 4 / 2 heads of
16, 8 stub image tokens), float32, on the reference's own weights carried
over by ``params_from_reference`` and inputs made with numpy from fixed
seeds: ``forward`` (logits of the text positions only), ``loss`` and its
gradients, remat "none" and "full"; ``prefill`` and 15 greedy
``decode_step``s against the reference's ``LM.prefill`` /
``decode_step`` called directly with a cache of n_img + prompt + gen
positions; the port's ``serve``, whose cache holds the prefix too, so
that it decodes past prompt + gen - n_img positions with its logits
still those of one ``forward`` over the same tokens; and the attention
kernel's plain version at llava's grouping of 7 query heads a KV head
against the JAX oracle.

The reference's ``launch/serve.py`` sizes its cache prompt + gen and so
leaves the prefix out (ROADMAP.md §3): its decode overruns the cache, so
no test holds the port's VLM ``serve`` against it.

Tolerances, float32 throughout, as ``tests/test_torch_lm.py`` holds the
other families: 1e-4 absolute for whole-model logits and caches, greedy
tokens equal, the loss 1e-5 relative and its gradients 1e-4 of each
leaf's largest magnitude (a floor of 1e-6 of the largest gradient of
all); the attention oracle 2e-5 (float32) and 2e-2 (bf16) absolute, as
``tests/test_torch_kernels_lm.py`` holds it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget_config
from repro.kernels import ref as jref
from repro.models import model as JM
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import LM
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_reference, unstack_groups

ARCH = "llava-next-34b"
ATOL_MODEL = 1e-4
N_IMG = 8
PROMPT, GEN = 16, 16


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


def _cfgs(**over):
    return jget_config(ARCH).reduced(**over), get_config(ARCH).reduced(**over)


def _img(B, seed=8):
    return np.random.default_rng(seed).standard_normal(
        (B, N_IMG, 64)).astype(np.float32)


def _tbatch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype.kind == "i"
            else torch.from_numpy(v) for k, v in batch.items()}


def test_reduced_config_sizes():
    jc, tc = _cfgs()
    assert (tc.family, tc.n_layers, tc.n_img_tokens) == ("vlm", 2, N_IMG)
    assert (tc.n_heads, tc.n_kv_heads, tc.hd) == (4, 2, 16)
    assert jc.n_img_tokens == N_IMG
    full = get_config(ARCH)
    assert (full.n_heads // full.n_kv_heads, full.hd) == (7, 128)


# ------------------------------------------------------- training side
def test_forward_loss_and_gradients_match_reference():
    """``LM.forward``: the image prefix in front of the token embeddings,
    positions over both, logits of the text positions only; ``LM.loss``
    and its gradients, remat "none" and "full"."""
    jc, tc = _cfgs()
    jparams = JM.LM(jc).init(jax.random.key(11))
    toks = np.random.default_rng(11).integers(0, jc.vocab_size, (2, 17))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": labels.astype(np.int32), "img_embeds": _img(2)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    jlogits, _ = JM.LM(jc).forward(jparams, jbatch)
    assert jlogits.shape == (2, 16, jc.vocab_size)
    (jloss, jmetrics), jgrads = jax.value_and_grad(
        JM.LM(jc).loss, has_aux=True)(jparams, jbatch)
    want = params_from_reference(tc, _np(jgrads))
    tbatch = _tbatch(batch)
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


def test_prefix_changes_the_text_logits():
    """The text attends to the prefix: other image embeddings, other
    logits (the prefix is not dropped on the way)."""
    _, tc = _cfgs()
    params = LM(tc).init(seed=2, device="cpu")
    toks = np.random.default_rng(2).integers(0, tc.vocab_size, (2, 6))
    with torch.no_grad():
        a, _ = LM(tc).forward(params, _tbatch({"tokens": toks,
                                               "img_embeds": _img(2, 1)}))
        b, _ = LM(tc).forward(params, _tbatch({"tokens": toks,
                                               "img_embeds": _img(2, 2)}))
    assert a.shape == (2, 6, tc.vocab_size)
    assert float((a - b).abs().max()) > 1e-2


# ------------------------------------------------------------ serving
@pytest.fixture(scope="module")
def lm_run():
    """The reference's ``LM.prefill`` and 15 greedy ``decode_step``s at a
    cache of n_img + prompt + gen positions: weights, inputs, prefill
    logits and cache, each step's logits and the cache after them."""
    jc, tc = _cfgs()
    model = JM.LM(jc)
    params = model.init(jax.random.key(7))
    batch = {"tokens": np.random.default_rng(7).integers(
        0, jc.vocab_size, (2, PROMPT)).astype(np.int32),
        "img_embeds": _img(2, 9)}
    cache_len = N_IMG + PROMPT + GEN
    cache, logits = jax.jit(model.prefill, static_argnums=2)(
        params, jax.tree.map(jnp.asarray, batch), cache_len)
    prefill = (_np(cache), np.asarray(logits))
    decode_fn = jax.jit(model.decode_step)
    steps, toks = [], []
    for _ in range(GEN - 1):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, cache = decode_fn(params, cache, tok)
        toks.append(np.asarray(tok))
        steps.append(np.asarray(logits))
    return dict(tcfg=tc, params=_np(params), batch=batch, prefill=prefill,
                steps=steps, toks=toks, final=_np(cache),
                cache_len=cache_len)


def test_prefill_and_decode_match_reference(lm_run):
    """Prefill logits and every cache entry (the prefix's keys and values
    in its first n_img rows), ``pos`` = n_img + prompt, then 15 greedy
    decode steps, each step's logits and the cache after them."""
    run = lm_run
    tc = run["tcfg"]
    model = LM(tc)
    params = params_from_reference(tc, run["params"])
    n0 = kfa.flash_attention_launches.count
    with torch.inference_mode():
        cache, logits = model.prefill(params, _tbatch(run["batch"]),
                                      run["cache_len"])
    assert kfa.flash_attention_launches.count == n0  # plain on the CPU
    jcache, jlogits = run["prefill"]
    _close(logits, jlogits, ATOL_MODEL)
    assert cache["pos"].tolist() == jcache["pos"].tolist() == \
        [N_IMG + PROMPT] * 2
    for got, want in zip(cache["layers"],
                         unstack_groups(tc, jcache["layers"])):
        assert tuple(got["k"].shape) == (2, run["cache_len"], 2, 16)
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


def test_serve_cache_holds_the_prefix(lm_run, monkeypatch):
    """``serve`` sizes its cache n_img + prompt + gen: its prefill gets
    that ``cache_len``, it decodes to position n_img + prompt + gen - 2,
    past the prompt + gen - n_img positions a cache without the prefix
    leaves room for, and every step's logits are those of one
    ``forward`` over the prompt and the tokens before the step (the
    image embeddings drawn right after the prompts, as the reference's
    ``serve`` draws them); its tokens are the reference model's at the
    right cache length."""
    tc = lm_run["tcfg"]
    seen = {"logits": [], "pos": []}
    prefill, decode_step = TM.LM.prefill, TM.LM.decode_step

    def spy_prefill(self, params, batch, cache_len):
        seen.update(cache_len=cache_len, batch=batch)
        cache, logits = prefill(self, params, batch, cache_len)
        seen["logits"].append(logits.clone())
        return cache, logits

    def spy_decode(self, params, cache, tokens):
        seen["pos"].append(int(cache["pos"][0]))
        logits, cache = decode_step(self, params, cache, tokens)
        seen["logits"].append(logits.clone())
        return logits, cache

    monkeypatch.setattr(TM.LM, "prefill", spy_prefill)
    monkeypatch.setattr(TM.LM, "decode_step", spy_decode)
    params = params_from_reference(tc, lm_run["params"])
    seqs = tserve.serve(ARCH, 2, PROMPT, GEN, reduced=True, seed=5,
                        device="cpu", params=params, log=lambda *a: None)
    monkeypatch.undo()
    assert seqs.shape == (2, GEN)
    assert seen["cache_len"] == N_IMG + PROMPT + GEN
    assert seen["pos"][-1] == N_IMG + PROMPT + GEN - 2 > PROMPT + GEN
    rng = np.random.default_rng(5)
    prompts = rng.integers(0, tc.vocab_size, (2, PROMPT))
    img = rng.normal(0, 1, (2, N_IMG, tc.d_model))
    assert np.array_equal(seen["batch"]["tokens"].numpy(), prompts)
    np.testing.assert_array_equal(seen["batch"]["img_embeds"].numpy(),
                                  img.astype(np.float32))
    full = np.concatenate([prompts, seqs[:, :-1]], axis=1)
    with torch.no_grad():
        logits, _ = LM(tc).forward(params, {
            "tokens": torch.from_numpy(full),
            "img_embeds": seen["batch"]["img_embeds"]})
    assert len(seen["logits"]) == GEN
    for i, lg in enumerate(seen["logits"]):
        _close(lg, logits[:, PROMPT - 1 + i], ATOL_MODEL)
    # the reference model at the right cache length picks the same tokens
    jc = jget_config(ARCH).reduced()
    model = JM.LM(jc)
    jparams = jax.tree.map(jnp.asarray, lm_run["params"])
    cache, jl = model.prefill(jparams, {
        "tokens": jnp.asarray(prompts, jnp.int32),
        "img_embeds": jnp.asarray(img, jnp.float32)}, N_IMG + PROMPT + GEN)
    want = []
    decode_fn = jax.jit(model.decode_step)
    for _ in range(GEN):
        tok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
        want.append(np.asarray(tok))
        jl, cache = decode_fn(jparams, cache, tok)
    np.testing.assert_array_equal(seqs, np.stack(want, axis=1))


def test_prefill_refuses_a_cache_shorter_than_the_prefix_and_prompt():
    """A cache of prompt + gen positions, with gen shorter than the prefix,
    cannot hold the prefill: it raises (the reference's ``_pad_kv``
    raises too) rather than cutting the prefix's rows."""
    _, tc = _cfgs()
    params = LM(tc).init(seed=3, device="cpu")
    batch = _tbatch({"tokens": np.zeros((1, PROMPT), np.int64),
                     "img_embeds": _img(1)})
    with pytest.raises(ValueError, match="does not fit"):
        LM(tc).prefill(params, batch, PROMPT + N_IMG - 1)


def test_serve_cli_runs_llava(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch llava-next-34b
    --reduced --device cpu``; at full size with no ``--device`` it asks
    for the card before it makes anything."""
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "10", "--gen", "3"])
    assert "generated shape: (2, 3)" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tserve.serve(ARCH, 4, 1024, 64, reduced=False)


# ------------------------------------------------------------- kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 128])
def test_flash_plain_path_at_seven_query_heads_a_kv_head(D, dtype):
    """``ops.flash_attention`` on CPU tensors (its plain version) at
    llava's grouping, 14 query heads over 2 KV heads, causal, a prompt
    past the kernel's 64-row tiles, against the JAX oracle."""
    B, S, H, K = 2, 70, 14, 2
    rng = np.random.default_rng(D)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D))]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx = [jnp.asarray(a, jdt) for a in arrs]
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
          for a in jx]
    want = np.asarray(jref.flash_attention_ref(*jx, causal=True)
                      .astype(jnp.float32))
    n0 = kfa.flash_attention_launches.count
    got = ops.flash_attention(*tx, causal=True)
    assert kfa.flash_attention_launches.count == n0
    assert got.dtype == tdt and tuple(got.shape) == (B, S, H, D)
    atol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=atol)
    np.testing.assert_allclose(
        ref.flash_attention_ref(*tx, causal=True).float().numpy(), want,
        rtol=0, atol=atol)
