"""The port's LM training path against the JAX reference, on the CPU.

Both packages get the same numpy inputs and the same weights (drawn by
the reference's init and carried over by ``train_state_from_reference``),
float32 on both sides:

* ``adamw_update`` (functional and donating) and the schedules against
  ``repro.optim``;
* the token pipeline, bit for bit: batches across steps, shards and
  prefetch from a resume step;
* ``LM.loss`` and its gradients against ``jax.value_and_grad`` of the
  reference's ``LM.loss``, for reduced ``recurrentgemma-2b`` at seq 48
  (past the reduced window of 32) and reduced ``granite-8b``, and the
  three remat modes against each other;
* three ``make_train_step`` steps, and ``make_accum_train_step`` with
  accum 2, against the reference's parameters after the same steps:
  recurrentgemma-2b and granite-8b on token batches, and the MoE pair,
  whisper-medium, command-r-plus-104b and llava-next-34b on both
  packages' ``concrete_inputs`` batches (frames, patch embeddings);
* ``train`` with a checkpoint: 2 steps then 2 resumed equal 4 straight.

Tolerances (float32, the same functions in other orders): the loss
1e-5 relative; gradients 1e-4 of each leaf's largest magnitude (the
reference scans the RG-LRU with ``associative_scan``, the port
sequentially, and its attention is a dense einsum against the port's
float32 kernel-order oracle); AdamW on one leaf 2e-6 (one update's
rounding); parameters after the train steps 1e-5 absolute (lr 3e-4 a
step, O(0.1) weights: an update's rounding, far below one step's
size); the global norm 1e-5 relative (the reference sums its stacked
leaves in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.configs.registry import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import TokenPipeline as JTokenPipeline
from repro.launch import steps as JS
from repro.launch import train as JT
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import cosine_schedule as jcosine
from repro.optim import global_norm as jglobal_norm
from repro.optim import linear_warmup_cosine as jwarmup
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import concrete_inputs, get_config
from repro_torch.data import DataConfig, TokenPipeline, make_batch_fn
from repro_torch.launch import steps as S
from repro_torch.launch import train as T
from repro_torch.models import LM
from repro_torch.models import layers as TL
from repro_torch.models.convert import (params_from_reference,
                                        train_state_from_reference)
from repro_torch.models.model import tensors, tree_map
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule, global_norm,
                               linear_warmup_cosine)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("clip,wd,dtype", [(0.0, 0.1, "float32"),
                                           (1.0, 0.0, "float32"),
                                           (0.5, 0.1, "bfloat16")])
def test_adamw_matches_reference(clip, wd, dtype):
    """Five updates of a two-leaf tree, clipping on and off, coupled
    decay, f32 masters with f32 or bf16 gradients, a scheduled lr: the
    parameters, moments and gradient norm of every step, the port's
    written into its given tensors."""
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(0, 1, (6, 5)).astype(np.float32),
          "b": rng.normal(0, 1, (7,)).astype(np.float32)}
    jcfg = JAdamWConfig(lr=1e-2, clip_norm=clip, weight_decay=wd)
    tcfg = AdamWConfig(lr=1e-2, clip_norm=clip, weight_decay=wd)
    jsched, tsched = jwarmup(1e-2, 2, 5), linear_warmup_cosine(1e-2, 2, 5)
    jp = jax.tree.map(jnp.asarray, p0)
    jo = jadamw_init(jp)
    tp = {k: _t(v) for k, v in p0.items()}
    to = adamw_init(tp)
    ptrs = [t.data_ptr() for t in tensors((tp, to["m"], to["v"]))]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    for _ in range(5):
        g = {k: (3 * rng.normal(0, 1, v.shape)).astype(np.float32)
             for k, v in p0.items()}
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        tg = {k: _t(np.asarray(v.astype(jnp.float32))).to(tdt)
              for k, v in jg.items()}
        jp, jo, jm = jadamw_update(jg, jo, jp, jcfg, jsched(jo["step"]))
        tp, to, tm = adamw_update(tg, to, tp, tcfg, tsched(to["step"]))
        assert [t.data_ptr() for t in tensors((tp, to["m"], to["v"]))] \
            == ptrs
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        for k in p0:
            for got, want in ((tp[k], jp[k]), (to["m"][k], jo["m"][k]),
                              (to["v"][k], jo["v"][k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=0, atol=2e-6)
        assert int(to["step"]) == int(jo["step"])


def test_adamw_donate_updates_in_place_in_chunks(monkeypatch):
    """The update writes into the given tensors (the counterpart of the
    reference's donated state), a slice of rows at a time, with the bits
    of the update of whole leaves."""
    from repro_torch.optim import adamw as A
    g = torch.Generator().manual_seed(1)
    p = {"w": torch.randn(7, 4, generator=g), "s": torch.randn((),
                                                                generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in p.items()}
    opt = adamw_init(p)
    whole = lambda t: tree_map(lambda a: a.clone(), t)  # noqa: E731
    want_p, want_o, _ = adamw_update(grads, whole(opt), whole(p),
                                     AdamWConfig())
    monkeypatch.setattr(A, "CHUNK", 10)
    ptrs = [t.data_ptr() for t in tensors((p, opt["m"], opt["v"]))]
    got_p, got_o, _ = adamw_update(grads, opt, p, AdamWConfig())
    assert [t.data_ptr() for t in tensors((got_p, got_o["m"], got_o["v"]))] \
        == ptrs
    assert len(A._row_slices(p["w"])) == 4
    for a, b in zip(tensors((got_p, got_o["m"], got_o["v"])),
                    tensors((want_p, want_o["m"], want_o["v"]))):
        assert torch.equal(a, b)


def test_global_norm_and_schedules():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert abs(float(global_norm(t)) - 5.0) < 1e-6
    tree = {"x": np.linspace(-1, 2, 30, dtype=np.float32).reshape(5, 6),
            "y": np.arange(7, dtype=np.float32)}
    np.testing.assert_allclose(
        float(global_norm({k: _t(v) for k, v in tree.items()})),
        float(jglobal_norm(jax.tree.map(jnp.asarray, tree))), rtol=1e-6)
    for tsched, jsched in ((linear_warmup_cosine(1.0, 10, 110),
                            jwarmup(1.0, 10, 110)),
                           (linear_warmup_cosine(3e-4, 0, 7),
                            jwarmup(3e-4, 0, 7)),
                           (cosine_schedule(2.0, 50, 0.2),
                            jcosine(2.0, 50, 0.2))):
        for step in [0, 1, 5, 9, 10, 11, 60, 109, 110, 200]:
            got = float(tsched(torch.tensor(step, dtype=torch.int32)))
            assert got == float(tsched(step))
            np.testing.assert_allclose(
                got, float(jsched(jnp.asarray(step, jnp.int32))),
                rtol=1e-6, atol=1e-9)


# ------------------------------------------------------------- pipeline
def test_token_pipeline_matches_reference_bit_for_bit():
    """Batches across steps and shards, and the prefetch thread started
    at a resume step, equal the reference pipeline's exactly."""
    for shards in (1, 2):
        for shard in range(shards):
            kw = dict(vocab_size=257, seq_len=33, global_batch=4, seed=3,
                      num_shards=shards, shard_id=shard)
            tp, jp = TokenPipeline(DataConfig(**kw)), JTokenPipeline(
                JDataConfig(**kw))
            for step in range(4):
                got, want = tp.batch_at(step), jp.batch_at(step)
                assert set(got) == set(want) == {"tokens", "labels"}
                for k in want:
                    assert np.array_equal(got[k], want[k])
            np.testing.assert_array_equal(
                make_batch_fn(DataConfig(**kw))(2)["tokens"],
                jp.batch_at(2)["tokens"])
    kw = dict(vocab_size=101, seq_len=16, global_batch=2, seed=5)
    pipe = TokenPipeline(DataConfig(**kw)).start_prefetch(from_step=3)
    try:
        for step in range(3, 7):
            got_step, got = pipe.next_prefetched()
            want = JTokenPipeline(JDataConfig(**kw)).batch_at(step)
            assert got_step == step
            assert all(np.array_equal(got[k], want[k]) for k in want)
    finally:
        pipe.stop_prefetch()
    with pytest.raises(RuntimeError, match="start_prefetch"):
        TokenPipeline(DataConfig(**kw)).next_prefetched()


# ----------------------------------------------------------------- loss
def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(2)
    logits = rng.normal(0, 3, (2, 9, 11)).astype(np.float32)
    labels = rng.integers(-1, 11, (2, 9))
    mask = (rng.random((2, 9)) > 0.3).astype(np.float32)
    for m in (None, mask):
        got = TL.cross_entropy(_t(logits), _t(labels),
                               None if m is None else _t(m))
        want = JL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


LOSS_CASES = {"recurrentgemma": ("recurrentgemma-2b", 48),
              "granite": ("granite-8b", 24)}


def _batch(vocab, B, S, seed):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, S + 1))
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1            # ignored positions
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": labels.astype(np.int32)}


def _torch_batch(batch):
    return {k: _t(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def loss_runs():
    """Each case once through the reference: its state, a batch, the loss
    and the gradients."""
    runs = {}
    for name, (arch, seq) in LOSS_CASES.items():
        jc = jget_config(arch).reduced()
        state = JS.init_train_state(jc, jax.random.key(3))
        batch = _batch(jc.vocab_size, 2, seq, seed=4)
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            JM.LM(jc).loss, has_aux=True))(
                state["params"], jax.tree.map(jnp.asarray, batch))
        runs[name] = dict(state=_np(state), batch=batch, loss=float(loss),
                          ce=float(metrics["ce"]),
                          tokens=int(metrics["tokens"]), grads=_np(grads))
    return runs


def _close_leaves(got, want, rtol):
    got, want = list(tensors(got)), [np.asarray(a) for a in tensors(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        err = np.abs(g.detach().float().numpy() - w).max()
        assert err <= rtol * max(np.abs(w).max(), 1e-12), (err, g.shape)


@pytest.mark.parametrize("name", list(LOSS_CASES))
def test_loss_and_gradients_match_reference(loss_runs, name):
    run = loss_runs[name]
    cfg = get_config(LOSS_CASES[name][0]).reduced()
    state = train_state_from_reference(cfg, run["state"])
    loss, metrics, grads = S.loss_and_grads(LM(cfg), state["params"],
                                            _torch_batch(run["batch"]))
    np.testing.assert_allclose(float(loss), run["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), run["ce"], rtol=1e-5)
    assert int(metrics["tokens"]) == run["tokens"]
    want = params_from_reference(cfg, run["grads"])
    _close_leaves(grads, want, 1e-4)


def test_remat_modes_give_the_same_loss_and_gradients(loss_runs):
    """"full" (checkpoint a layer), "dots" (keep the matmul outputs) and
    "none": the same loss and gradients to float32 rounding (1e-6 of each
    leaf; recomputation repeats the same operations)."""
    run = loss_runs["recurrentgemma"]
    base = get_config("recurrentgemma-2b").reduced()
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        params = train_state_from_reference(cfg, run["state"])["params"]
        out[remat] = S.loss_and_grads(LM(cfg), params,
                                      _torch_batch(run["batch"]))
    for remat in ("dots", "full"):
        assert float(out[remat][0]) == pytest.approx(float(out["none"][0]),
                                                     rel=1e-6)
        _close_leaves(out[remat][2], tree_map(lambda a: a.numpy(),
                                              out["none"][2]), 1e-6)


def test_tied_table_gradients_meet_in_float32(monkeypatch):
    """A float32 tied table under a bf16 compute dtype (the population on
    the card): its gradient is the float32 sum of the gradients of its two
    uses, bit for bit as two casts of their own give it (the reference
    casts at each use), through autograd and through ``torch.func.grad``;
    one shared cast would sum them in bf16."""
    from repro_torch.models import model as M
    cfg = get_config("recurrentgemma-2b").reduced(dtype="bfloat16")
    model = LM(cfg)
    params = model.init(0, "cpu")
    assert params["embed"]["table"].dtype == torch.float32
    batch = _torch_batch(_batch(cfg.vocab_size, 2, 16, seed=6))

    def table_grads():
        auto = S.loss_and_grads(model, params, batch)[2]
        func = torch.func.grad(lambda p: model.loss(p, batch)[0])(params)
        return auto["embed"]["table"], func["embed"]["table"]

    got = table_grads()
    monkeypatch.setattr(M._TiedCast, "apply",
                        staticmethod(lambda t, d: (t.to(d), t.to(d))))
    two_casts = table_grads()

    def one_cast(t, d):
        c = t.to(d)
        return c, c

    monkeypatch.setattr(M._TiedCast, "apply", staticmethod(one_cast))
    bf16_sum = table_grads()
    for g, want, shared in zip(got, two_casts, bf16_sum):
        assert g.dtype == torch.float32
        assert torch.equal(g, want)
        assert not torch.equal(g, shared)


# ------------------------------------------------------------ train step
#: the families whose batches come from each package's
#: ``concrete_inputs`` (a VLM's ``img_embeds``, an encoder-decoder's
#: ``frames``), as the reference's dry run builds them
FAMILY_ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-lite-16b",
                "whisper-medium", "command-r-plus-104b", "llava-next-34b")


#: an entry is held as near ε when its gradient is below NEAR_EPS·ε at a
#: step in both packages; at most NEAR_EPS_SHARE of the entries may be;
#: the cases held that way (``test_train_steps_match_reference``)
NEAR_EPS = 10
NEAR_EPS_SHARE = 5e-3
EPS_HELD = ("whisper-medium",)


def _near_eps(port_m, ref_m, cfg):
    """Per leaf: the entries whose gradient, g_t = (m_t - b1·m_(t-1)) /
    (1 - b1) from the first moments after each step, is below NEAR_EPS·ε
    at some step in both packages."""
    lim = NEAR_EPS * cfg.eps
    near = [torch.zeros_like(m, dtype=torch.bool) for m in port_m[0]]
    for t in range(1, len(port_m)):
        for i, (a0, a1, b0, b1) in enumerate(zip(port_m[t - 1], port_m[t],
                                                 ref_m[t - 1], ref_m[t])):
            ga, gb = ((n - cfg.b1 * o) / (1 - cfg.b1)
                      for o, n in ((a0, a1), (b0, b1)))
            near[i] |= (ga.abs() < lim) & (gb.abs() < lim)
    return near


def _cell_batches(jc, tc, t):
    """Step ``t``'s batch of a (4, 20) train cell from the reference's
    and the port's ``concrete_inputs`` (bit for bit the same numbers)."""
    shape = JR.ShapeSpec("smoke", 20, 4, "train")
    return (JR.concrete_inputs(jc, shape, seed=10 + t),
            concrete_inputs(tc, shape, seed=10 + t, device="cpu"))


@pytest.mark.parametrize("arch,accum", [("recurrentgemma-2b", 1),
                                        ("recurrentgemma-2b", 2),
                                        ("granite-8b", 2),
                                        ("granite-moe-3b-a800m", 1),
                                        ("deepseek-v2-lite-16b", 2),
                                        ("whisper-medium", 2),
                                        ("command-r-plus-104b", 1),
                                        ("llava-next-34b", 2)])
def test_train_steps_match_reference(arch, accum):
    """Three steps of the reference's (accumulating) train step and the
    port's, from the same state on the same batches: losses, gradient
    norms and the parameters and moments after them.  The families of
    ``FAMILY_ARCHS`` train on ``concrete_inputs`` batches, frames and
    patch embeddings split into microbatches with the tokens.

    whisper-medium's key projections have a bias, whose gradient is 0 but
    for rounding (a bias on every key shifts a query's scores by one
    constant, which the softmax cancels): ~1e-10 in both packages,
    unrelated in sign, below AdamW's ε = 1e-8, so each package moves
    those entries by its own share of lr (up to 3.4e-5 apart after three
    steps).  Its case holds the entries whose gradient is below
    ``NEAR_EPS`` ε at a step in both packages (read from the first
    moments) to AdamW's largest move, counts them (bound
    ``NEAR_EPS_SHARE``; 328 of 159 168: its 192 key-bias entries and a
    few that sum to near 0 by chance), and every other entry to 1e-5."""
    jc = jget_config(arch).reduced()
    tc = get_config(arch).reduced()
    jopt = JAdamWConfig(lr=3e-4)
    topt = AdamWConfig(lr=3e-4)
    _, jstep = JT.make_accum_train_step(jc, jopt, jwarmup(3e-4, 1, 3), accum)
    _, tstep = T.make_accum_train_step(tc, topt,
                                       linear_warmup_cosine(3e-4, 1, 3),
                                       accum)
    jstate = JS.init_train_state(jc, jax.random.key(5))
    tstate = train_state_from_reference(tc, _np(jstate))
    jstep = jax.jit(jstep)
    zeros = [torch.zeros_like(m) for m in tensors(tstate["opt"]["m"])]
    port_m, ref_m = [zeros], [zeros]
    for t in range(3):
        if arch in FAMILY_ARCHS:
            jbatch, tbatch = _cell_batches(jc, tc, t)
        else:
            batch = _batch(jc.vocab_size, 4, 20, seed=10 + t)
            jbatch = jax.tree.map(jnp.asarray, batch)
            tbatch = _torch_batch(batch)
        jstate, jm = jstep(jstate, jbatch)
        tstate, tm = tstep(tstate, tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        port_m.append([m.clone() for m in tensors(tstate["opt"]["m"])])
        ref_m.append(list(tensors(train_state_from_reference(
            tc, _np(jstate))["opt"]["m"])))
    want = train_state_from_reference(tc, _np(jstate))
    for got, ref in zip(tensors(tstate["opt"]["m"]),
                        tensors(want["opt"]["m"])):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5)
    got, ref = list(tensors(tstate["params"])), list(tensors(want["params"]))
    if arch not in EPS_HELD:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=1e-5)
        return
    near = _near_eps(port_m, ref_m, topt)
    n_near = sum(int(n.sum()) for n in near)
    assert n_near <= NEAR_EPS_SHARE * sum(g.numel() for g in got), n_near
    # each package moves such an entry by at most ~lr a step
    move = 2 * 3 * 3e-4 * 1.01
    for g, r, n in zip(got, ref, near):
        d = (g - r).abs().numpy()
        assert d[n.numpy()].max(initial=0.0) <= move
        assert d[~n.numpy()].max(initial=0.0) <= 1e-5
    assert int(tstate["opt"]["step"]) == 3


def test_train_resume_equals_straight_run(tmp_path):
    """``train`` 2 steps with a checkpoint, then resumed to 4, equals 4
    straight steps: the last loss and every leaf of the final state, bit
    for bit (warmup 20 makes the first 4 learning rates independent of
    the total)."""
    kw = dict(batch=2, seq=16, reduced=True, warmup=20, log=lambda *_: None,
              device="cpu", seed=1)
    a, b = tmp_path / "a", tmp_path / "b"
    T.train("granite-8b", 2, ckpt_dir=str(a), **kw)
    resumed = T.train("granite-8b", 4, ckpt_dir=str(a), resume=True, **kw)
    straight = T.train("granite-8b", 4, ckpt_dir=str(b), **kw)
    assert resumed == straight
    cfg = get_config("granite-8b").reduced()
    template = S.init_train_state(cfg, 0, "cpu")
    sa, ma = CheckpointManager(str(a)).restore(template)
    sb, mb = CheckpointManager(str(b)).restore(template)
    assert ma["step"] == mb["step"] == 3
    for x, y in zip(tensors(sa), tensors(sb)):
        assert torch.equal(x, y)


def test_train_failed_step_saves_no_torn_state(tmp_path, monkeypatch):
    """A step that fails part way through its update (which writes the
    state in place) leaves no checkpoint of that mixed state: the latest
    checkpoint stays the last one saved before it, with the state it
    had, and a resume starts from there."""
    kw = dict(batch=2, seq=16, reduced=True, warmup=20, log=lambda *_: None,
              device="cpu", seed=1, ckpt_dir=str(tmp_path), ckpt_every=1)
    real, calls, saved = S.adamw_update, [], []

    def failing_update(grads, opt, params, *a, **k):
        calls.append(1)
        if len(calls) == 3:     # step 2: after steps 0 and 1, saved at 1
            saved.extend(t.clone() for t in tensors((params, opt["m"])))
            next(tensors(params)).add_(1.0)    # the first leaf written
            raise RuntimeError("planted failure part way through AdamW")
        return real(grads, opt, params, *a, **k)

    monkeypatch.setattr(S, "adamw_update", failing_update)
    with pytest.raises(RuntimeError, match="planted failure"):
        T.train("granite-8b", 4, **kw)
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 1
    template = S.init_train_state(get_config("granite-8b").reduced(), 0,
                                  "cpu")
    state, meta = mgr.restore(template)
    assert meta["step"] == 1
    got = list(tensors((state["params"], state["opt"]["m"])))
    assert len(got) == len(saved)
    for x, y in zip(got, saved):
        assert torch.equal(x, y)


def test_train_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.train("granite-8b", 1, 2, 8)
