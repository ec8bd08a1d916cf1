"""Population training (``core/vmap_trials.py``) for every family and
remat, on the CPU: what the port's population refused or computed wrong,
held where the reference's trains.

* Remat: every architecture's population trains at remat "none",
  "dots" and "full" to the same objective (``_Remat``, the model's
  rematerialization under ``torch.func``; ``torch.utils.checkpoint``
  under ``torch.func.grad`` raises, which is why the population once
  refused remat); the attention and RG-LRU Functions still run once a
  layer for all trials (forward twice under remat, as one step of one
  trial does), their batch the trials' folded together.
* The MoE under ``torch.func.vmap``: ``_router`` and ``moe_forward``
  (capacity dispatch and the single-token combine; granite-moe's shared
  expert, deepseek's layout) vmapped over a trial axis equal a loop over
  the trials, and outside vmap equal bit for bit the code with
  ``F.one_hot`` that vmap refuses.
* Float inputs: ``PopulationTrainer.train``'s objective equals the
  reference's for whisper's frames and llava's image embeddings, from
  the reference's stacked state; the same data cast to integers, as the
  trainer once cast it, does not.

Tolerances, float32: objectives across remat modes 1e-6 relative (the
same computation; whisper's encoder gradients sum in another order,
~1e-10 in the moments); vmapped against looped MoE 1e-6 absolute (a
batched product against P products); against the reference 1e-5
relative, as ``tests/test_torch_population.py`` holds the losses.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.registry import get_config as jget_config
from repro.core import vmap_trials as JV
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config, list_archs
from repro_torch.core import vmap_trials as V
from repro_torch.core.vmap_trials import PopulationTrainer
from repro_torch.kernels import flash_attention as kfa
from repro_torch.kernels import rglru_scan as krg
from repro_torch.models import LM
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.convert import train_state_from_reference
from repro_torch.models.model import tensors, tree_map
from repro_torch.optim import AdamWConfig

ASSIGNS = [{"lr": 1e-3, "weight_decay": 0.0, "seed": 0},
           {"lr": 3e-3, "weight_decay": 0.1, "seed": 1}]
REMAT_RTOL = 1e-6
VMAP_ATOL = 1e-6
REF_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(cfg, seq=16, batch=2):
    """Step t's batch as numpy: tokens and labels, and the family's float
    inputs (whisper's ``frames``, a VLM's ``img_embeds``) standard
    normal."""
    floats = {}
    if cfg.family == "encdec":
        floats["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.family == "vlm":
        floats["img_embeds"] = (cfg.n_img_tokens, cfg.d_model)

    def it(t):
        r = np.random.default_rng(2000 + t)
        out = {k: r.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
               for k in ("tokens", "labels")}
        for name, shape in floats.items():
            out[name] = r.standard_normal((batch,) + shape).astype(np.float32)
        return out
    return it


# --------------------------------------------------------------- remat
@pytest.mark.parametrize("arch", list_archs())
def test_population_trains_every_family(arch):
    """``PopulationTrainer`` of the reduced config at each remat: finite
    per-trial objectives, the same at every remat."""
    got = {}
    for remat in ("none", "dots", "full"):
        cfg = get_config(arch).reduced(remat=remat)
        got[remat] = PopulationTrainer(cfg, device="cpu").train(
            ASSIGNS, _data(cfg), steps=2, eval_last=2)
    assert got["none"].shape == (2,) and np.isfinite(got["none"]).all()
    for remat in ("dots", "full"):
        np.testing.assert_allclose(got[remat], got["none"], rtol=REMAT_RTOL)


def test_checkpoint_refuses_func_grad_and_remat_does_not():
    """The cause of the old refusal: ``torch.utils.checkpoint`` inside
    ``torch.func.grad`` raises.  The model's remat under ``torch.func``
    goes through ``_Remat`` instead, and one trial's gradient at remat
    "full" equals the one at "none" bit for bit; outside ``torch.func``
    the model still checkpoints with ``torch.utils.checkpoint``."""
    from torch.utils.checkpoint import checkpoint
    with pytest.raises(RuntimeError, match="saved tensor hooks"):
        torch.func.grad(lambda x: checkpoint(
            torch.sin, x, use_reentrant=False).sum())(torch.ones(3))
    cfg = get_config("recurrentgemma-2b").reduced()
    params = LM(cfg).init(0, "cpu")
    batch = {k: torch.from_numpy(v).long() for k, v in _data(cfg)(0).items()}
    grads = {}
    for remat in ("none", "full"):
        model = LM(dataclasses.replace(cfg, remat=remat))
        grads[remat] = torch.func.grad(
            lambda p: model.loss(p, batch)[0])(params)
    for a, b in zip(tensors(grads["full"]), tensors(grads["none"])):
        assert torch.equal(a, b)
    outside = LM(dataclasses.replace(cfg, remat="full"))._maybe_remat(
        torch.sin)
    assert outside.func is checkpoint
    with pytest.raises(ValueError, match="not none, dots or full"):
        LM(dataclasses.replace(cfg, remat="some"))._maybe_remat(torch.sin)


def test_population_remat_keeps_less():
    """The population step's memory (``distributed/memory.py``'s tracker
    of live storage) at remat "full" against "none", reduced
    recurrentgemma at 6 layers in bf16 over 128 tokens: "full" holds
    each layer's input, and its recomputation runs outside the step's
    graph (``torch.func.grad`` records its backward for a second
    derivative, and would keep every recomputed activation to the end).
    Seen: 84 MB beyond the arguments against 181 MB."""
    from repro_torch.distributed.memory import tracking
    temp = {}
    for remat in ("none", "full"):
        cfg = get_config("recurrentgemma-2b").reduced(
            remat=remat, n_layers=6, d_model=256, d_ff=1024, head_dim=64,
            dtype="bfloat16")
        trainer = PopulationTrainer(cfg, device="cpu")
        state = trainer.init_states(ASSIGNS)
        lr, wd = trainer.hp_vectors(ASSIGNS)
        batch = {k: torch.from_numpy(v).long().expand(len(ASSIGNS), *v.shape)
                 for k, v in _data(cfg, seq=128, batch=1)(0).items()}
        with tracking((state, batch)) as tracker:
            trainer.step(state, batch, lr, wd)
        temp[remat] = (tracker.result()["peak_memory_in_bytes"]
                       - tracker.argument_bytes)
    assert temp["full"] < 0.6 * temp["none"], temp


@pytest.mark.parametrize("remat", ["none", "full"])
def test_population_kernels_one_call_for_all_trials(monkeypatch, remat):
    """One population step of reduced recurrentgemma (two RG-LRU layers
    and one local-attention layer): each kernel wrapper is called once a
    layer (forward twice under "full"), on the trials folded into its
    batch, as on the card, where each call is one launch."""
    cfg = get_config("recurrentgemma-2b").reduced(remat=remat)
    calls = {n: [] for n in ("fa", "fa_bwd", "rg", "rg_bwd")}

    def spy(name, fn, arg=0):
        def wrapped(*a, **kw):
            calls[name].append(a[arg].shape[0])
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(kfa, "flash_attention",
                        spy("fa", kfa.flash_attention))
    monkeypatch.setattr(kfa, "flash_attention_bwd",
                        spy("fa_bwd", kfa.flash_attention_bwd))
    monkeypatch.setattr(krg, "rglru_scan", spy("rg", krg.rglru_scan))
    monkeypatch.setattr(krg, "rglru_scan_bwd",
                        spy("rg_bwd", krg.rglru_scan_bwd))
    trainer = PopulationTrainer(cfg, device="cpu")
    trainer.train(ASSIGNS, _data(cfg, batch=3), steps=1, eval_last=1)
    fwd = 2 if remat == "full" else 1
    n_attn = sum(s.kind == "local" for s in trainer.model.specs)
    n_rg = sum(s.kind == "rglru" for s in trainer.model.specs)
    assert (n_attn, n_rg) == (1, 2)
    want = {"fa": fwd * n_attn, "fa_bwd": n_attn, "rg": fwd * n_rg,
            "rg_bwd": n_rg}
    assert {n: len(c) for n, c in calls.items()} == want
    assert all(b == len(ASSIGNS) * 3 for c in calls.values() for b in c)


# ----------------------------------------------------------------- MoE
def _moe_case(arch, seq, P=2, B=2, seed=0):
    """P trials' MoE weights stacked, float32, and their inputs (P,B,S,d)."""
    cfg = get_config(arch).reduced()
    ps = [M.init_moe(L.Init(s, "cpu", torch.float32), cfg) for s in range(P)]
    stacked = _stack(ps)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (P, B, seq, cfg.d_model)).astype(np.float32))
    return cfg, ps, stacked, x


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


@pytest.mark.parametrize("seq", [16, 1])
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_vmapped_equals_loop(arch, seq):
    """``_router`` and ``moe_forward`` under ``torch.func.vmap`` over the
    trial axis (``F.one_hot`` made them raise there) against each trial
    alone: the router's choices equal, weights, outputs and aux losses
    within rounding; and ``torch.func.grad`` of the vmapped layer."""
    cfg, ps, stacked, x = _moe_case(arch, seq)
    w, idx, aux = torch.func.vmap(lambda p, a: M._router(p, a, cfg))(
        stacked, x)
    y, yaux = torch.func.vmap(lambda p, a: M.moe_forward(p, a, cfg))(
        stacked, x)
    for i, p in enumerate(ps):
        wi, ii, ai = M._router(p, x[i], cfg)
        assert torch.equal(idx[i], ii)
        torch.testing.assert_close(w[i], wi, rtol=0, atol=VMAP_ATOL)
        torch.testing.assert_close(aux[i], ai, rtol=0, atol=VMAP_ATOL)
        yi, ya = M.moe_forward(p, x[i], cfg)
        torch.testing.assert_close(y[i], yi, rtol=0, atol=VMAP_ATOL)
        torch.testing.assert_close(yaux[i], ya, rtol=0, atol=VMAP_ATOL)
    g = torch.func.vmap(torch.func.grad(
        lambda p, a: M.moe_forward(p, a, cfg)[0].square().sum()))(stacked, x)
    for i, p in enumerate(ps):
        gi = torch.func.grad(
            lambda q: M.moe_forward(q, x[i], cfg)[0].square().sum())(p)
        for a, b in zip(tensors(g), tensors(gi)):
            torch.testing.assert_close(a[i], b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b"])
def test_moe_outside_vmap_is_the_parents(monkeypatch, arch):
    """Outside vmap the router and both dispatch paths equal, bit for
    bit, the same code with ``F.one_hot`` (what they ran before), which
    a population's ``vmap(grad(...))`` refuses (it reads the largest
    index with ``.item()``)."""
    cfg, ps, stacked, x = _moe_case(arch, 16)
    runs = {}
    for name in ("now", "parent"):
        if name == "parent":
            monkeypatch.setattr(M, "_one_hot", F.one_hot)
        runs[name] = [M._router(ps[0], x[0], cfg),
                      M.moe_forward(ps[0], x[0], cfg),
                      M.moe_forward(ps[0], x[0, :, :1], cfg)]
    for a, b in zip(tensors(runs["now"]), tensors(runs["parent"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(RuntimeError, match="item"):
        torch.func.vmap(torch.func.grad(
            lambda p, a: M.moe_forward(p, a, cfg)[0].sum()))(stacked, x)


# ------------------------------------------------------- float inputs
@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_population_train_keeps_float_inputs(arch):
    """``PopulationTrainer.train`` from the reference's stacked state (its
    ``init_states`` answering the converted one): the objective equals
    the reference's ``train`` on the same data with its float inputs;
    the same data cast to integers, as the trainer once cast every
    entry, moves it past ten times that tolerance (whisper 3e-3 of the
    objective, llava 3e-4)."""
    steps = 3
    jc = jget_config(arch).reduced(remat="full")
    tc = get_config(arch).reduced(remat="full")
    data = _data(tc)
    jtrainer = JV.PopulationTrainer(jc, JAdamWConfig())
    want = jtrainer.train(ASSIGNS, data, steps, eval_last=steps)
    init = train_state_from_reference(
        tc, jax.tree.map(np.array, jtrainer.init_states(ASSIGNS)),
        population=True)

    def port(data_iter):
        trainer = PopulationTrainer(tc, device="cpu")
        trainer.init_states = lambda a: tree_map(torch.clone, init)
        return trainer.train(ASSIGNS, data_iter, steps, eval_last=steps)
    np.testing.assert_allclose(port(data), want, rtol=REF_RTOL)
    cast = port(lambda t: {k: v.astype(np.int64)
                           for k, v in data(t).items()})
    assert np.abs(cast - want).max() > 10 * REF_RTOL * np.abs(want).max()


def test_trainer_takes_hp_names():
    """The reference's ``hp_names`` argument: which hyperparameters vary
    (kept for the scheduler; the vectors read lr, weight decay and the
    seed whatever it names)."""
    cfg = get_config("granite-8b").reduced()
    assert PopulationTrainer(cfg, device="cpu").hp_names == (
        "lr", "weight_decay", "seed")
    t = PopulationTrainer(cfg, AdamWConfig(), ("lr",), device="cpu")
    assert t.hp_names == ("lr",)
    assert t.hp_vectors(ASSIGNS)[0].tolist() == pytest.approx([1e-3, 3e-3])


def test_on_device_keeps_float_dtypes():
    a = V._on_device(np.zeros((2, 3), np.int32), "cpu")
    b = V._on_device(np.zeros((2, 3), np.float32), "cpu")
    c = V._on_device(torch.zeros(2, dtype=torch.bfloat16), "cpu")
    assert (a.dtype, b.dtype, c.dtype) == (torch.int64, torch.float32,
                                            torch.bfloat16)
