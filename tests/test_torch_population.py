"""Population training (``core/vmap_trials.py``) against the JAX
reference and against sequential training, on the CPU.

* ``make_population_step`` against the reference's, from the reference's
  stacked state converted (``train_state_from_reference(population=
  True)``), on the same stacked batches and per-trial hyperparameters:
  reduced ``recurrentgemma-2b`` (its attention and RG-LRU Functions under
  ``torch.func.vmap``) and reduced ``granite-8b``.
* The other families at the published configs' remat "full"
  (granite-moe and deepseek: the MoE dispatch under vmap; whisper's
  float frames, llava's image embeddings; command-r), and
  recurrentgemma, granite-8b and xlstm at "full" and "dots" against the
  reference's ``jax.checkpoint`` and against the port at "none" (to
  float32 rounding).
* ``PopulationTrainer.train`` equals P sequential runs, as the
  reference's ``tests/test_population.py`` requires of it (1e-5).

Tolerances, float32: losses 1e-5 relative, gradient norms 1e-4; the
moments after the steps 1e-5 absolute (linear in the gradients, which
agree to float32 rounding in other orders); the parameters 1e-2 of the
largest learning rate a step: AdamW's update m̂/(√v̂ + ε) normalizes each
element, so where a gradient element is within rounding of 0 its update
can move by a fair share of lr (the largest seen, 1.7e-5 after two
steps at lr 3e-3, is 0.3% of lr a step).

xlstm-125m has entries whose gradient is 0 but for rounding: an sLSTM's
input-gate bias (``w_in.b``) cancels between its cell and its normalizer
state, and a few entries of other leaves sum to within a few ε of 0 at a
step.  There the two packages' float32 roundings differ by more than the
entry's size, ε = 1e-8 sets the update's scale, and each package moves
the entry by up to lr a step on its own (7.6e-5 after two steps at lr
3e-3).  So its case holds those entries -- a gradient below
``NEAR_EPS`` ε at a step in both packages, and not exactly 0 in both,
read from the first moments -- only to AdamW's largest move, counts
them (0.15% of the entries; bound ``NEAR_EPS_SHARE``), and holds every
other entry to the tolerance above.  whisper, granite-moe and llava
have such entries too (0.22%, 0.11% and 0.02%), at remat "none" as at
"full", and are held so.  ``test_population_step_agrees_in_float64``
shows the cause: in float64 the two packages' parameters agree to
1e-10 after the same steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.configs.registry import get_config as jget_config
from repro.core import vmap_trials as JV
from repro.optim import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.core import vmap_trials as V
from repro_torch.core.vmap_trials import PopulationTrainer
from repro_torch.models import LM
from repro_torch.models.convert import train_state_from_reference
from repro_torch.models.model import tensors, tree_map
from repro_torch.launch import steps as S
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as adamw_mod

ASSIGNS = [{"lr": 1e-3, "weight_decay": 0.0, "seed": 0},
           {"lr": 3e-3, "weight_decay": 0.1, "seed": 1}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(vocab, seq=16, floats=None):
    """Step t's batch of two sequences: tokens and labels, and the float
    inputs ``floats`` names ({name: shape}, standard normal float32)."""
    def it(t):
        r = np.random.default_rng(1000 + t)
        out = {"tokens": r.integers(0, vocab, (2, seq)).astype(np.int32),
               "labels": r.integers(0, vocab, (2, seq)).astype(np.int32)}
        for name, shape in (floats or {}).items():
            out[name] = r.standard_normal((2,) + shape).astype(np.float32)
        return out
    return it


def _floats(cfg):
    """The float inputs of ``cfg``'s family: whisper's ``frames``, a
    VLM's ``img_embeds``."""
    if cfg.family == "encdec":
        return {"frames": (cfg.encoder_seq, cfg.d_model)}
    if cfg.family == "vlm":
        return {"img_embeds": (cfg.n_img_tokens, cfg.d_model)}
    return {}


#: an entry is held as near ε when its gradient is below NEAR_EPS·ε at a
#: step in both packages; at most NEAR_EPS_SHARE of the entries may be
NEAR_EPS = 10
NEAR_EPS_SHARE = 5e-3
#: the cases held that way (module docstring); whisper's key biases have
#: a gradient of 0 but for rounding (the softmax cancels it), and
#: granite-moe (an expert's weights) and llava (a projection) each have
#: an entry within a few ε of 0 at a step, at remat "none" as at "full"
EPS_HELD = ("xlstm-125m", "whisper-medium", "granite-moe-3b-a800m",
            "llava-next-34b")


def _step_grads(m_hist, b1):
    """Each step's (clipped) gradient of every leaf from the first moments
    after each step: g_t = (m_t - b1·m_(t-1)) / (1 - b1), m_0 = 0."""
    return [[(m - b1 * p) / (1 - b1) for m, p in zip(new, old)]
            for old, new in zip(m_hist, m_hist[1:])]


def _near_eps(port_m, ref_m, cfg):
    """Per leaf: the entries whose gradient is below NEAR_EPS·ε at some
    step in both packages, and not 0 in both (an exact 0 moves neither
    package's moments: such an entry is held to the plain tolerance)."""
    lim = NEAR_EPS * cfg.eps
    near = None
    for gp, gr in zip(_step_grads(port_m, cfg.b1), _step_grads(ref_m, cfg.b1)):
        now = [(a.abs() < lim) & (b.abs() < lim) & ((a != 0) | (b != 0))
               for a, b in zip(gp, gr)]
        near = now if near is None else [a | b for a, b in zip(near, now)]
    return near


def _pbatch(batch):
    """A batch broadcast along the population axis (P, ...), numpy."""
    return {k: np.broadcast_to(v[None], (len(ASSIGNS),) + v.shape)
            for k, v in batch.items()}


def _port_batch(pbatch):
    return {k: V._on_device(np.array(v), "cpu") for k, v in pbatch.items()}


def _population_run(arch, seq, jc, tc, steps=2, also=()):
    """``steps`` population steps of both packages from the reference's
    stacked state -> (the port's state, the reference's converted, the
    first moments after each step of each, the metrics of each step,
    and for each port config of ``also`` its (state, metrics of each
    step) after the same steps from the same state)."""
    jtrainer = JV.PopulationTrainer(jc, JAdamWConfig())
    jstate = jtrainer.init_states(ASSIGNS)
    jlr, jwd = jtrainer.hp_vectors(ASSIGNS)
    init = jax.tree.map(np.array, jstate)    # before the steps donate it
    tstate = train_state_from_reference(tc, init, population=True)
    lr, wd = (torch.from_numpy(np.array(a)) for a in (jlr, jwd))
    _, tstep = V.make_population_step(tc, AdamWConfig())
    zeros = [torch.zeros_like(m) for m in tensors(tstate["opt"]["m"])]
    port_m, ref_m, metrics = [zeros], [zeros], []
    data = _data(jc.vocab_size, seq, _floats(tc))
    for t in range(steps):
        pbatch = _pbatch(data(t))
        jstate, jm = jtrainer.step(jstate, jax.tree.map(jnp.asarray, pbatch),
                                   jlr, jwd)
        tstate, tm = tstep(tstate, _port_batch(pbatch), lr, wd)
        port_m.append([m.clone() for m in tensors(tstate["opt"]["m"])])
        ref_m.append(list(tensors(train_state_from_reference(
            tc, jax.tree.map(np.asarray, jstate),
            population=True)["opt"]["m"])))
        metrics.append((tm, jm))
    want = train_state_from_reference(tc, jax.tree.map(np.asarray, jstate),
                                      population=True)
    others = []
    for oc in also:
        ostate = train_state_from_reference(oc, init, population=True)
        _, ostep = V.make_population_step(oc, AdamWConfig())
        om = []
        for t in range(steps):
            ostate, m = ostep(ostate, _port_batch(_pbatch(data(t))), lr, wd)
            om.append(m)
        others.append((ostate, om))
    return tstate, want, port_m, ref_m, metrics, others


def _held_to_reference(arch, tstate, want, port_m, ref_m, metrics):
    """``_population_run``'s port state and metrics held to the
    reference's at the tolerances of the module docstring."""
    for tm, jm in metrics:
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-4)
    steps = len(metrics)
    lr_max = max(a["lr"] for a in ASSIGNS)
    lr_step = 1e-2 * lr_max * 2
    for tree, atol in (("m", 1e-5), ("v", 1e-5)):
        for g, r in zip(tensors(tstate["opt"][tree]),
                        tensors(want["opt"][tree])):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=atol)
    got, ref = list(tensors(tstate["params"])), list(tensors(want["params"]))
    if arch in EPS_HELD:
        near = _near_eps(port_m, ref_m, AdamWConfig())
        n_near = sum(int(n.sum()) for n in near)
        assert n_near <= NEAR_EPS_SHARE * sum(g.numel() for g in got), n_near
        # each package moves such an entry by at most ~lr a step (|m̂|/√v̂
        # <= 1.002 over two steps) plus its weight decay
        move = 2 * steps * lr_max * 1.01
        for g, r, n in zip(got, ref, near):
            d = (g - r).abs().numpy()
            assert d[n.numpy()].max(initial=0.0) <= move
            assert d[~n.numpy()].max(initial=0.0) <= lr_step
    else:
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=lr_step)
    assert tstate["opt"]["step"].tolist() == [steps] * len(ASSIGNS)


@pytest.mark.parametrize("arch,seq", [("recurrentgemma-2b", 40),
                                      ("granite-8b", 16),
                                      ("xlstm-125m", 16)])
def test_population_step_matches_reference(arch, seq):
    jc = jget_config(arch).reduced()
    tc = get_config(arch).reduced()
    _held_to_reference(arch, *_population_run(arch, seq, jc, tc)[:5])


#: every family the reference's population trains, at the published
#: configs' remat "full": the MoE dispatch (granite-moe's shared expert,
#: deepseek's dense layer, MLA) and the float inputs (whisper's frames,
#: llava's image embeddings) under ``torch.func.vmap``
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "deepseek-v2-lite-16b", "whisper-medium",
                                  "llava-next-34b", "command-r-plus-104b"])
def test_population_family_matches_reference(arch):
    jc = jget_config(arch).reduced(remat="full")
    tc = get_config(arch).reduced(remat="full")
    _held_to_reference(arch, *_population_run(arch, 16, jc, tc)[:5])


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch,seq", [("recurrentgemma-2b", 40),
                                      ("granite-8b", 16),
                                      ("xlstm-125m", 16)])
def test_population_remat_matches_reference(arch, seq, remat):
    """Remat under ``torch.func`` (``models/model.py`` ``_Remat``) against
    the reference's ``jax.checkpoint`` at the same remat, and against the
    port at "none": the recomputation is the same computation, its
    products run outside the step's graph (their kernels may differ:
    ``matmul`` folds a batch into one product where nothing records a
    gradient), so the two agree to float32 rounding -- losses 1e-6 and
    gradient norms 1e-5 relative, the moments 1e-6 absolute, the
    parameters at the module's tolerance (1.8e-5 and 4.3e-5 seen for
    granite-8b and xlstm, recurrentgemma's bit for bit)."""
    jc = jget_config(arch).reduced(remat=remat)
    tc = get_config(arch).reduced(remat=remat)
    run = _population_run(arch, seq, jc, tc,
                          also=[dataclasses.replace(tc, remat="none")])
    _held_to_reference(arch, *run[:5])
    plain, plain_metrics = run[5][0]
    for (tm, _), pm in zip(run[4], plain_metrics):
        np.testing.assert_allclose(tm["loss"].numpy(), pm["loss"].numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   pm["grad_norm"].numpy(), rtol=1e-5)
    for a, b in zip(tensors(run[0]["opt"]), tensors(plain["opt"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-6)
    lr_step = 1e-2 * max(a["lr"] for a in ASSIGNS) * len(plain_metrics)
    for a, b in zip(tensors(run[0]["params"]), tensors(plain["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=lr_step)


class _Float64(TorchFunctionMode):
    """Every float32 the port asks for (``Tensor.float``, a ``dtype``
    argument) made float64: the port computes in float32 in its norms,
    cross entropy, xLSTM cells and AdamW moments whatever the config's
    dtype, as the reference does."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.float:
            return args[0].to(torch.float64)
        kwargs = {k: torch.float64 if v is torch.float32 else v
                  for k, v in (kwargs or {}).items()}
        args = tuple(torch.float64 if a is torch.float32 else a
                     for a in args)
        return func(*args, **kwargs)


def test_population_step_agrees_in_float64(monkeypatch):
    """The xlstm case above in float64 on both sides (the reference under
    ``jax_enable_x64`` with its float32 made float64, the port under
    ``_Float64``): every parameter agrees to 1e-10 (float64 rounding of
    O(1) sums is ~1e-16; a fault would show at the size of an update,
    ~1e-3), the losses and gradient norms to 1e-12.  So the float32
    case's entries held as near ε move apart by rounding, not a fault."""
    jax.config.update("jax_enable_x64", True)
    try:
        monkeypatch.setattr(jnp, "float32", jnp.float64)
        jc = jget_config("xlstm-125m").reduced(dtype="float64",
                                               param_dtype="float64")
        tc = get_config("xlstm-125m").reduced(dtype="float64",
                                              param_dtype="float64")
        mode = _Float64()
        # AdamW's vmap rule (an autograd.Function's) runs with the modes
        # popped, as an operator's body does; its body pushes this one again
        update = adamw_mod._all_leaves

        def in_float64(*args):
            with mode:
                return update(*args)
        monkeypatch.setattr(adamw_mod, "_all_leaves", in_float64)
        with mode:
            tstate, want, _, _, metrics, _ = _population_run("xlstm-125m", 16,
                                                          jc, tc)
    finally:
        monkeypatch.undo()
        jax.config.update("jax_enable_x64", False)
    for tm, jm in metrics:
        assert tm["loss"].dtype == torch.float64
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-12)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-12)
    for tree in (tstate["params"], tstate["opt"]["m"]):
        assert all(t.dtype == torch.float64 for t in tensors(tree))
    for g, r in zip(tensors(tstate["params"]), tensors(want["params"])):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0, atol=1e-10)


def test_population_equals_sequential():
    """The reference's ``test_population_equals_sequential`` for the
    port: 6 population steps of two trials against each trial trained
    alone (plain autograd, AdamW without coupled decay,
    then p - lr·wd·p_old), the mean of the last two losses within 1e-5."""
    cfg = get_config("granite-8b").reduced(n_layers=2)
    trainer = PopulationTrainer(cfg, AdamWConfig(clip_norm=1.0),
                                device="cpu")
    data = _data(cfg.vocab_size)
    pop = trainer.train(ASSIGNS, data, steps=6, eval_last=2)

    model = LM(cfg)
    ocfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    for i, a in enumerate(ASSIGNS):
        params = model.init(a["seed"], "cpu")
        opt = adamw_init(params)
        tail = []
        for t in range(6):
            batch = {k: torch.from_numpy(v).long()
                     for k, v in data(t).items()}
            loss, _, g = S.loss_and_grads(model, params, batch)
            old = iter([p.clone() for p in tensors(params)])
            newp, opt, _ = adamw_update(g, opt, params, ocfg, a["lr"])
            lr_wd = (torch.tensor(a["lr"]) * torch.tensor(a["weight_decay"]))
            params = tree_map(lambda n: (n.float() - lr_wd * next(old).float()
                                         ).to(n.dtype), newp)
            if t >= 4:
                tail.append(float(loss))
        assert abs(pop[i] - np.mean(tail)) < 1e-5


def test_population_distinct_seeds_distinct_params():
    cfg = get_config("recurrentgemma-2b").reduced()
    st = PopulationTrainer(cfg, device="cpu").init_states(
        [{"seed": 0}, {"seed": 1}])
    w = next(tensors(st["params"]))
    assert w.shape[0] == 2 and not torch.allclose(w[0], w[1])
    one = LM(cfg).init(1, "cpu")
    for a, b in zip(tensors(st["params"]), tensors(one)):
        assert torch.equal(a[1], b)
    assert st["opt"]["step"].tolist() == [0, 0]


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PopulationTrainer(get_config("granite-8b").reduced())
