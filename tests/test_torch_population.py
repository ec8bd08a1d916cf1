"""Population training (``core/vmap_trials.py``) against the JAX
reference and against sequential training, on the CPU.

* ``make_population_step`` against the reference's, from the reference's
  stacked state converted (``train_state_from_reference(population=
  True)``), on the same stacked batches and per-trial hyperparameters:
  reduced ``recurrentgemma-2b`` (its attention and RG-LRU Functions under
  ``torch.func.vmap``) and reduced ``granite-8b``.
* ``PopulationTrainer.train`` equals P sequential runs, as the
  reference's ``tests/test_population.py`` requires of it (1e-5).

Tolerances, float32: losses 1e-5 relative, gradient norms 1e-4; the
moments after the steps 1e-5 absolute (linear in the gradients, which
agree to float32 rounding in other orders); the parameters 1e-2 of the
largest learning rate a step: AdamW's update m̂/(√v̂ + ε) normalizes each
element, so where a gradient element is within rounding of 0 its update
can move by a fair share of lr (the largest seen, 1.7e-5 after two
steps at lr 3e-3, is 0.3% of lr a step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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

ASSIGNS = [{"lr": 1e-3, "weight_decay": 0.0, "seed": 0},
           {"lr": 3e-3, "weight_decay": 0.1, "seed": 1}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(vocab, seq=16):
    def it(t):
        r = np.random.default_rng(1000 + t)
        return {"tokens": r.integers(0, vocab, (2, seq)).astype(np.int32),
                "labels": r.integers(0, vocab, (2, seq)).astype(np.int32)}
    return it


@pytest.mark.parametrize("arch,seq", [("recurrentgemma-2b", 40),
                                      ("granite-8b", 16)])
def test_population_step_matches_reference(arch, seq):
    jc = jget_config(arch).reduced()
    tc = get_config(arch).reduced()
    jtrainer = JV.PopulationTrainer(jc, JAdamWConfig())
    jstate = jtrainer.init_states(ASSIGNS)
    jlr, jwd = jtrainer.hp_vectors(ASSIGNS)
    tstate = train_state_from_reference(
        tc, jax.tree.map(np.asarray, jstate), population=True)
    lr, wd = (torch.from_numpy(np.array(a)) for a in (jlr, jwd))
    _, tstep = V.make_population_step(tc, AdamWConfig())
    P = len(ASSIGNS)
    for t in range(2):
        batch = _data(jc.vocab_size, seq)(t)
        pbatch = {k: np.broadcast_to(v[None], (P,) + v.shape)
                  for k, v in batch.items()}
        jstate, jm = jtrainer.step(jstate, jax.tree.map(jnp.asarray, pbatch),
                                   jlr, jwd)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(np.array(v)).long()
                                    for k, v in pbatch.items()}, lr, wd)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(tm["grad_norm"].numpy(),
                                   np.asarray(jm["grad_norm"]), rtol=1e-4)
    want = train_state_from_reference(tc, jax.tree.map(np.asarray, jstate),
                                      population=True)
    lr_step = 1e-2 * max(a["lr"] for a in ASSIGNS) * 2
    for tree, atol in (("params", lr_step), ("m", 1e-5), ("v", 1e-5)):
        got = tstate[tree] if tree == "params" else tstate["opt"][tree]
        ref = want[tree] if tree == "params" else want["opt"][tree]
        for g, r in zip(tensors(got), tensors(ref)):
            np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=0,
                                       atol=atol)
    assert tstate["opt"]["step"].tolist() == [2] * P


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


def test_population_needs_remat_none():
    """``torch.utils.checkpoint`` refuses ``torch.func.grad``'s
    transforms, so a population with remat asks for "none"."""
    cfg = dataclasses.replace(get_config("granite-8b").reduced(),
                              remat="full")
    with pytest.raises(ValueError, match="remat 'none'"):
        V.make_population_step(cfg, AdamWConfig())


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PopulationTrainer(get_config("granite-8b").reduced())
