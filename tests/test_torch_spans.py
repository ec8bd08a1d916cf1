"""Spans inside the port's training step (``repro_torch/spans.py``), on
the CPU, at reduced granite-moe (two MoE layers, bf16 compute over
float32 masters) through both entries the benchmark drives: the
population's step (``PopulationTrainer``, ``vmap(grad(...))``, remat by
``_Remat``) and the single trial's (``make_train_step``, remat by
``torch.utils.checkpoint``), at remat "full" and "none":

- the span tree a step makes: names, parents, phases and calls;
- nothing recorded, and no mark inserted, without a profiler;
- the losses and parameters bit for bit the same with the profiler on;
- a profiled stretch after a plain step starts its records afresh;
- ``summary()``: device times None off the card, a span inside one of
  its own name not recorded, a span closed by an exception.
"""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.core.vmap_trials import PopulationTrainer
from repro_torch.launch.steps import init_train_state, make_train_step
from repro_torch.models.model import tensors
from repro_torch.optim import AdamWConfig

ASSIGNS = [{"lr": 1e-3, "weight_decay": 0.0, "seed": 0},
           {"lr": 3e-3, "weight_decay": 0.1, "seed": 1}]
LAYER_SPANS = ("attn", "moe.router", "moe.dispatch", "moe.experts",
               "moe.combine")


@pytest.fixture(autouse=True, scope="module")
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(remat):
    return dataclasses.replace(
        get_config("granite-moe-3b-a800m").reduced(remat=remat),
        dtype="bfloat16")


def _batch(cfg, t, trials=None):
    g = torch.Generator().manual_seed(100 + t)
    lead = (2, 16) if trials is None else (trials, 2, 16)
    return {k: torch.randint(0, cfg.vocab_size, lead, generator=g)
            for k in ("tokens", "labels")}


class _Pop:
    def __init__(self, cfg):
        self.trainer = PopulationTrainer(cfg, AdamWConfig(), device="cpu")
        self.state = self.trainer.init_states(ASSIGNS)
        self.hp = self.trainer.hp_vectors(ASSIGNS)
        self.cfg = cfg

    def step(self, t):
        self.state, m = self.trainer.step(
            self.state, _batch(self.cfg, t, len(ASSIGNS)), *self.hp)
        return m["loss"]


class _Solo:
    def __init__(self, cfg):
        _, self.fn = make_train_step(cfg, AdamWConfig())
        self.state = init_train_state(cfg, 0, "cpu")
        self.cfg = cfg

    def step(self, t):
        self.state, m = self.fn(self.state, _batch(self.cfg, t))
        return m["loss"]


ENTRIES = {"pop": _Pop, "solo": _Solo}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def _calls(recs):
    """{(name, phase, parent's name): calls}"""
    out = {}
    for r in recs:
        key = (r.name, r.phase,
               None if r.parent is None else recs[r.parent].name)
        out[key] = out.get(key, 0) + 1
    return out


@pytest.mark.parametrize("remat", ("full", "none"))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_span_tree_of_a_step(entry, remat):
    run = ENTRIES[entry](_cfg(remat))
    run.step(1)                       # a plain step: the stretch is new
    _profiled(lambda: run.step(2))
    recs = spans.records()
    calls = _calls(recs)
    n = run.cfg.n_layers
    assert all(r.host_ms is not None for r in recs)
    assert calls[("step", "forward", None)] == 1
    assert calls[("step.grads", "forward", "step")] == 1
    assert calls[("step.forward", "forward", "step.grads")] == 1
    assert calls[("optim.adamw", "forward", "step")] == 1
    assert calls[("model.head", "forward", "step.forward")] == 1
    assert calls[("model.head.backward", "backward", "step.grads")] == 1
    assert calls[("model.layer", "forward", "step.forward")] == n
    assert calls[("model.layer.backward", "backward", "step.grads")] == n
    recomputed = calls.get(("model.layer", "backward",
                            "model.layer.backward"), 0)
    assert recomputed == (n if remat == "full" else 0)
    for name in LAYER_SPANS:
        assert calls[(name, "forward", "model.layer")] == n
        # the single trial's checkpoint may stop its recompute early
        got = calls.get((name, "backward", "model.layer"), 0)
        assert got == n if remat == "full" and entry == "pop" else got <= n
        if remat == "none":
            assert got == 0
    step = next(i for i, r in enumerate(recs) if r.name == "step")
    assert all(r.step == step for r in recs)
    assert {r.name for r in recs} == {
        "step", "step.grads", "step.forward", "optim.adamw", "model.head",
        "model.head.backward", "model.layer", "model.layer.backward",
        "cast", *LAYER_SPANS}

    s = spans.summary()
    # the population casts each layer's 8 weights a pass, and the tied
    # table once; the single trial casts its state once a step
    casts = {"pop": 8 * n + 1, "solo": 1}[entry]
    assert s[("cast", "forward")]["calls"] == casts
    assert s.get(("cast", "backward"), {"calls": 0})["calls"] == (
        8 * n if entry == "pop" and remat == "full" else 0)
    assert all(v["device_ms"] is None for v in s.values())
    assert all(v["host_ms"] > 0 for v in s.values())


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_nothing_recorded_without_a_profiler(entry):
    run = ENTRIES[entry](_cfg("full"))
    before = spans.records()
    run.step(1)
    assert spans.records() == before
    assert spans.span("a") is spans.span("b")
    x = torch.ones(3, requires_grad=True)
    bw = spans.backward_span("b", x)
    assert bw.input(x) is x and bw.output(x) is x


@pytest.mark.parametrize("remat", ("full", "none"))
@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_profiler_leaves_the_numbers_bit_for_bit(entry, remat):
    plain, traced = ENTRIES[entry](_cfg(remat)), ENTRIES[entry](_cfg(remat))
    for t in (1, 2):
        a = plain.step(t)
        b = _profiled(lambda: traced.step(t))
        assert torch.equal(a, b)
    assert spans.summary()[("step", "forward")]["calls"] == 1
    for x, y in zip(tensors(plain.state), tensors(traced.state)):
        assert torch.equal(x, y)


def test_a_second_stretch_starts_afresh():
    run = _Pop(_cfg("full"))
    run.step(0)
    _profiled(lambda: (run.step(1), run.step(2)))
    assert spans.summary()[("step", "forward")]["calls"] == 2
    run.step(3)                       # spans off: the next stretch is new
    _profiled(lambda: run.step(4))
    recs = spans.records()
    assert sum(r.name == "step" for r in recs) == 1
    assert recs[0].name == "step" and recs[0].parent is None


def test_nested_names_raised_and_dangling_spans():
    def stretch():
        spans.span("warm")            # a span without the profiler
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with spans.span("step"):
                with spans.span("cast"):
                    with spans.span("cast"):
                        pass
                with pytest.raises(RuntimeError):
                    with spans.span("failing"):
                        raise RuntimeError("unwound")
                x = torch.ones(2, requires_grad=True)
                bw = spans.backward_span("marked", x)
                bw.output(bw.input(x) * 1).sum().backward()
                # a mark whose closing never runs is closed by its parent
                y = torch.ones(2, requires_grad=True)
                bw = spans.backward_span("dangling", y * 2)
                bw.output(torch.ones(2, requires_grad=True)).sum().backward()
        return [e.name for e in prof.events()]
    timeline = stretch()
    # each recorded span is a range in the profiler's host timeline
    for name in ("step", "cast", "failing", "marked", "dangling"):
        assert timeline.count(name) == 1, name
    recs = spans.records()
    assert [r.name for r in recs] == ["step", "cast", "failing", "marked",
                                      "dangling"]
    assert all(r.host_ms is not None for r in recs)
    assert [r.phase for r in recs][-2:] == ["backward", "backward"]
    s = spans.summary()
    assert s[("cast", "forward")]["calls"] == 1
    assert s[("failing", "forward")]["calls"] == 1
    assert s[("marked", "backward")]["calls"] == 1
    assert s[("step", "forward")]["device_ms"] is None
    assert s[("cast", "forward")]["host_ms"] <= s[("step", "forward")][
        "host_ms"]
