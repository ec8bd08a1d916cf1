"""AdamW's dispatch on the CPU and on meta tensors (``optim/adamw.py``
around ``kernels/adamw.py``), where the kernels do not run:

* CPU tensors take the plain update, bit for bit the reference's order
  of operations written out here, and never reach the kernels' entries;
* under ``torch.func.vmap`` the update runs through ``_AdamW``'s vmap
  rule, one call for every trial, and its per-trial indexing gives the
  bits of P sequential single-trial updates, for gradients whose trial
  dim sits elsewhere too, and a leaf without the trial dim is refused;
* with the kernels' entries stood in for by plain versions of what they
  compute (the norm and each trial's clip scale, c1 and c2; each leaf's
  update from them), the rule hands them the stacked (P, ...) tensors and
  (P,) hyperparameters in one call a leaf, and the result is again the
  sequential one;
* ``portbench/faults.py``'s ``unchanged`` and ``double_leaf`` faults,
  planted around the new update, still change a tiny population's state;
* meta tensors (the dry run) take the meta functions: no tensor of a
  leaf's size is made, and the launches are charged by ``kernels/work.py``;
* the kernel wrappers refuse CPU tensors.
"""
import contextlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.registry import get_config
from repro_torch.core.vmap_trials import PopulationTrainer
from repro_torch.kernels import adamw as kaw
from repro_torch.kernels import ops, work
from repro_torch.models.model import tensors, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.optim import adamw as A

SHAPES = {"w": (6, 5), "b": (7,), "s": ()}
LR, DECAY = (1e-2, 3e-3, 2e-2), (0.1, 0.01, 0.05)


def _tree(shapes, lead, dtype, gen, scale=1.0):
    return {k: (scale * torch.randn(lead + s, generator=gen)).to(dtype)
            for k, s in shapes.items()}


def _state(lead, p_dtype, seed=0, shapes=SHAPES):
    gen = torch.Generator().manual_seed(seed)
    params = _tree(shapes, lead, p_dtype, gen)
    zeros = lambda: tree_map(  # noqa: E731
        lambda a: torch.zeros_like(a, dtype=torch.float32), params)
    return {"params": params, "m": zeros(), "v": zeros(),
            "step": torch.zeros(lead, dtype=torch.int32)}


def _clone(tree):
    return tree_map(lambda a: a.clone(), tree)


def _reference(grads, state, cfg, lr, decay):
    """The reference's update, written out: norm, clip scale, bias
    corrections, then each leaf in float32 in its order of operations."""
    step = state["step"] + 1
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in tensors(grads)))
    steps = step.to(torch.float32)
    c1 = 1.0 - torch.pow(cfg.b1, steps)
    c2 = 1.0 - torch.pow(cfg.b2, steps)
    out = {}
    for k in grads:
        g = grads[k].float()
        if cfg.clip_norm:
            g = g * torch.clamp(cfg.clip_norm
                                / torch.clamp(gnorm, min=1e-9), max=1.0)
        p = state["params"][k]
        m = cfg.b1 * state["m"][k] + (1 - cfg.b1) * g
        v = cfg.b2 * state["v"][k] + (1 - cfg.b2) * torch.square(g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * delta).to(p.dtype)
        if decay is not None:
            new_p = (new_p.float() - lr * decay * p.float()).to(p.dtype)
        out[k] = (new_p, m, v)
    return out, gnorm


@contextlib.contextmanager
def _no_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU update reached a kernel's entry")
    monkeypatch.setattr(ops, "adamw_norm", refuse)
    monkeypatch.setattr(ops, "adamw_leaf", refuse)
    yield


@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("clip,wd,decay", [
    (1.0, 0.1, None), (0.0, 0.0, 0.05), (1.0, 0.0, 0.05)])
def test_cpu_update_is_the_plain_one_bit_for_bit(monkeypatch, p_dtype,
                                                 g_dtype, clip, wd, decay):
    cfg = AdamWConfig(lr=1e-2, clip_norm=clip, weight_decay=wd)
    st = _state((), p_dtype)
    gen = torch.Generator().manual_seed(7)
    dec = None if decay is None else torch.tensor(decay)
    with _no_kernels(monkeypatch):
        for _ in range(3):
            grads = _tree(SHAPES, (), g_dtype, gen, scale=3.0)
            want, want_norm = _reference(grads, _clone(st), cfg, cfg.lr,
                                         dec)
            ptrs = [t.data_ptr() for t in tensors(
                (st["params"], st["m"], st["v"]))]
            p, o, met = adamw_update(grads, {k: st[k] for k in
                                             ("m", "v", "step")},
                                     st["params"], cfg, decay=dec)
            assert [t.data_ptr() for t in tensors((p, o["m"], o["v"]))] \
                == ptrs
            assert torch.equal(met["grad_norm"], want_norm)
            for k, (wp, wm, wv) in want.items():
                assert torch.equal(p[k], wp) and p[k].dtype == p_dtype
                assert torch.equal(o["m"][k], wm)
                assert torch.equal(o["v"][k], wv)
            st = {"params": p, "m": o["m"], "v": o["v"], "step": o["step"]}


def _vmapped(cfg, grads, st, lr, decay, grad_dims=0):
    def one(g, m, v, step, p, lr, d):
        return adamw_update(g, {"m": m, "v": v, "step": step}, p, cfg, lr,
                            decay=d)
    return torch.func.vmap(one, in_dims=(grad_dims, 0, 0, 0, 0, 0, 0))(
        grads, st["m"], st["v"], st["step"], st["params"], lr, decay)


def _sequential(cfg, grads, st, lr, decay):
    """Each trial's single-trial update of its own slices, in place."""
    norms = []
    for i in range(len(lr)):
        at = lambda t: tree_map(lambda a: a[i], t)  # noqa: E731
        _, _, met = adamw_update(at(grads), {"m": at(st["m"]),
                                             "v": at(st["v"]),
                                             "step": st["step"][i]},
                                 at(st["params"]), cfg, lr[i],
                                 decay=decay[i])
        norms.append(met["grad_norm"])
    return torch.stack(norms)


def _held_to_sequential(cfg, grads, p_dtype, grad_dims=0, steps=2,
                        shapes=SHAPES):
    lr, decay = torch.tensor(LR), torch.tensor(DECAY)
    got, want = (_state((3,), p_dtype, shapes=shapes) for _ in range(2))
    for t in range(steps):
        g = grads(t)
        _, o, met = _vmapped(cfg, g, got, lr, decay, grad_dims)
        got["step"] = o["step"]
        stacked = g if grad_dims == 0 else {
            k: a.movedim(grad_dims[k], 0) for k, a in g.items()}
        norms = _sequential(cfg, stacked, want, lr, decay)
        want["step"] = want["step"] + 1
        assert torch.equal(met["grad_norm"], norms)
        assert torch.equal(o["step"], want["step"])
        for a, b in zip(tensors((got["params"], got["m"], got["v"])),
                        tensors((want["params"], want["m"], want["v"]))):
            assert torch.equal(a, b)


@pytest.mark.parametrize("p_dtype,g_dtype,clip", [
    (torch.float32, torch.float32, 1.0), (torch.float32, torch.bfloat16, 0.0),
    (torch.bfloat16, torch.float32, 1.0)])
def test_vmap_rule_matches_sequential_trials(monkeypatch, p_dtype, g_dtype,
                                             clip):
    cfg = AdamWConfig(clip_norm=clip, weight_decay=0.0)
    gen = torch.Generator().manual_seed(3)
    calls = []
    real = A._all_leaves
    monkeypatch.setattr(A, "_all_leaves", lambda trials, *a: (
        calls.append(trials), real(trials, *a))[1])
    with _no_kernels(monkeypatch):
        _held_to_sequential(cfg, lambda t: _tree(SHAPES, (3,), g_dtype, gen,
                                                 scale=3.0), p_dtype)
    # one call of the rule a step, for all three trials, then the
    # sequential single-trial updates
    assert calls == [3, None, None, None] * 2


def test_vmap_rule_takes_gradients_with_their_trial_dim_elsewhere():
    """A gradient whose physical trial dim is not the first (moved to the
    front by the rule) gives the bits of the sequential updates."""
    cfg = AdamWConfig(weight_decay=0.0)
    gen = torch.Generator().manual_seed(5)

    def grads(t):
        return {"w": 3 * torch.randn(6, 3, 5, generator=gen),
                "b": 3 * torch.randn(3, 7, generator=gen)}
    _held_to_sequential(cfg, grads, torch.float32,
                        grad_dims={"w": 1, "b": 0},
                        shapes={"w": (6, 5), "b": (7,)})


@pytest.mark.parametrize("shared", ("grad", "param"))
def test_vmap_rule_refuses_a_leaf_without_the_trial_dim(shared):
    """A gradient or a parameter every trial shares (no trial dim) is
    refused: a shared state leaf cannot take each trial's update, and a
    gradient of vmapped parameters always has the dim."""
    cfg = AdamWConfig(weight_decay=0.0)
    st = _state((3,), torch.float32, shapes={"b": (7,)})
    g, g_dim, p_dim = {"b": torch.ones(3, 7)}, 0, 0
    if shared == "grad":
        g, g_dim = {"b": torch.ones(7)}, None
    else:
        st["params"], p_dim = {"b": torch.zeros(7)}, None

    def one(g, m, v, step, p, lr):
        return adamw_update(g, {"m": m, "v": v, "step": step}, p, cfg, lr)
    with pytest.raises(ValueError, match="without the trials' dim"):
        torch.func.vmap(one, in_dims=(g_dim, 0, 0, 0, p_dim, 0))(
            g, st["m"], st["v"], st["step"], st["params"],
            torch.tensor(LR))


def _stand_ins(monkeypatch, calls):
    """The kernels' entries as plain versions of what they compute, for
    CPU tensors: the norm and each trial's (clip scale, c1, c2); a leaf's
    update from them, trial by trial."""
    def norm(gs, step, cfg, trials=None):
        calls.append(("norm", trials, tuple(g.shape for g in gs)))
        count = 1 if trials is None else trials
        at = lambda x, i: x[i] if trials is not None and x.dim() else x  # noqa: E731,E501
        norms, coef = [], []
        for i in range(count):
            n = A.global_norm([g[i] if trials else g for g in gs])
            scale, c1, c2 = A._coefficients(n, at(step, i), cfg)
            norms.append(n)
            coef.append(torch.stack([torch.ones(()) if scale is None
                                     else scale, c1, c2]))
        out = torch.stack(norms) if trials is not None else norms[0]
        return out, torch.stack(coef)

    def leaf(g, m, v, p, coef, lr, decay, cfg, trials=None):
        calls.append(("leaf", trials, tuple(p.shape), tuple(
            () if not isinstance(x, torch.Tensor) else x.shape
            for x in (lr, decay))))
        assert p.is_contiguous() and m.is_contiguous()
        for i in range(1 if trials is None else trials):
            sel = (lambda t: t[i]) if trials is not None else (lambda t: t)
            per = (lambda x: x[i] if isinstance(x, torch.Tensor) and x.dim()
                   else x)
            A._plain_leaf(sel(g), sel(m), sel(v), sel(p), coef[i, 0],
                          coef[i, 1], coef[i, 2], per(lr), cfg, per(decay))
    monkeypatch.setattr(ops, "adamw_norm", norm)
    monkeypatch.setattr(ops, "adamw_leaf", leaf)
    # the stand-ins serve CPU tensors as the kernels serve CUDA ones
    real = A._all_leaves

    def all_leaves(trials, gs, ms, vs, ps, *rest):
        if ps[0].device.type != "cpu":
            return real(trials, gs, ms, vs, ps, *rest)
        step, lr, decay, cfg = rest
        n, coef = ops.adamw_norm(gs, step, cfg, trials)
        for g, m, v, p in zip(gs, ms, vs, ps):
            ops.adamw_leaf(g, m, v, p, coef, lr, decay, cfg, trials)
        return n
    monkeypatch.setattr(A, "_all_leaves", all_leaves)


def test_vmap_rule_hands_the_kernels_the_stacked_trials(monkeypatch):
    """The kernels' path of the rule, with stand-ins for the kernels: one
    norm call and one call a leaf for the three trials, on the (3, ...)
    tensors and (3,) lr and decay, and the bits of the sequential
    updates."""
    cfg = AdamWConfig(clip_norm=1.0, weight_decay=0.0)
    gen = torch.Generator().manual_seed(11)
    lr, decay = torch.tensor(LR), torch.tensor(DECAY)
    got, want = _state((3,), torch.float32), _state((3,), torch.float32)
    calls = []
    g = _tree(SHAPES, (3,), torch.bfloat16, gen, scale=3.0)
    _sequential(cfg, g, want, lr, decay)
    _stand_ins(monkeypatch, calls)
    _, _, met = _vmapped(cfg, g, got, lr, decay)
    assert calls[0] == ("norm", 3, ((3, 6, 5), (3, 7), (3,)))
    assert calls[1:] == [("leaf", 3, s, ((3,), (3,)))
                         for s in ((3, 6, 5), (3, 7), (3,))]
    assert met["grad_norm"].shape == (3,)
    for a, b in zip(tensors((got["params"], got["m"], got["v"])),
                    tensors((want["params"], want["m"], want["v"]))):
        assert torch.equal(a, b)


def _tiny_population():
    cfg = get_config("granite-moe-3b-a800m").reduced(n_layers=1)
    trainer = PopulationTrainer(cfg, AdamWConfig(), device="cpu")
    assigns = [{"lr": 1e-2, "weight_decay": 0.1, "seed": 0},
               {"lr": 3e-3, "weight_decay": 0.01, "seed": 1}]
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (2, 2, 9), generator=gen)
    batch = {"tokens": tokens[..., :-1], "labels": tokens[..., 1:]}

    def run():
        state = trainer.init_states(assigns)
        lr, wd = trainer.hp_vectors(assigns)
        state, _ = trainer.step(state, batch, lr, wd)
        return list(tensors(state["params"]))
    return run


@pytest.mark.parametrize("fault", ("unchanged", "double_leaf"))
def test_planted_faults_change_a_tiny_population(fault):
    from portbench import faults
    run = _tiny_population()
    init = [t.clone() for t in tensors(PopulationTrainer(
        get_config("granite-moe-3b-a800m").reduced(n_layers=1),
        device="cpu").init_states([{"seed": 0}, {"seed": 1}])["params"])]
    clean = run()
    with faults.planted(fault):
        planted = run()
    assert not all(torch.equal(a, b) for a, b in zip(clean, init))
    if fault == "unchanged":
        assert all(torch.equal(a, b) for a, b in zip(planted, init))
    else:
        assert not torch.equal(planted[0], clean[0])
        assert all(torch.equal(a, b)
                   for a, b in zip(planted[1:], clean[1:]))


class _Sizes(TorchDispatchMode):
    """The largest tensor any operation makes (a view makes none)."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tensors(out if isinstance(out, (list, tuple))
                             else [out]):
                if isinstance(t, torch.Tensor):
                    self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("trials", (None, 2))
def test_meta_update_makes_no_temporaries_and_charges_the_work(trials):
    cfg = AdamWConfig()
    lead = () if trials is None else (trials,)
    shapes = {"w": (1024, 512), "g": (300,)}
    params = {k: torch.empty(lead + s, device="meta") for k, s in
              shapes.items()}
    grads = {"w": torch.empty(lead + (1024, 512), device="meta",
                              dtype=torch.bfloat16),
             "g": torch.empty(lead + (300,), device="meta")}
    st = {"m": _clone(params), "v": _clone(params),
          "step": torch.zeros(lead, dtype=torch.int32, device="meta")}
    sizes = _Sizes()
    with work.charging() as tally, sizes:
        if trials is None:
            _, _, met = adamw_update(grads, st, params, cfg)
        else:
            _, _, met = torch.func.vmap(
                lambda g, o, p, lr: adamw_update(g, o, p, cfg, lr))(
                    grads, st, params, torch.full((trials,), 1e-3,
                                                  device="meta"))
    assert sizes.largest <= max(3, 3 * (trials or 1))
    assert met["grad_norm"].shape == lead
    count = trials or 1
    n_w, n_g = count * 1024 * 512, count * 300
    assert tally.kernels["adamw"]["launches"] == 2
    assert tally.kernels["adamw"]["bytes"] == (
        work.adamw_work(n_w, 4, 2)[1] + work.adamw_work(n_g, 4, 4)[1])
    assert tally.kernels["adamw_norm"]["bytes"] == 2 * n_w + 4 * n_g
    assert kaw.adamw_launches.count == 0


def test_work_formulas():
    assert work.adamw_work(10, 4, 4) == (170, 280)
    assert work.adamw_work(10, 4, 2) == (170, 260)
    assert work.adamw_work(10, 2, 2) == (170, 220)
    assert work.sumsq_work(10, 2) == (20, 20)
    assert kaw.norm_blocks(1, 4) == 1
    assert kaw.norm_blocks(10 ** 9, 4) == kaw.NORM_BLOCKS // 4
    assert kaw.norm_blocks(8192 * 3, 1) == 3


def test_kernel_wrappers_refuse_cpu_tensors():
    p = torch.zeros(8)
    coef = torch.ones(1, 3)
    with pytest.raises(ValueError, match="no kernel"):
        kaw.adamw_leaf(p, p.clone(), p.clone(), p, coef, 1e-3, None,
                       AdamWConfig())
    with pytest.raises(ValueError, match="no kernel"):
        kaw.adamw_norm([p], torch.tensor(1), AdamWConfig())
    with pytest.raises(ValueError, match="no kernel"):
        ops.adamw_leaf(p, p.clone(), p.clone(), p, coef, 1e-3, None,
                       AdamWConfig())


def test_adamw_init_and_update_keep_the_tree():
    st = _state((), torch.float32)
    params = st["params"]
    opt = adamw_init(params)
    grads = _tree(SHAPES, (), torch.float32, torch.Generator().manual_seed(1))
    p, o, _ = adamw_update(grads, opt, params, AdamWConfig())
    assert p is not params and set(p) == set(params)
    assert all(p[k] is params[k] for k in params)
    assert all(o["m"][k] is opt["m"][k] for k in params)
    assert int(o["step"]) == 1 and int(opt["step"]) == 0
