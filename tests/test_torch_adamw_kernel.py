"""AdamW's CUDA kernels (``csrc/adamw.cu``) against the plain update on
the card; every test skips without one.

Each case takes three steps of ``adamw_update`` on CUDA tensors (the
kernels) and of the plain update (``optim/adamw.py`` ``_plain_leaf``,
``_update``'s order of operations) on a copy of the same state, the
plain one given the kernel's norm, so that both take the same clip
scale: parameters in float32 and bf16, gradients in float32 and bf16,
clipping on and off, the coupled weight decay on and off, the decoupled
per-trial decay on and off; one trial, and three under ``torch.func.vmap``
with their own lr and decay.  The leaves hold 1, 7, 1536 and 2^20 + 3
elements, a 0-dim one, and one whose tensors start 4 (2) bytes into their
storage, so the kernels take their element-by-element path.

Limits: p, m and v within 1e-6 of the plain ones, relative to each
tensor's largest element, after three steps; the norm within 1e-6 of the
plain one (both sum in float32 and double respectively, in other
orders).  The kernels also update the caller's own tensors, give the
same bits twice, and count one update launch a leaf.
"""
import pytest
import torch

from repro_torch.kernels import adamw as kaw
from repro_torch.models.model import tensors
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.optim import adamw as A

SHAPES = {"one": (1,), "seven": (7,), "rows": (3, 512),
          "big": (2 ** 20 + 3,), "scalar": ()}
#: a leaf whose p, g, m and v start one element into their storage
OFFSET = 1001
TRIALS = 3
LR, DECAY = (1e-3, 3e-3, 5e-4), (0.01, 0.1, 0.05)
TOL = 1e-6


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _offset(lead, dtype, dev, fill):
    n = 1
    for d in lead:
        n *= d
    buf = fill(n * OFFSET + 1, dtype, dev)
    return buf[1:].view(lead + (OFFSET,))


def _tree(lead, dtype, dev, gen, scale=1.0):
    rand = lambda n, dt, d: (scale * torch.randn(  # noqa: E731
        n, generator=gen, device=d)).to(dt)
    out = {k: rand(int(torch.Size(lead + s).numel()), dtype, dev)
           .view(lead + s) for k, s in SHAPES.items()}
    out["offset"] = _offset(lead, dtype, dev, rand)
    return out


def _state(lead, p_dtype, dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _tree(lead, p_dtype, dev, gen)
    zeros = lambda n, dt, d: torch.zeros(n, dtype=dt, device=d)  # noqa: E731
    moments = lambda: dict(  # noqa: E731
        {k: torch.zeros(lead + s, device=dev) for k, s in SHAPES.items()},
        offset=_offset(lead, torch.float32, dev, zeros))
    return {"params": params, "m": moments(), "v": moments(),
            "step": torch.zeros(lead, dtype=torch.int32, device=dev)}


def _copy(state):
    """A copy with the same layout (storage offsets kept)."""
    out = {}
    for key in ("params", "m", "v"):
        out[key] = {k: a.clone() for k, a in state[key].items()}
        base = state[key]["offset"]
        flat = torch.empty(base.numel() + 1, dtype=base.dtype,
                           device=base.device)
        out[key]["offset"] = flat[1:].view(base.shape)
        out[key]["offset"].copy_(base)
    out["step"] = state["step"].clone()
    return out


def _kernel_step(state, grads, cfg, lr, decay, trials):
    opt = {"m": state["m"], "v": state["v"], "step": state["step"]}
    if trials is None:
        p, o, met = adamw_update(grads, opt, state["params"], cfg, lr,
                                 decay=decay)
    else:
        p, o, met = torch.func.vmap(
            lambda g, o, p, lr, d: adamw_update(g, o, p, cfg, lr, decay=d),
            in_dims=(0, 0, 0, 0, None if decay is None else 0))(
                grads, opt, state["params"], lr, decay)
    return {"params": p, "m": o["m"], "v": o["v"], "step": o["step"]}, \
        met["grad_norm"]


def _plain_step(state, grads, cfg, lr, decay, trials, norm):
    """The plain update of each trial, at the kernel's norm; -> the plain
    norm of each trial."""
    state["step"] = state["step"] + 1
    norms = []
    for i in range(1 if trials is None else trials):
        at = (lambda t: t) if trials is None else (lambda t: t[i])
        per = (lambda x: x[i] if isinstance(x, torch.Tensor) and x.dim()
               else x)
        gs = [at(g) for g in grads.values()]
        norms.append(A.global_norm(gs))
        scale, c1, c2 = A._coefficients(per(norm), per(state["step"]), cfg)
        for k, g in grads.items():
            A._plain_leaf(at(g), at(state["m"][k]), at(state["v"][k]),
                          at(state["params"][k]), scale, c1, c2, per(lr),
                          cfg, per(decay))
    return torch.stack(norms) if trials is not None else norms[0]


def _rel(got, want) -> float:
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale,
                                                                 1e-30)


def _case(dev, p_dtype, g_dtype, clip, wd, decay_on, trials, seed=0):
    cfg = AdamWConfig(clip_norm=clip, weight_decay=wd)
    lead = () if trials is None else (trials,)
    if trials is None:
        lr = 2e-3
        decay = torch.tensor(0.05, device=dev) if decay_on else None
    else:
        lr = torch.tensor(LR[:trials], device=dev)
        decay = torch.tensor(DECAY[:trials], device=dev) if decay_on \
            else None
    got = _state(lead, p_dtype, dev, seed)
    want = _copy(got)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    for _ in range(3):
        grads = _tree(lead, g_dtype, dev, gen, scale=3.0)
        ptrs = [t.data_ptr() for t in tensors(
            (got["params"], got["m"], got["v"]))]
        n0 = kaw.adamw_launches.count
        got, norm = _kernel_step(got, grads, cfg, lr, decay, trials)
        assert kaw.adamw_launches.count == n0 + len(grads)
        assert [t.data_ptr() for t in tensors(
            (got["params"], got["m"], got["v"]))] == ptrs
        plain_norm = _plain_step(want, grads, cfg, lr, decay, trials, norm)
        assert norm.shape == lead
        assert _rel(norm, plain_norm) <= TOL, (norm, plain_norm)
    torch.cuda.synchronize()
    assert torch.equal(got["step"], want["step"])
    for key in ("params", "m", "v"):
        for k in got[key]:
            a, b = got[key][k], want[key][k]
            assert a.dtype == b.dtype
            assert _rel(a, b) <= TOL, (key, k, _rel(a, b))
    return got


@pytest.mark.parametrize("trials,decay_on", [(None, False), (None, True),
                                             (TRIALS, True),
                                             (TRIALS, False)])
@pytest.mark.parametrize("clip,wd", [(1.0, 0.1), (0.0, 0.0), (1.0, 0.0),
                                     (0.0, 0.1)])
@pytest.mark.parametrize("p_dtype,g_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_kernel_matches_plain_update(dev, p_dtype, g_dtype, clip, wd,
                                     trials, decay_on):
    _case(dev, p_dtype, g_dtype, clip, wd, decay_on, trials)


@pytest.mark.parametrize("trials", (None, TRIALS))
def test_kernel_repeats_bit_for_bit(dev, trials):
    runs = [_case(dev, torch.float32, g, 1.0, 0.0, trials is not None,
                  trials, seed=4)
            for g in (torch.bfloat16, torch.bfloat16)]
    for a, b in zip(tensors(runs[0]), tensors(runs[1])):
        assert torch.equal(a, b)
    gen = [torch.Generator(device=dev).manual_seed(9) for _ in range(2)]
    lead = () if trials is None else (trials,)
    norms = [kaw.adamw_norm(list(_tree(lead, torch.bfloat16, dev, g).values()),
                            torch.ones(lead, dtype=torch.int32, device=dev),
                            AdamWConfig(), trials) for g in gen]
    assert torch.equal(norms[0][0], norms[1][0])
    assert torch.equal(norms[0][1], norms[1][1])


def test_kernel_refuses_what_it_does_not_take(dev):
    cfg = AdamWConfig()
    coef = torch.ones(1, 3, device=dev)
    p = torch.zeros(16, device=dev)
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    with pytest.raises(TypeError):
        kaw.adamw_leaf(p.half(), m.half(), m, v, coef, 1e-3, None, cfg)
    with pytest.raises(TypeError):
        kaw.adamw_leaf(p, m, m.double(), v, coef, 1e-3, None, cfg)
    with pytest.raises(ValueError, match="contiguous"):
        w = torch.zeros(4, 4, device=dev).t()
        kaw.adamw_leaf(w, w.clone(), torch.zeros(4, 4, device=dev).t(),
                       torch.zeros(4, 4, device=dev).t(), coef, 1e-3,
                       None, cfg)
    n0 = kaw.adamw_launches.count
    kaw.adamw_leaf(p, torch.ones_like(p), m, v, coef, 1e-3, None, cfg)
    assert kaw.adamw_launches.count == n0 + 1
