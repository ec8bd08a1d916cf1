"""Wrapper of the hand-written CUDA AdamW (``csrc/adamw.cu``): the norm
of a state's gradient, with the clip scale and bias corrections it
gives, and the in-place update of one leaf.

``adamw_norm(gs, step, cfg, trials)`` sums the squares of every gradient
leaf, each block's sum into a fixed column of a scratch row, and adds
them in one fixed order in a second launch, so the norm repeats bit for
bit; it returns the norm and each trial's (clip scale, c1, c2), all on
the card.  ``adamw_leaf(g, m, v, p, coef, lr, decay, cfg, trials)``
writes the new p, m and v into the given tensors in one pass, in the
plain update's order of operations (``optim/adamw.py`` ``_update``).
With ``trials`` the leaves are a population's stacked (trials, ...)
tensors and ``lr``, ``decay`` and ``step`` may be (trials,): one launch
serves every trial.  p takes float32 or bf16, g float32 or bf16, m and v
float32; anything else raises, as does a tensor off the card (the plain
update is ``optim/adamw.py``'s own).  Every update launch adds one to
``adamw_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import work
from repro_torch.kernels._launch import I, I64, P, LaunchCounter, _fn, \
    _raise_on, current_stream, on_device

#: the dtype codes the kernels take
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: threads of a block, elements a thread loads at once, and the blocks of
#: the norm's kernel over all trials past which its threads loop
#: (``csrc/adamw.cu`` kThreads, kVec)
THREADS, VEC, NORM_BLOCKS = 256, 8, 1024

F = ctypes.c_float

adamw_launches = LaunchCounter()


def norm_blocks(n: int, trials: int) -> int:
    """Blocks the sum of squares gives one trial's n elements: one for
    every 4 loads of each of its threads, at most ``NORM_BLOCKS`` over
    all trials."""
    return max(1, min(-(-n // (THREADS * VEC * 4)), NORM_BLOCKS // trials))


def _count(trials) -> int:
    return 1 if trials is None else int(trials)


def _on_card(name: str, t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device}; the "
                         "plain update is optim/adamw.py's")


def _leaf(name: str, t: torch.Tensor, dev, dtypes, trials) -> None:
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {tuple(dtypes)}")
    if trials is not None and (t.dim() == 0 or t.shape[0] != trials):
        raise ValueError(f"{name}: shape {tuple(t.shape)} does not lead "
                         f"with the {trials} trials")


def _per_trial(name: str, t: torch.Tensor, count: int, dev, dtype):
    """A per-trial value on the card as the kernels read it: (tensor,
    stride), stride 0 for one value every trial shares."""
    t = t.to(device=dev, dtype=dtype).reshape(-1).contiguous()
    if t.numel() not in (1, count):
        raise ValueError(f"{name}: {t.numel()} values for {count} trials")
    return t, int(t.numel() > 1)


def adamw_norm(gs, step, cfg, trials=None):
    """gs: the gradient leaves, float32 or bf16, on one card ((trials,
    ...) each when ``trials`` is given); step: the step being taken,
    integer, 0-dim or (trials,); cfg: AdamW's constants (``b1``, ``b2``,
    ``clip_norm``) -> (norm float32, 0-dim or (trials,); coef float32
    (trials or 1, 3): each trial's clip scale, c1 and c2)."""
    _on_card("adamw_norm", gs[0])
    dev, count = gs[0].device, _count(trials)
    gs = [g.contiguous() for g in gs]
    cols, ncols = [], 0
    for i, g in enumerate(gs):
        _leaf(f"adamw_norm: grad {i}", g, dev, DTYPES, trials)
        n = g.numel() // count
        blocks = norm_blocks(n, count) if n else 0
        cols.append((n, ncols, blocks))
        ncols += blocks
    partials = torch.empty((count, ncols), dtype=torch.float64, device=dev)
    norm = torch.empty(() if trials is None else (count,),
                       dtype=torch.float32, device=dev)
    coef = torch.empty((count, 3), dtype=torch.float32, device=dev)
    steps, step_stride = _per_trial("adamw_norm: step", step, count, dev,
                                    torch.int32)
    sumsq = _fn("adamw", "adamw_sumsq_launch",
                [P, I, I64, I, P, I, I, I, I, P])
    finalize = _fn("adamw", "adamw_finalize_launch",
                   [P, I, I, P, I, P, P, I, F, F, F, P])
    with on_device(dev):
        stream = current_stream(dev)
        for g, (n, col0, blocks) in zip(gs, cols):
            if n == 0:
                continue
            _raise_on(sumsq(g.data_ptr(), DTYPES[g.dtype], n, count,
                            partials.data_ptr(), ncols, col0, blocks,
                            int(g.data_ptr() % 16 == 0), stream),
                      "adamw_norm")
            work.charge("adamw_norm", work.sumsq_work, g.numel(),
                        g.element_size())
        _raise_on(finalize(partials.data_ptr(), ncols, count,
                           steps.data_ptr(), step_stride, norm.data_ptr(),
                           coef.data_ptr(), int(bool(cfg.clip_norm)),
                           float(cfg.clip_norm), float(cfg.b1),
                           float(cfg.b2), stream), "adamw_norm")
    return norm, coef


def adamw_leaf(g, m, v, p, coef, lr, decay, cfg, trials=None) -> None:
    """One leaf's update, written into p, m and v: p float32 or bf16, g
    float32 or bf16, m and v float32, all of one shape ((trials, ...)
    when ``trials`` is given) on one card, p, m and v contiguous; coef
    (trials or 1, 3) float32 as ``adamw_norm`` gives it; lr a number or a
    tensor, 0-dim or (trials,); decay None or likewise, the decoupled
    decay p − lr·decay·p_old; cfg: AdamW's constants (``b1``, ``b2``,
    ``eps``, ``weight_decay``)."""
    _on_card("adamw", p)
    dev, count = p.device, _count(trials)
    _leaf("adamw: p", p, dev, DTYPES, trials)
    _leaf("adamw: g", g, dev, DTYPES, trials)
    for name, t in (("m", m), ("v", v)):
        _leaf(f"adamw: {name}", t, dev, (torch.float32,), trials)
    for name, t in (("g", g), ("m", m), ("v", v)):
        if t.shape != p.shape:
            raise ValueError(f"adamw: {name} is {tuple(t.shape)}, p "
                             f"{tuple(p.shape)}")
    for name, t in (("p", p), ("m", m), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"adamw: {name} is not contiguous, so it "
                             "cannot be updated in place")
    if coef.device != dev or coef.dtype != torch.float32 \
            or tuple(coef.shape) != (count, 3):
        raise ValueError(f"adamw: coef {tuple(coef.shape)} {coef.dtype} on "
                         f"{coef.device}, expected ({count}, 3) float32")
    n = p.numel() // count
    if n == 0:
        return
    g = g.contiguous()
    if isinstance(lr, torch.Tensor):
        lrs, lr_stride = _per_trial("adamw: lr", lr, count, dev,
                                    torch.float32)
        lr_ptr, lr_value = lrs.data_ptr(), 0.0
    else:
        lr_ptr, lr_stride, lr_value = None, 0, float(lr)
    decays, decay_stride = (None, 0) if decay is None else _per_trial(
        "adamw: decay", decay, count, dev, torch.float32)
    vec = int(all(t.data_ptr() % 16 == 0 for t in (p, g, m, v)))
    fn = _fn("adamw", "adamw_update_launch",
             [P, I, P, I, P, P, I64, I, P, P, I, F, P, I] + [F] * 5
             + [I, F, I, P])
    with on_device(dev):
        err = fn(p.data_ptr(), DTYPES[p.dtype], g.data_ptr(),
                 DTYPES[g.dtype], m.data_ptr(), v.data_ptr(), n, count,
                 coef.data_ptr(), lr_ptr, lr_stride, lr_value,
                 None if decays is None else decays.data_ptr(),
                 decay_stride, cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2,
                 cfg.eps, int(bool(cfg.weight_decay)),
                 float(cfg.weight_decay), vec, current_stream(dev))
    _raise_on(err, "adamw")
    adamw_launches.add()
    work.charge("adamw", work.adamw_work, p.numel(), p.element_size(),
                g.element_size())


def adamw_norm_meta(gs, step, cfg, trials=None):
    """``adamw_norm``'s meta function, for meta tensors (shapes only: the
    dry run): the norm and coef uninitialised, each leaf's sum charged by
    ``work.sumsq_work``."""
    for g in gs:
        work.charge("adamw_norm", work.sumsq_work, g.numel(),
                    g.element_size())
    count, dev = _count(trials), gs[0].device
    return (torch.empty(() if trials is None else (count,),
                        dtype=torch.float32, device=dev),
            torch.empty((count, 3), dtype=torch.float32, device=dev))


def adamw_leaf_meta(g, m, v, p, coef, lr, decay, cfg, trials=None) -> None:
    """``adamw_leaf``'s meta function: nothing made, the launch charged by
    ``work.adamw_work``."""
    work.charge("adamw", work.adamw_work, p.numel(), p.element_size(),
                g.element_size())
