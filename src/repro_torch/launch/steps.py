"""Step functions of the port: training and serving.

The reference's ``launch/steps.py`` without its mesh and sharding specs
(``state_specs``, ``batch_specs``, ``decode_specs``, ``named``), which
belong to the mesh tooling the port has not ported (ROADMAP.md §1): the
port trains and serves on one card.  A train step differentiates the
compute-dtype cast of the float32 masters, as the reference does, and
updates the masters with AdamW; it donates the state it is given, as
the reference's jit does (``adamw_update`` writes the new values into
its tensors).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.models import LM
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import tensors, tree_map
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update


def cast_params(params, dtype: torch.dtype, device=None):
    """Cast floating leaves (f32 masters) to the compute dtype, once, and
    move every leaf to ``device`` when one is given."""
    return tree_map(
        lambda a: a.to(device=device,
                       dtype=dtype if a.is_floating_point() else a.dtype),
        params)


def loss_and_grads(model: LM, params, batch):
    """``model.loss`` at ``params`` and its gradients by autograd ->
    (loss, metrics, grads): grads in ``params``' structure and dtypes,
    loss and metrics detached.  ``params`` are not changed (the gradient
    is taken at detached aliases of them)."""
    leaves = tree_map(lambda a: a.detach().requires_grad_(), params)
    with torch.enable_grad():
        loss, metrics = model.loss(leaves, batch)
        grads = iter(torch.autograd.grad(loss, list(tensors(leaves))))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), leaves))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, schedule=None):
    """-> (model, train_step(state, batch) -> (state, metrics)).  batch:
    {"tokens", "labels"} (B,S) int64 on the state's device."""
    model = LM(cfg)

    def train_step(state, batch):
        # differentiate w.r.t. the cast params; AdamW re-accumulates in f32
        p_c = cast_params(state["params"], cfg.compute_dtype)
        loss, metrics, grads = loss_and_grads(model, p_c, batch)
        del p_c
        lr = schedule(state["opt"]["step"]) if schedule else opt_cfg.lr
        with torch.no_grad():
            new_p, new_opt, om = adamw_update(
                grads, state["opt"], state["params"], opt_cfg, lr)
        metrics = dict(metrics, loss=loss, lr=lr, **om)
        return {"params": new_p, "opt": new_opt}, metrics

    return model, train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int):
    model = LM(cfg)

    def prefill_step(params, batch):
        return model.prefill(params, batch, cache_len)

    return model, prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, cache, tokens) -> (next, cache)."""
    model = LM(cfg)

    def serve_step(params, cache, tokens):
        logits, cache = model.decode_step(params, cache, tokens)
        return torch.argmax(logits, dim=-1), cache

    return model, serve_step


def init_train_state(cfg: ModelConfig, seed: int = 0,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """Parameters from ``seed`` in the config's storage dtype (float32
    masters) and zero AdamW state, on ``device`` (the card by default)."""
    params = LM(cfg).init(seed, resolve(device))
    return {"params": params, "opt": adamw_init(params)}
