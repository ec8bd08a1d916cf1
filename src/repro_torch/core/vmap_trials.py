"""Population training: P hyperparameter configurations trained at once
in one program, by ``torch.func.vmap`` over stacked parameters.

The port of the reference's ``core/vmap_trials.py``, its realization of
Orchestrate's "multiple model configurations simultaneously" (§2.1):
where the paper gives each configuration a pod of its own, the P trials'
parameters are stacked along a leading axis and the train step is
vmapped over it, so each layer's matrix products run as one batched
product for all P trials, and each of the attention and RG-LRU kernels
runs as one launch for all of them (their ``autograd.Function``s fold
the trial axis into the batch, ``kernels/ops.py``).

The step is ``torch.func.vmap`` over ``torch.func.grad_and_value`` of
``LM.loss`` at the float32 parameters (the reference's population does
not cast them), then AdamW without coupled decay and each trial's own
decoupled weight decay, p − lr·wd·p_old, as the reference applies it.
The update writes the state in place (``adamw_update``), which the
stacked state's size needs.  The config's remat holds here too: under
``torch.func`` the model rematerializes through an ``autograd.Function``
of its own (``models/model.py`` ``_Remat``; ``torch.utils.checkpoint``'s
saved-tensor hooks are refused there), which keeps each layer's input
and recomputes the layer in the backward, for "dots" as for "full".

All trials of a population share parameter shapes; only leaf
hyperparameters (learning rate, weight decay, init seed) vary.
``PopulationTrainer.train`` equals P sequential runs
(``tests/test_torch_population.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve
from repro_torch.models import LM
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import tensors, tree_map
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.spans import span


def _stack_init(model: LM, seeds: Sequence[int], device) -> Dict[str, Any]:
    """Per-trial ``model.init(seed)`` stacked along a leading axis, one
    trial's parameters alive besides the stack at a time."""
    stacked = None
    for i, seed in enumerate(seeds):
        params = model.init(seed, device)
        if stacked is None:
            stacked = tree_map(lambda a: a.new_empty((len(seeds),) + a.shape),
                               params)
        for dst, src in zip(tensors(stacked), tensors(params)):
            dst[i].copy_(src)
        del params
    return stacked


def _on_device(v, device) -> torch.Tensor:
    """A batch entry on ``device``: integers as ``long``, floats as they
    are."""
    t = (v.to(device) if isinstance(v, torch.Tensor)
         else torch.as_tensor(np.asarray(v), device=device))
    return t if t.is_floating_point() else t.long()


def make_trial_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """-> (model, step(state, batch, lr, wd) -> (state, metrics)): one
    trial's step, the function the population vmaps (lr and wd 0-dim
    tensors); it donates ``state``."""
    model = LM(cfg)
    ocfg = dataclasses.replace(opt_cfg, weight_decay=0.0)

    def loss_of(p, batch):
        with span("step.forward"):
            return model.loss(p, batch)

    def one_step(state, batch, lr, wd):
        with span("step"):
            with span("step.grads"):
                grads, (loss, _) = torch.func.grad_and_value(
                    lambda p: loss_of(p, batch), has_aux=True)(
                        state["params"])
            with torch.no_grad(), span("optim.adamw"):
                new_p, new_opt, om = adamw_update(
                    grads, state["opt"], state["params"], ocfg, lr, decay=wd)
        return {"params": new_p, "opt": new_opt}, {"loss": loss, **om}

    return model, one_step


def make_population_step(cfg: ModelConfig, opt_cfg: AdamWConfig):
    """-> (model, step(state, batch, lr, wd) -> (state, metrics)), every
    argument with a leading population axis: state the P-stacked
    {"params", "opt"}, batch (P,B,S) tokens and labels, lr and wd (P,).
    The step donates ``state``."""
    model, one_step = make_trial_step(cfg, opt_cfg)
    return model, torch.func.vmap(one_step, in_dims=(0, 0, 0, 0))


class PopulationTrainer:
    """Train P trials simultaneously; the vmap executor behind the
    scheduler's ``executor: vmap`` mode.  Runs on ``device`` (the CUDA
    card by default)."""

    def __init__(self, cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                 hp_names: Sequence[str] = ("lr", "weight_decay", "seed"),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.hp_names = tuple(hp_names)
        self.device = resolve(device)
        self.model, self.step = make_population_step(cfg, opt_cfg)

    def init_states(self, assignments: Sequence[Dict[str, Any]]):
        seeds = [int(a.get("seed", i)) for i, a in enumerate(assignments)]
        params = _stack_init(self.model, seeds, self.device)
        zeros = lambda: tree_map(  # noqa: E731
            lambda a: torch.zeros_like(a, dtype=torch.float32), params)
        return {"params": params,
                "opt": {"m": zeros(), "v": zeros(),
                        "step": torch.zeros((len(seeds),), dtype=torch.int32,
                                            device=self.device)}}

    def hp_vectors(self, assignments: Sequence[Dict[str, Any]]):
        """(lr (P,), wd (P,)) float32 on the device."""
        vec = lambda name, default: torch.tensor(  # noqa: E731
            [float(a.get(name, default)) for a in assignments],
            dtype=torch.float32, device=self.device)
        return (vec("lr", self.opt_cfg.lr),
                vec("weight_decay", self.opt_cfg.weight_decay))

    def train(self, assignments: Sequence[Dict[str, Any]],
              data_iter: Callable[[int], Dict[str, Any]],
              steps: int, eval_last: int = 8,
              report: Optional[Callable[[int, np.ndarray], None]] = None
              ) -> np.ndarray:
        """Run ``steps`` population steps; returns the per-trial objective
        = mean loss over the last ``eval_last`` steps (lower is better).
        ``data_iter(t)`` gives step t's batch (B, ...), shared by every
        trial: integer entries (tokens, labels) are made ``long``, float
        ones (whisper's ``frames``, a VLM's ``img_embeds``) keep their
        dtype."""
        P = len(assignments)
        state = self.init_states(assignments)
        lr, wd = self.hp_vectors(assignments)
        tail: List[np.ndarray] = []
        for t in range(steps):
            batch = {k: _on_device(v, self.device)
                     for k, v in data_iter(t).items()}
            pbatch = {k: v.expand(P, *v.shape) for k, v in batch.items()}
            state, metrics = self.step(state, pbatch, lr, wd)
            losses = metrics["loss"].float().cpu().numpy()
            if report is not None:
                report(t, losses)
            if t >= steps - eval_last:
                tail.append(losses)
        return np.mean(np.stack(tail), axis=0)
