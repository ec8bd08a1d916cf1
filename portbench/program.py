"""The system under test: the port's training entries, driven as a user
of the port drives them.

- "population": ``core.vmap_trials.PopulationTrainer``'s step (the
  vmapped ``make_population_step``), every argument with a leading trial
  axis, each trial its own rows, learning rate and weight decay;
- "single": ``launch.steps.make_train_step``, one trial.

Both update the state they are given in place.  The benchmark hands
them a state built from its own initial parameters and reads back only
what the port's state and step metrics hold: the losses, the gradient
norm before clipping, the first moments and the parameters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from portbench.reference.common import build_tree, get


def model_config(run: Dict):
    """The port's ``ModelConfig`` of a configuration file's ``run``
    block, which names every field."""
    from repro_torch.models.common import ModelConfig
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    if set(run) != fields:
        raise KeyError(f"run block: missing {sorted(fields - set(run))}, "
                       f"unknown {sorted(set(run) - fields)}")
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in run.items()})


def shapes(cfg) -> Dict[Tuple, Tuple[int, ...]]:
    """Every parameter's path and shape in the port's own layout."""
    from repro_torch.models import LM
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = tuple(node.shape)
    walk(LM(cfg).init(0, "meta"), ())
    return out


class Trainer:
    """One cell's trainer over a state of P trials (P = 1 for "single")."""

    def __init__(self, run: Dict, traffic: Dict, hp: Dict[str, List[float]],
                 device):
        from repro_torch.optim import AdamWConfig
        self.cfg = model_config(run)
        self.kind = traffic["trainer"]
        self.device = torch.device(device)
        opt = traffic["optimizer"]
        if self.kind == "population":
            from repro_torch.core.vmap_trials import PopulationTrainer
            pop = PopulationTrainer(self.cfg, AdamWConfig(**opt),
                                    device=self.device)
            self._step = pop.step
            self._lr = torch.tensor(hp["lr"], device=self.device)
            self._wd = torch.tensor(hp["weight_decay"], device=self.device)
        else:
            from repro_torch.launch.steps import make_train_step
            _, self._step = make_train_step(self.cfg, AdamWConfig(
                lr=hp["lr"][0], weight_decay=hp["weight_decay"][0], **opt))
        self.state = None

    def load(self, paths: Sequence[Tuple], stacked: Sequence[torch.Tensor]):
        """The state from the parameters (trials, *shape) at ``paths``,
        which it keeps: the step updates them in place."""
        want = shapes(self.cfg)
        got = {p: tuple(t.shape[1:]) for p, t in zip(paths, stacked)}
        if got != want:
            raise ValueError(f"parameter layout differs from the port's: "
                             f"{sorted(set(got.items()) ^ set(want.items()))[:4]}")
        if self.kind == "population":
            params = build_tree(list(zip(paths, stacked)))
            zeros = lambda: build_tree(  # noqa: E731
                [(p, torch.zeros_like(t)) for p, t in zip(paths, stacked)])
            self.state = {"params": params,
                          "opt": {"m": zeros(), "v": zeros(),
                                  "step": torch.zeros(len(stacked[0]),
                                                      dtype=torch.int32,
                                                      device=self.device)}}
        else:
            from repro_torch.optim import adamw_init
            params = build_tree([(p, t[0]) for p, t in zip(paths, stacked)])
            self.state = {"params": params, "opt": adamw_init(params)}

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One training step -> {"loss", "grad_norm"}, each (P,), on the
        device (nothing waits for it)."""
        if self.kind == "population":
            self.state, m = self._step(self.state, batch, self._lr, self._wd)
        else:
            self.state, m = self._step(self.state, batch)
        return {"loss": m["loss"].reshape(-1),
                "grad_norm": m["grad_norm"].reshape(-1)}

    def _leaf(self, tree, path) -> torch.Tensor:
        t = get(tree, path)
        return t if self.kind == "population" else t.unsqueeze(0)

    def params(self, path) -> torch.Tensor:
        """A parameter now, (P, *shape)."""
        return self._leaf(self.state["params"], path)

    def first_moment(self, path) -> torch.Tensor:
        """AdamW's first moment of a parameter, (P, *shape)."""
        return self._leaf(self.state["opt"]["m"], path)

    def close(self) -> None:
        self.state = None
        self._step = None

