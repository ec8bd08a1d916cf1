"""The one generator of the benchmark's training jobs.

A traffic file (``traffic/<name>.json``) is a job's parameters:

- ``trainer``: "population" (P trials in one program, each with its own
  rows, learning rate and weight decay) or "single" (one trial);
- ``trials``, ``batch``, ``seq``: P, rows a trial, token positions a row;
- ``lr``, ``weight_decay``: [low, high], each trial's value drawn
  log-uniform between them from the seed;
- ``optimizer``: AdamW's b1, b2, eps and clip_norm, shared by the trials;
- ``checked_steps``: the first steps, in set-up, that the reference
  follows; ``profiled_steps``: the steps a traced run profiles after its
  window.

Every step's batch is drawn on the device from (seed, step): token ids
uniform over the vocabulary, each row's labels its tokens shifted by one;
an encoder-decoder's frame embeddings (``encoder_seq`` of them a row)
standard normal, stored in the configuration's compute dtype, as the
program takes them.  The same seed gives the same jobs; another seed the
same sizes with other values.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench.weights import derive

TRAINERS = ("population", "single")


def check(traffic: Dict) -> None:
    if traffic["trainer"] not in TRAINERS:
        raise ValueError(f"trainer {traffic['trainer']!r} not in {TRAINERS}")
    if traffic["trainer"] == "single" and traffic["trials"] != 1:
        raise ValueError("a single trainer runs one trial")


def hyperparameters(traffic: Dict, seed: int) -> Dict[str, List[float]]:
    """Each trial's learning rate and weight decay, log-uniform over the
    file's ranges."""
    rng = np.random.default_rng(derive(seed, "hyperparameters"))
    out = {}
    for name in ("lr", "weight_decay"):
        lo, hi = traffic[name]
        out[name] = [float(math.exp(x)) for x in
                     rng.uniform(math.log(lo), math.log(hi), traffic["trials"])]
    return out


def lead(traffic: Dict) -> tuple:
    """The leading dims of every input: (P, B) for a population, (B,) for
    a single trial."""
    if traffic["trainer"] == "population":
        return (traffic["trials"], traffic["batch"])
    return (traffic["batch"],)


def batch(traffic: Dict, run: Dict, seed: int, step: int, device
          ) -> Dict[str, torch.Tensor]:
    """Step ``step``'s inputs on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "batch", step))
    dims = lead(traffic)
    ids = torch.randint(0, run["vocab_size"], dims + (traffic["seq"] + 1,),
                        generator=gen, device=device)
    out = {"tokens": ids[..., :-1].contiguous(),
           "labels": ids[..., 1:].contiguous()}
    if run.get("encoder_seq"):
        frames = torch.randn(dims + (run["encoder_seq"], run["d_model"]),
                             generator=gen, device=device)
        out["frames"] = frames.to(getattr(torch, run["dtype"]))
    return out


def trial_rows(b: Dict[str, torch.Tensor], traffic: Dict, trial: int
               ) -> Dict[str, torch.Tensor]:
    """One trial's rows of a batch."""
    if traffic["trainer"] == "population":
        return {k: v[trial] for k, v in b.items()}
    return b


def positions(b: Dict[str, torch.Tensor], traffic: Dict, counts) -> int:
    """Positions a step trains: for each input named in ``counts``, its
    rows times its sequence length, over every trial."""
    n = len(lead(traffic)) + 1
    return sum(math.prod(b[name].shape[:n]) for name in counts)
