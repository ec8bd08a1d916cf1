"""Suggestion service: ask/tell black-box optimizers over a Space.

This is the in-repo replacement for the SigOpt API that Orchestrate called
out to — every strategy the paper cites (grid [3], random [2], evolutionary
[14], swarm [4], Bayesian [6,11]) plus quasi-random Sobol and ASHA early
stopping (paper §2.5 "stopping experiments").
"""
from repro_torch.core.suggest.base import (Observation, Optimizer,
                                           StoppingPolicy, make_optimizer,
                                           make_stopping_policy)
from repro_torch.core.suggest.asha import ASHA

__all__ = ["Observation", "Optimizer", "make_optimizer", "ASHA",
           "StoppingPolicy", "make_stopping_policy"]
