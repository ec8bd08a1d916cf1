# The suggestion-service core of the port: spaces, experiment configs,
# the system-of-record store and the optimizers.  The cluster,
# scheduler and orchestrator are not ported yet.
from repro_torch.core.experiment import ExperimentConfig, Resources, TrialSpec
from repro_torch.core.space import Param, Space
from repro_torch.core.store import Store
from repro_torch.core.suggest import ASHA, Observation, make_optimizer

__all__ = ["ExperimentConfig", "Resources", "TrialSpec", "Param", "Space",
           "Store", "ASHA", "Observation", "make_optimizer"]
