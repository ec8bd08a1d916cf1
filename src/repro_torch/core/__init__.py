# The paper's primary contribution — parallel hyperparameter-optimization
# infrastructure: spaces + suggestion service + cluster + scheduler +
# lifecycle + monitoring; population execution (``vmap_trials``).
from repro_torch.core.cluster import Cluster, ClusterConfig, PoolConfig
from repro_torch.core.experiment import ExperimentConfig, Resources, TrialSpec
from repro_torch.core.orchestrator import Orchestrator
from repro_torch.core.scheduler import Scheduler, TrialContext, TrialStopped
from repro_torch.core.space import Param, Space
from repro_torch.core.store import Store
from repro_torch.core.suggest import ASHA, Observation, make_optimizer

__all__ = ["Cluster", "ClusterConfig", "PoolConfig", "ExperimentConfig",
           "Resources", "TrialSpec", "Orchestrator", "Scheduler",
           "TrialContext", "TrialStopped", "Param", "Space", "Store",
           "ASHA", "Observation", "make_optimizer"]
