"""Spiking-network layer of the port: builders, the k=1 simulator, the k>1
``DistSimulator``, ``Session``, the supervised run's policies and monitors
(counterpart of ``repro.snn``), and the procedural construction surface of
:mod:`repro_torch.builder`."""
from .monitors import (  # noqa: F401
    PerNeuronRateMonitor,
    RasterMonitor,
    RateMonitor,
    SpikeCountMonitor,
    VMeanMonitor,
)
from .network import (  # noqa: F401
    PD14_PROBS,
    PD14_SIZES,
    NetworkDef,
    balanced_ei,
    microcircuit,
    mixed_population,
    spatial_random,
    to_dcsr,
)
from .dist_sim import DistSimulator  # noqa: F401
from .session import RunResult, Session  # noqa: F401
from .simulator import SimConfig, Simulator  # noqa: F401
from .supervisor import (  # noqa: F401
    HealthConfig,
    RestoreReport,
    RetryPolicy,
    SupervisedResult,
    SupervisorEvent,
    restore_resilient,
)
from ..builder import (  # noqa: F401  (procedural construction surface)
    ConnectRule,
    DistanceKernel,
    Population,
    RuleSpec,
    balanced_ei_rules,
    microcircuit_rules,
    spatial_random_rules,
)
