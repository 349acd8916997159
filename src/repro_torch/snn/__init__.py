"""Spiking-network layer of the port: builders, the k=1 simulator, the k>1
``DistSimulator``, ``Session`` and monitors (counterpart of ``repro.snn``),
and the procedural construction surface of :mod:`repro_torch.builder`."""
from .monitors import (  # noqa: F401
    PerNeuronRateMonitor,
    RasterMonitor,
    RateMonitor,
    SpikeCountMonitor,
    VMeanMonitor,
)
from .network import (  # noqa: F401
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
from ..builder import (  # noqa: F401  (procedural construction surface)
    ConnectRule,
    DistanceKernel,
    Population,
    RuleSpec,
    balanced_ei_rules,
    microcircuit_rules,
    spatial_random_rules,
)
