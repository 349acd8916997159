"""Spiking-network layer of the port: builders, the k=1 simulator, the k>1
``DistSimulator``, ``Session`` and monitors (counterpart of ``repro.snn``)."""
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
