"""dCSR core of the port: copies of the reference's numpy-only host layer.

  - :mod:`repro_torch.core.dcsr`      -- DCSRNetwork / DCSRPartition, build & repartition
  - :mod:`repro_torch.core.partition` -- block/hash/voxel/RCB partitioners + metrics
  - :mod:`repro_torch.core.ell`       -- delay-bucketed blocked-ELL view
  - :mod:`repro_torch.core.state`     -- model registry (the ``.model`` dictionary)
"""
from .dcsr import (  # noqa: F401
    DCSRNetwork,
    DCSRPartition,
    from_edges,
    to_edges,
    repartition,
    merge_to_single,
)
from .ell import DelayELL, ELLBucket, build_delay_ell  # noqa: F401
from .partition import (  # noqa: F401
    block_partition,
    hash_partition,
    voxel_partition,
    rcb_partition,
    rate_rebalance,
    balance,
    edge_cut,
)
from .state import (  # noqa: F401
    ModelRegistry,
    ModelSpec,
    default_registry,
    NONE_MODEL,
    EDGE_WEIGHT,
    EDGE_DELAY,
)
