"""Procedural per-partition network construction (counterpart of
``repro.builder``).

Declare a network as populations + connectivity rules (:class:`RuleSpec`,
:mod:`.rules`) and emit each partition's dCSR rows directly, chunk by chunk
(:mod:`.procedural`), with counter-based seeding (:mod:`.crng`) so any k,
chunk size and sampling path build the bit-identical network.  The
keystream runs on the card (``ops.builder_keystream``); the float assembly
stays in numpy on the host.

The reference's streaming snapshot reader (``repro.builder.ingest``) is not
ported yet; the port reads snapshots whole (``repro_torch.io``).
"""

from .rules import (  # noqa: F401
    ConnectRule,
    DistanceKernel,
    Population,
    RuleSpec,
    balanced_ei_rules,
    microcircuit_rules,
    spatial_random_rules,
    spec_from_dict,
    spec_to_dict,
)
from .procedural import (  # noqa: F401
    DEFAULT_CHUNK_ROWS,
    BuildReport,
    build_network,
    build_partition,
    network_def,
    resolve_build_path,
)
