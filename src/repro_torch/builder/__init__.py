"""Procedural per-partition network construction (counterpart of
``repro.builder``).

Declare a network as populations + connectivity rules (:class:`RuleSpec`,
:mod:`.rules`) and emit each partition's dCSR rows directly, chunk by chunk
(:mod:`.procedural`), with counter-based seeding (:mod:`.crng`) so any k,
chunk size and sampling path build the bit-identical network.  The
keystream runs on the card (``ops.builder_keystream``); the float assembly
stays in numpy on the host.

:mod:`.ingest` is the chunked streaming reader over on-disk dCSR snapshots
(``open_snapshot`` -> ``iter_rows``), feeding partition assembly and
``Session.restore(streaming=True)`` without holding more than one chunk plus
one partition in host memory.
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
from .ingest import (  # noqa: F401
    RowChunk,
    SnapshotReader,
    load_binary_streamed,
    load_merged_streamed,
    open_snapshot,
)
