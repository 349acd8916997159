"""Serialization of the port (counterpart of ``repro.io``): the paper's
plain-text dCSR format, dCSR snapshots in the reference's binary format 1.0
(``docs/FORMAT.md``), the LM substrate's tensor checkpoints
(``CheckpointManager``, the reference's on-disk layout), the atomic
directory swap, the background writer, the fsync policy, the fault hooks
and the interop adapters (adjacency dicts, ParMETIS triples)."""
from .dcsr_text import save_text, load_text  # noqa: F401
from .dcsr_binary import (  # noqa: F401
    NetSnapshot,
    ShardWriteError,
    save_binary,
    load_binary,
    load_latest_valid,
    quarantine_shards,
    snapshot_network,
    snapshot_steps,
    verify_snapshot,
    write_snapshot,
)
from .async_writer import AsyncWriter, WriteJobError  # noqa: F401
from .checkpoint import CheckpointManager, atomic_dir  # noqa: F401
from .durability import (  # noqa: F401
    fsync_enabled,
    fsync_override,
    set_fsync,
    write_bytes_verified,
)
from .hooks import (  # noqa: F401
    apply_state_faults,
    fault_hook,
    fault_point,
    state_fault_hook,
)
from .interop import (  # noqa: F401
    to_adjacency_dict,
    from_adjacency_dict,
    to_parmetis,
)
