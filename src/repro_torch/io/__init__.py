"""Serialization of the port: dCSR snapshots in the reference's binary
format 1.0 (``docs/FORMAT.md``), the atomic directory swap, the background
writer, the fsync policy and the fault hook (counterpart of ``repro.io``;
the paper's text format, the interop adapters and the tensor
``CheckpointManager`` are not ported yet)."""
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
from .checkpoint import atomic_dir  # noqa: F401
from .durability import (  # noqa: F401
    fsync_enabled,
    fsync_override,
    set_fsync,
    write_bytes_verified,
)
from .hooks import fault_hook, fault_point  # noqa: F401
