"""Power-loss durability: fsync policy for the checkpoint writers.

Rename atomicity (``os.replace``) alone is *crash*-safe but not
*power-loss*-safe: after a kernel crash or power cut, an un-fsynced data
file or directory entry can come back zero-length or missing even though
the rename "happened".  The write paths therefore fsync every data file
after writing and the enclosing directory around each rename (file →
directory → rename → parent directory, the classic recipe).

The fsyncs are on by default and can be disabled for throwaway state
(tests, benchmarks) via ``REPRO_FSYNC=0`` or :func:`set_fsync` — the
crash-window *restore* guarantees (CRC walk-back, ``.old`` fallback) do
not depend on them; only power-loss durability does.
"""
from __future__ import annotations

import contextlib
import os
import time
import zlib
from typing import Optional

from .hooks import fault_point

_OVERRIDE: Optional[bool] = None


def fsync_enabled() -> bool:
    if _OVERRIDE is not None:
        return _OVERRIDE
    return os.environ.get("REPRO_FSYNC", "1") not in ("0", "false", "no")


def set_fsync(enabled: Optional[bool]) -> None:
    """Force fsync on/off for this process; ``None`` returns control to
    the ``REPRO_FSYNC`` environment variable."""
    global _OVERRIDE
    _OVERRIDE = enabled


@contextlib.contextmanager
def fsync_override(enabled: Optional[bool]):
    global _OVERRIDE
    prev = _OVERRIDE
    _OVERRIDE = enabled
    try:
        yield
    finally:
        _OVERRIDE = prev


def fsync_file(f) -> None:
    """fsync an open file object (no-op when durability is off)."""
    if fsync_enabled():
        f.flush()
        os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """fsync a directory so its entries (renames, new files) are durable
    (no-op when durability is off, or on platforms that refuse O_RDONLY
    directory fds)."""
    if not fsync_enabled():
        return
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _file_crc(path: str) -> int:
    c = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return c
            c = zlib.crc32(chunk, c)


_WRITE_ATTEMPTS = 3
_WRITE_BACKOFF_S = 0.01


def write_bytes_verified(full: str, data: bytes, site: str) -> int:
    """Write ``data`` to ``full`` with fsync, read-back CRC verification
    and bounded retries.  Transient IO errors and torn writes are healed
    here, at the lowest level, so one flaky write never costs a whole
    snapshot; returns the CRC32 of ``data`` (== the on-disk CRC).
    ``site`` names the fault-injection hook points (``<site>`` before the
    write, ``<site>:post`` between the write and the verify)."""
    want = zlib.crc32(data)
    last: Optional[BaseException] = None
    for attempt in range(_WRITE_ATTEMPTS):
        if attempt:
            time.sleep(_WRITE_BACKOFF_S * (2 ** (attempt - 1)))
        try:
            fault_point(site, full)
            with open(full, "wb") as f:
                f.write(data)
                fsync_file(f)
            fault_point(site + ":post", full)
            if _file_crc(full) == want:
                return want
            last = IOError(
                f"torn write detected on {full} (read-back CRC mismatch)"
            )
        except OSError as e:
            last = e
    raise last
