"""The port's fault hook for the snapshot write and read paths.

Every site the reference's ``repro.testing.faults`` names in its io stack
(``shard_write``, ``shard_write:post``, ``manifest_write``, ``shard_read``
and the three ``atomic_dir:*`` sites) calls :func:`fault_point` here with
the same name and path.  It does nothing unless a callable was installed
with :func:`fault_hook`; the installed callable sees every site on every
thread (the shard writers run on a thread pool, the checkpoint queue on a
background worker) and may raise, sleep or damage the file at ``path``.

The port has no fault harness of its own yet: its tests install the
reference's ``fault_point``, so the reference's ``FaultPlan`` kinds drive
the port's write and read paths unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterator, Optional

_HOOK: Optional[Callable[[str, Optional[str]], None]] = None


def fault_point(site: str, path: Optional[str] = None) -> None:
    """Call the installed hook with ``(site, path)``; a no-op without one."""
    hook = _HOOK
    if hook is not None:
        hook(site, path)


@contextlib.contextmanager
def fault_hook(fn: Callable[[str, Optional[str]], None]) -> Iterator[Callable]:
    """Install ``fn(site, path)`` as the hook for the ``with`` block (the
    previous hook, if any, comes back on exit)."""
    global _HOOK
    prev = _HOOK
    _HOOK = fn
    try:
        yield fn
    finally:
        _HOOK = prev
