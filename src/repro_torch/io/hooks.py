"""The port's fault hooks: the snapshot write and read paths, and the
supervised run's state.

Every site the reference's ``repro.testing.faults`` names in its io stack
(``shard_write``, ``shard_write:post``, ``manifest_write``, ``shard_read``
and the three ``atomic_dir:*`` sites) calls :func:`fault_point` here with
the same name and path.  It does nothing unless a callable was installed
with :func:`fault_hook`; the installed callable sees every site on every
thread (the shard writers run on a thread pool, the checkpoint queue on a
background worker) and may raise, sleep or damage the file at ``path``.

The supervised run (``snn.supervisor``) passes its carry through
:func:`apply_state_faults` at ``supervisor:state`` after every chunk, before
the health check.  It returns the state unchanged unless a callable was
installed with :func:`state_fault_hook`; the callable gets ``(site, state)``
(a dict at k = 1, the list of per-partition carries on the spmd engine) and
returns the state to go on with, so it may poison a membrane.

The port has no fault harness of its own: its tests install the reference's
``fault_point`` (and an adapter around its ``apply_state_faults``), so the
reference's ``FaultPlan`` kinds drive the port unchanged.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Optional

_HOOK: Optional[Callable[[str, Optional[str]], None]] = None
_STATE_HOOK: Optional[Callable[[str, Any], Any]] = None


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


def apply_state_faults(site: str, state):
    """``state`` as the installed state hook returns it; ``state`` itself
    without one."""
    hook = _STATE_HOOK
    return state if hook is None else hook(site, state)


@contextlib.contextmanager
def state_fault_hook(fn: Callable[[str, Any], Any]) -> Iterator[Callable]:
    """Install ``fn(site, state) -> state`` as the state hook for the
    ``with`` block (the previous hook, if any, comes back on exit)."""
    global _STATE_HOOK
    prev = _STATE_HOOK
    _STATE_HOOK = fn
    try:
        yield fn
    finally:
        _STATE_HOOK = prev
