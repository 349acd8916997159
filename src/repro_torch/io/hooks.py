"""The port's fault hooks: the snapshot write and read paths, and the
supervised run's state.

Every site of the port's io stack (``shard_write``, ``shard_write:post``,
``manifest_write``, ``shard_read``, ``text_write`` and the three
``atomic_dir:*`` sites) calls :func:`fault_point` here with the reference's
name and path.  It first runs the port's active fault plans
(``repro_torch.testing.fault_plans``: ``FaultPlan``, ``chaos_plan``), then
a callable installed with :func:`fault_hook`, if any.  Both see every site
on every thread (the shard writers run on a thread pool, the checkpoint
queue on a background worker) and may raise, sleep or damage the file at
``path``.  With no plan active and no hook installed it is one list check.

The supervised run (``snn.supervisor``) passes its carry through
:func:`apply_state_faults` at ``supervisor:state`` after every chunk, before
the health check: the active plans' ``nan`` and ``storm`` faults write into
the carry's membranes in place, then a callable installed with
:func:`state_fault_hook` gets ``(site, state)`` (a dict at k = 1, the list
of per-partition carries on the spmd engine) and returns the state to go on
with.

The installed callables let the cross-package tests drive the port with the
reference's own ``FaultPlan`` (``fault_hook(repro.testing.faults.fault_point)``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Iterator, Optional

from ..testing import fault_plans as _plans

_HOOK: Optional[Callable[[str, Optional[str]], None]] = None
_STATE_HOOK: Optional[Callable[[str, Any], Any]] = None


def fault_point(site: str, path: Optional[str] = None) -> None:
    """Run the active plans, then the installed hook, at ``(site, path)``."""
    _plans.fault_point(site, path)
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
    """``state`` after the active plans' state faults and the installed
    state hook; ``state`` itself without either."""
    state = _plans.apply_state_faults(site, state)
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
