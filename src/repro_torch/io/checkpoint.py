"""Atomic snapshot directories and the step-directory scan (the part of the
reference's ``repro/io/checkpoint.py`` that the dCSR snapshots use:
``atomic_dir`` and ``step_candidates``; its tensor ``CheckpointManager``
belongs to the LM substrate and is not ported)."""
from __future__ import annotations

import contextlib
import os
import re
import shutil
from typing import Iterator, List, Tuple

from .durability import fsync_dir
from .hooks import fault_point


@contextlib.contextmanager
def atomic_dir(final: str) -> Iterator[str]:
    """Write a directory atomically: yields a ``<final>.tmp`` staging dir,
    then swaps it into place via rename — a crash mid-write never leaves a
    partially-written ``final``, and at every instant a complete snapshot
    exists on disk (the previous one is renamed aside to ``<final>.old``
    before the swap, never deleted first; stale ``.tmp``/``.old`` dirs from
    an earlier crash are cleared on the next write).

    A crash *between* the two renames of the swap leaves only
    ``<final>.old`` holding the complete previous snapshot.  The next
    write through here finishes the interrupted swap (``.old`` → final)
    before clearing stale dirs, and the restore walker
    (``load_latest_valid``) falls back to ``.old`` itself — so the
    docstring's guarantee holds at restore time too, not just on the
    writer's happy path.  Used by the dCSR snapshot writer (io/dcsr_binary,
    snn/session)."""
    tmp = final + ".tmp"
    old = final + ".old"
    if os.path.exists(old) and not os.path.exists(final):
        # a crash between the two swap renames left .old as the only
        # complete snapshot: finish that swap instead of deleting it
        os.replace(old, final)
    for stale in (tmp, old):
        if os.path.exists(stale):
            shutil.rmtree(stale)
    os.makedirs(tmp)
    yield tmp
    parent = os.path.dirname(os.path.abspath(final)) or "."
    fsync_dir(tmp)  # staged entries durable before any rename
    fault_point("atomic_dir:pre_swap", final)
    if os.path.exists(final):
        os.replace(final, old)  # atomic aside, not rmtree: crash-safe
        fault_point("atomic_dir:between_renames", final)
        os.replace(tmp, final)
        fault_point("atomic_dir:after_swap", final)
        # make both renames durable before the only other complete copy
        # (.old) disappears — a power cut here must not lose the swap
        fsync_dir(parent)
        shutil.rmtree(old)
    else:
        os.replace(tmp, final)
        fault_point("atomic_dir:after_swap", final)
        fsync_dir(parent)


def step_candidates(root: str) -> List[Tuple[int, bool, str]]:
    """``(step, is_old, dir)`` for every ``step_XXXXXXXX[.old]`` dir under
    ``root`` holding a manifest — the directory scan of the dCSR-snapshot
    restore walker (``.old`` entries are torn-swap survivors, see
    :func:`atomic_dir`)."""
    out: List[Tuple[int, bool, str]] = []
    if not os.path.isdir(root):
        return out
    for fn in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)(\.old)?", fn)
        if m and os.path.exists(os.path.join(root, fn, "manifest.json")):
            out.append(
                (int(m.group(1)), bool(m.group(2)), os.path.join(root, fn))
            )
    return out
