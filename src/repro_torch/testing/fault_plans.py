"""Seeded, deterministic fault injection for the port's checkpoint and
restore stack and its supervised run: the counterpart of the reference's
``repro/testing/faults.py``, with the same plans, hit windows and seeded
damage, and state faults written into the port's carries.

A :class:`FaultPlan` names *which* failure fires *where*: each
:class:`Fault` binds a failure ``kind`` to a named ``site`` (a hook point in
the port's io code, reached through ``repro_torch.io.hooks``; see the table
below), an optional path substring ``match``, and hit-window counters
(``after`` / ``count``).  Every stochastic choice a fault makes (truncation
offset, flipped bit, NaN position) is drawn from a counter-based generator
keyed on ``(plan seed, fault index, hit index)``: the same plan against the
same workload injects byte-identical damage, and the same damage as the
reference's plan of the same seed.

Sites wired into the port:

====================================  =======================================
site                                  where it fires
====================================  =======================================
``shard_write``                       before each ``part<p>.npz`` /
                                      ``leaf<i>_s<j>.npy`` byte write
                                      (io/dcsr_binary, io/checkpoint)
``shard_write:post``                  after the bytes landed, before the
                                      read-back CRC verify (torn writes)
``manifest_write`` / ``:post``        around each ``manifest.json`` write
``shard_read``                        before a shard is opened on restore
                                      (bit rot)
``atomic_dir:pre_swap``               staging complete, before any rename
``atomic_dir:between_renames``        previous snapshot renamed aside,
                                      new one not yet renamed in
``atomic_dir:after_swap``             both renames done, before the parent
                                      directory fsync + ``.old`` cleanup
``supervisor:state``                  after each supervised chunk, before
                                      the health check (state corruption)
``text_write`` / ``:post``            around each textual artifact write
                                      (io/dcsr_text)
====================================  =======================================

:data:`KNOWN_SITES` is the registry of these sites; ``tests/
test_torch_fault_plans.py`` holds every literal site of the port's code to
it, and it to the reference's.

Failure kinds: ``io_error`` (transient ``OSError``), ``torn`` (truncate
the just-written file at a seeded offset), ``stall`` (sleep
``delay_s``), ``bit_flip`` (flip one seeded bit of the file on disk),
``crash`` (raise :class:`InjectedCrash`, a simulated hard stop at the
site), ``nan`` / ``storm`` (state kinds, applied by
:func:`apply_state_faults` to the membranes of the port's carry in place).

Plans nest: activating a plan pushes it on a global stack and every
active plan sees every hook.  Hit counting is thread-safe: the shard
writers run on a thread pool and the checkpoint queue on a background
worker.  When no plan is active every hook is one list check.
"""
from __future__ import annotations

import contextlib
import dataclasses
import errno
import os
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = [
    "CHAOS_PLANS",
    "Fault",
    "FaultPlan",
    "InjectedCrash",
    "InjectedIOError",
    "KINDS",
    "KNOWN_SITES",
    "STATE_KINDS",
    "active_plans",
    "apply_state_faults",
    "chaos_plan",
    "fault_point",
    "file_crc",
    "no_faults",
]

STATE_KINDS = ("nan", "storm")
FILE_KINDS = ("torn", "bit_flip")
KINDS = ("io_error", "stall", "crash") + FILE_KINDS + STATE_KINDS

# every fault site in the port's code (each site X also covers 'X:post')
KNOWN_SITES: Tuple[str, ...] = (
    "shard_write",
    "manifest_write",
    "shard_read",
    "text_write",
    "atomic_dir:pre_swap",
    "atomic_dir:between_renames",
    "atomic_dir:after_swap",
    "supervisor:state",
)

# the membrane column of every neuron model's state (LIF_V, ALIF_V)
_V = 0
_STORM_V = 1e4  # far above any threshold; exact in f32


class InjectedCrash(RuntimeError):
    """A simulated hard crash (process death) at a named site.  Tests
    catch it to freeze the filesystem exactly inside a crash window."""


class InjectedIOError(OSError):
    """A transient injected IO failure (``errno.EIO``): the retry layers
    treat it exactly like a real flaky-disk error."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One named failure: fires at ``site`` on matching hits.

    ``after`` skips the first that-many matching hits; ``count`` then
    fires on the next that-many (``-1`` = every one).  ``per_path``
    counts hits independently per file path: ``Fault("shard_write",
    "io_error", per_path=True)`` fails the first write of every shard
    once, which a single retry heals (the transient-IO chaos plan)."""

    site: str
    kind: str
    match: str = ""          # substring of the path ('' matches any)
    after: int = 0
    count: int = 1
    per_path: bool = False
    delay_s: float = 0.0     # stall duration
    frac: float = 0.5        # torn: keep ~frac of the file (seeded jitter)

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind == "stall" and self.delay_s <= 0:
            raise ValueError("stall faults need delay_s > 0")


class FaultPlan:
    """A seeded set of :class:`Fault` s plus its hit log.

    Use as a context manager (``with FaultPlan([...], seed=7):``) or via
    :meth:`activate` / :meth:`deactivate`.  ``plan.fired`` records every
    ``(site, path, kind)`` that actually fired, in order.
    ``plan.rng_for(fault_idx, hit)`` is the deterministic generator behind
    every stochastic choice."""

    # hook entry points run on shard-writer pools and checkpoint workers
    _guarded_by_ = {"_hits": "_lock", "fired": "_lock"}

    def __init__(self, faults, seed: int = 0, name: str = ""):
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self.seed = int(seed)
        self.name = name
        self.fired: List[Tuple[str, Optional[str], str]] = []
        self._hits: Dict[Tuple[int, Optional[str]], int] = {}
        self._lock = threading.Lock()

    def rng_for(self, fault_idx: int, hit: int) -> np.random.Generator:
        """Counter-based: keyed on (seed, fault, hit) only, independent
        of thread interleaving or call order across paths."""
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, fault_idx, hit])
        )

    def _firing(self, site: str, path: Optional[str]):
        """(fault_idx, fault, hit_idx) for each fault firing on this hit."""
        out = []
        with self._lock:
            for i, f in enumerate(self.faults):
                if f.site != site:
                    continue
                if f.match and (path is None or f.match not in path):
                    continue
                key = (i, path if f.per_path else None)
                hit = self._hits.get(key, 0)
                self._hits[key] = hit + 1
                if hit < f.after:
                    continue
                if f.count >= 0 and hit >= f.after + f.count:
                    continue
                out.append((i, f, hit - f.after))
                self.fired.append((site, path, f.kind))
        return out

    def reset(self) -> None:
        with self._lock:
            self._hits.clear()
            self.fired.clear()

    def activate(self) -> "FaultPlan":
        with _STACK_LOCK:
            _STACK.append(self)
        return self

    def deactivate(self) -> None:
        with _STACK_LOCK:
            try:
                _STACK.remove(self)
            except ValueError:
                pass

    def __enter__(self) -> "FaultPlan":
        return self.activate()

    def __exit__(self, *exc) -> bool:
        self.deactivate()
        return False


_STACK: List[FaultPlan] = []
_STACK_LOCK = threading.Lock()


def active_plans() -> Tuple[FaultPlan, ...]:
    with _STACK_LOCK:
        return tuple(_STACK)


# ---------------------------------------------------------------------------
# Hook entry points (reached through repro_torch.io.hooks)
# ---------------------------------------------------------------------------


def _truncate(path: str, rng: np.random.Generator, frac: float) -> None:
    size = os.path.getsize(path)
    if size <= 1:
        return
    # seeded offset near the kept fraction: sweeps hit different sections
    # (header / data / CRC tail) across hits
    keep = int(np.clip(rng.integers(1, size), 1, size - 1)) \
        if frac is None else int(np.clip(int(size * frac
                                             * rng.uniform(0.5, 1.5)),
                                         1, size - 1))
    with open(path, "r+b") as f:
        f.truncate(keep)


def _bit_flip(path: str, rng: np.random.Generator) -> None:
    size = os.path.getsize(path)
    if size == 0:
        return
    off = int(rng.integers(0, size))
    bit = int(rng.integers(0, 8))
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ (1 << bit)]))


def _non_state(site: str, fault: Fault) -> None:
    """A stall, crash or IO error at the state site, as at a file site."""
    if fault.kind == "stall":
        time.sleep(fault.delay_s)
    elif fault.kind == "crash":
        raise InjectedCrash(f"injected crash at {site}")
    elif fault.kind == "io_error":
        raise InjectedIOError(errno.EIO, f"injected IO error at {site}")


def fault_point(site: str, path: Optional[str] = None) -> None:
    """A no-op unless an active plan has a fault firing at ``site`` (and
    matching ``path``) on this hit."""
    if not _STACK:  # fast path: no plan active
        return
    for plan in active_plans():
        for idx, fault, hit in plan._firing(site, path):
            rng = plan.rng_for(idx, hit)
            if fault.kind == "io_error":
                raise InjectedIOError(
                    errno.EIO,
                    f"injected transient IO error at {site} (hit {hit})",
                    path,
                )
            if fault.kind == "stall":
                time.sleep(fault.delay_s)
            elif fault.kind == "crash":
                raise InjectedCrash(f"injected crash at {site}"
                                    + (f" ({path})" if path else ""))
            elif fault.kind == "torn":
                if path is not None and os.path.exists(path):
                    _truncate(path, rng, fault.frac)
            elif fault.kind == "bit_flip":
                if path is not None and os.path.exists(path):
                    _bit_flip(path, rng)
            # state kinds are applied by apply_state_faults, not here


def apply_state_faults(site: str, state):
    """Apply every firing ``nan`` / ``storm`` fault to the membranes of the
    port's carry, in place, and return ``state``.

    ``state`` is the k = 1 carry (a dict whose ``vtx_state`` is ``(n, S)``)
    or the spmd engine's list of per-partition carries (each ``(n_p, S)``).
    ``nan`` draws one flat position over all rows, partitions in order, as
    the reference draws it over its stacked ``(k, n_p, S)`` layout, and
    writes NaN into that row's column 0; ``storm`` writes 1e4 into column
    0 of every row.  The writes go into the carry's own tensors on their
    own device with Python-int indices (no host sync; a captured CUDA
    graph's inputs keep their addresses).  Non-state kinds at the site
    (``stall``, ``crash``, ``io_error``) run as in :func:`fault_point`."""
    if not _STACK:
        return state
    carries = state if isinstance(state, list) else [state]
    for plan in active_plans():
        for idx, fault, hit in plan._firing(site, None):
            if fault.kind not in STATE_KINDS:
                _non_state(site, fault)
                continue
            vtx = [c["vtx_state"] for c in carries]
            if fault.kind == "nan":
                flat_n = sum(v.shape[0] for v in vtx)
                pos = int(plan.rng_for(idx, hit).integers(0, max(flat_n, 1)))
                for v in vtx:
                    if pos < v.shape[0]:
                        v[pos, _V] = float("nan")
                        break
                    pos -= v.shape[0]
            else:  # storm: kick every membrane far above threshold
                for v in vtx:
                    v[:, _V] = _STORM_V
    return state


# ---------------------------------------------------------------------------
# Named chaos plans
# ---------------------------------------------------------------------------

CHAOS_PLANS = ("transient-io", "torn-write", "slow-disk")


def chaos_plan(name: str, seed: int = 0) -> FaultPlan:
    """A *survivable* plan: every fault it injects is healed by the io
    stack's own retry/verify layers, so a run under it writes the bytes a
    clean run writes."""
    if name == "transient-io":
        faults = [
            Fault("shard_write", "io_error", per_path=True),
            Fault("manifest_write", "io_error", per_path=True),
        ]
    elif name == "torn-write":
        faults = [
            Fault("shard_write:post", "torn", per_path=True),
            Fault("manifest_write:post", "torn", per_path=True),
        ]
    elif name == "slow-disk":
        faults = [
            Fault("shard_write", "stall", delay_s=0.002, count=-1),
            Fault("manifest_write", "stall", delay_s=0.002, count=-1),
        ]
    else:
        raise ValueError(
            f"unknown chaos plan {name!r}; expected one of {CHAOS_PLANS}"
        )
    return FaultPlan(faults, seed=seed, name=name)


@contextlib.contextmanager
def no_faults():
    """Temporarily mask every active plan (e.g. while writing a pristine
    reference snapshot inside a chaos run)."""
    with _STACK_LOCK:
        saved, _STACK[:] = _STACK[:], []
    try:
        yield
    finally:
        with _STACK_LOCK:
            _STACK[:] = saved + [p for p in _STACK if p not in saved]


def file_crc(path: str) -> int:
    """Stream-CRC a file (mirrors the snapshot CRC)."""
    c = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return c
            c = zlib.crc32(chunk, c)
