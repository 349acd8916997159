"""In-flight event <-> ring-buffer conversion (the paper's ``.event.k`` files).

A copy of ``repro.core.events`` kept in the port (numpy only), which imports
nothing of the JAX package; both give identical arrays.

The clock-driven TPU simulator keeps, per partition, a ring buffer
``ring[(t + d) % D, local_target]`` of future synaptic currents plus a ring of
its own recent spikes (``hist``).  The paper serializes "simulation events
'in-flight' that have not yet been processed on the target vertex due to
connection delays" as tuples ``(source, arrival_time, event_type, data)``.

We derive those tuples exactly: an in-flight event is a (spike, edge) pair
with ``t_spike <= t_now < t_spike + delay``; its ``data`` carries the global
target id and the synaptic weight so that restore can rebuild the ring buffer
without replaying remote history.  ``ring_from_events`` is the inverse of
``inflight_events`` (asserted bit-exact in tests).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .dcsr import DCSRPartition
from .state import EDGE_WEIGHT, EDGE_DELAY

Array = np.ndarray

EVENT_DTYPE = np.dtype(
    [
        ("src", np.int64),
        ("t_arr", np.int64),
        ("kind", "U8"),
        ("tgt", np.int64),
        ("weight", np.float32),
    ]
)


def inflight_events(
    part: DCSRPartition,
    hist_global: Array,  # (D, n) uint8/bool: hist[t % D] = spikes at time t
    t_now: int,
    d_max: int,
) -> Array:
    """All in-flight arrivals destined to this partition, as EVENT_DTYPE.

    ``hist_global[t % D]`` must hold the global spike vector for every
    ``t in (t_now - d_max, t_now]``.
    """
    if part.m == 0:
        return np.zeros(0, dtype=EVENT_DTYPE)
    D = hist_global.shape[0]
    assert D >= d_max, "history ring shorter than max delay"
    src = part.col_idx
    tgt = part.edge_targets()
    delay = np.maximum(part.edge_state[:, EDGE_DELAY].astype(np.int64), 1)
    weight = part.edge_state[:, EDGE_WEIGHT]

    out = []
    # A spike at t_s = t_now - a (a in [0, d_max)) with edge delay d is
    # in-flight iff d > a; it arrives at t_s + d.
    for a in range(min(d_max, D)):
        t_s = t_now - a
        if t_s < 0:
            break
        spiked = hist_global[t_s % D].astype(bool)
        sel = np.flatnonzero(spiked[src] & (delay > a))
        if len(sel) == 0:
            continue
        ev = np.zeros(len(sel), dtype=EVENT_DTYPE)
        ev["src"] = src[sel]
        ev["t_arr"] = t_s + delay[sel]
        ev["kind"] = "spike"
        ev["tgt"] = tgt[sel]
        ev["weight"] = weight[sel]
        out.append(ev)
    if not out:
        return np.zeros(0, dtype=EVENT_DTYPE)
    ev = np.concatenate(out)
    return ev[np.lexsort((ev["src"], ev["tgt"], ev["t_arr"]))]


def ring_from_events(
    events: Array,
    row_start: int,
    n_p: int,
    d_ring: int,
    t_now: int,
) -> Array:
    """Rebuild the future-current ring buffer from serialized events.

    Slot convention matches the simulator: current arriving at time t_a is
    delivered when the simulator *starts* step t_a, from slot ``t_a % d_ring``.
    """
    ring = np.zeros((d_ring, n_p), dtype=np.float32)
    for e in events:
        assert e["t_arr"] > t_now, "event already delivered"
        assert e["t_arr"] - t_now <= d_ring, "event beyond ring horizon"
        ring[e["t_arr"] % d_ring, e["tgt"] - row_start] += e["weight"]
    return ring


@dataclasses.dataclass
class RingSpec:
    """Static ring geometry shared by simulator and serialization."""

    d_ring: int  # >= max_delay
    n_p: int

    @staticmethod
    def for_partition(part: DCSRPartition, max_delay: int) -> "RingSpec":
        return RingSpec(d_ring=max(int(max_delay), 1), n_p=part.n)


def pack_history(hist_local: Array, t_now: int, d_max: int) -> Array:
    """Local spike history rows for t in (t_now - d_max, t_now], oldest
    first — the per-partition contribution to the global history ring."""
    D = hist_local.shape[0]
    ts = [t_now - a for a in range(min(d_max, t_now + 1))][::-1]
    return np.stack([hist_local[t % D] for t in ts]) if ts else np.zeros(
        (0, hist_local.shape[1]), dtype=hist_local.dtype
    )
