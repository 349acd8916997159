"""Streaming host-side monitors for ``Session.run``.

A copy of ``repro/snn/monitors.py`` (numpy only) for the port's ``Session``.

Monitors are accumulators, not post-hoc array functions: ``Session.run``
executes the scan in chunks and hands each monitor one host-side chunk of
outputs at a time, so recording never materializes a ``(steps, n)`` buffer
on device — the device only ever holds ``(chunk, n)``.

Chunk outputs follow the **unified engine contract** (identical for the
single-partition and SPMD engines):

  * ``spike_count`` — ``(chunk,)`` int32, total spikes per step over all
    partitions;
  * ``raster``      — ``(chunk, n)`` uint8 in the network's global
    (partition-contiguous) labelling, present iff requested;
  * ``v_mean``      — ``(chunk,)`` float32 mean membrane potential,
    present iff requested.

A monitor declares what it needs via ``requires`` (subset of
``{"raster", "v_mean"}``); the session enables the matching recordings on
the engine automatically.  Lifecycle: ``begin(session)`` once, then
``on_chunk(t0, outs)`` per chunk (``t0`` = global step index of the chunk's
first step), then ``finalize()``.

The module-level functions (:func:`firing_rates`, :func:`per_neuron_rates`,
:func:`summary`) remain for quick post-hoc analysis of accumulated outputs.
"""
from __future__ import annotations

from typing import Dict, List, Mapping

import numpy as np


class Monitor:
    """Base streaming monitor; subclass and override ``on_chunk``."""

    requires: frozenset = frozenset()

    def begin(self, session) -> None:
        """Called once at the start of ``Session.run``; grabs the static
        facts monitors usually need."""
        self.n = session.n
        self.dt = session.dt
        self.t_begin = session.t
        self.chunks_seen = 0

    def on_chunk(self, t0: int, outs: Mapping[str, np.ndarray]) -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        """Called once after the last chunk; default no-op."""


class SpikeCountMonitor(Monitor):
    """Total spikes per step (host int32, O(steps) memory)."""

    def __init__(self):
        self._chunks: List[np.ndarray] = []

    def on_chunk(self, t0, outs):
        self.chunks_seen += 1
        self._chunks.append(outs["spike_count"])

    @property
    def counts(self) -> np.ndarray:
        return (
            np.concatenate(self._chunks)
            if self._chunks
            else np.zeros(0, np.int32)
        )


class RateMonitor(SpikeCountMonitor):
    """Population firing rate per step (Hz)."""

    @property
    def rates(self) -> np.ndarray:
        return self.counts / (self.n * self.dt * 1e-3)


class RasterMonitor(Monitor):
    """Full spike raster, accumulated on host as ``(steps, n)`` uint8.

    The device never holds more than one ``(chunk, n)`` block; the host
    array is the only steps-proportional allocation.
    """

    requires = frozenset({"raster"})

    def __init__(self):
        self._chunks: List[np.ndarray] = []

    def on_chunk(self, t0, outs):
        self.chunks_seen += 1
        self._chunks.append(outs["raster"])

    @property
    def raster(self) -> np.ndarray:
        return (
            np.concatenate(self._chunks)
            if self._chunks
            else np.zeros((0, 0), np.uint8)
        )


class PerNeuronRateMonitor(Monitor):
    """Per-neuron firing rate (Hz) with O(n) memory: accumulates spike
    totals chunk by chunk instead of keeping the raster."""

    requires = frozenset({"raster"})

    def __init__(self):
        self._totals = None
        self._steps = 0

    def on_chunk(self, t0, outs):
        self.chunks_seen += 1
        r = outs["raster"]
        s = r.sum(axis=0, dtype=np.int64)
        self._totals = s if self._totals is None else self._totals + s
        self._steps += r.shape[0]

    @property
    def rates(self) -> np.ndarray:
        if self._totals is None:
            return np.zeros(0, np.float64)
        return self._totals / (self._steps * self.dt * 1e-3)


class VMeanMonitor(Monitor):
    """Mean membrane potential per step."""

    requires = frozenset({"v_mean"})

    def __init__(self):
        self._chunks: List[np.ndarray] = []

    def on_chunk(self, t0, outs):
        self.chunks_seen += 1
        self._chunks.append(outs["v_mean"])

    @property
    def v_mean(self) -> np.ndarray:
        return (
            np.concatenate(self._chunks)
            if self._chunks
            else np.zeros(0, np.float32)
        )


# -- post-hoc helpers -------------------------------------------------------


def firing_rates(outs: Mapping, n: int, dt_ms: float) -> np.ndarray:
    """Mean rate (Hz) per step from unified-contract spike counts
    (``(steps,)`` totals; engines sum over partitions)."""
    counts = np.asarray(outs["spike_count"])
    if counts.ndim != 1:
        # loud failure beats silently under-reporting by a factor of k
        raise ValueError(
            f"spike_count must be (steps,) totals (the unified engine "
            f"contract), got shape {counts.shape}; legacy DistSimulator "
            "outputs are per-partition — run through repro.snn.Session"
        )
    return counts / (n * dt_ms * 1e-3)


def per_neuron_rates(raster: np.ndarray, dt_ms: float) -> np.ndarray:
    """raster (steps, n) 0/1 -> per-neuron rate in Hz."""
    steps = raster.shape[0]
    return raster.sum(axis=0) / (steps * dt_ms * 1e-3)


def permanent_order(raster: np.ndarray, global_ids: np.ndarray) -> np.ndarray:
    """Re-order raster columns from a network's current (partition-
    contiguous) labelling into permanent neuron ids, so trajectories from
    differently-partitioned runs compare bit-for-bit."""
    out = np.zeros_like(raster)
    out[:, np.asarray(global_ids)] = raster
    return out


def summary(outs: Mapping, n: int, dt_ms: float) -> Dict[str, float]:
    r = firing_rates(outs, n, dt_ms)
    return dict(
        mean_rate_hz=float(r.mean()),
        max_step_rate_hz=float(r.max()),
        silent=bool(r.sum() == 0),
        saturated=bool((r > 0.5 / (dt_ms * 1e-3)).any()),
    )
