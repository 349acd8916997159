"""``Session``: the port's entry point for build -> simulate, at k = 1.

Counterpart of ``repro/snn/session.py``.  ``Session(net, cfg)`` picks the
engine, runs the simulation in chunks so recordings stream to host-side
monitors (the device holds one ``(chunk, n)`` raster block at a time, copied
to the host once per chunk), and reports what it chose.

Engine selection (``engine="auto"``), as in the reference:

  * ``k == 1``                        -> single-partition engine;
  * ``k > 1``, uniform partitions and -> one partition per card (not
    at least k cards                     ported yet: raises);
  * otherwise                         -> single engine over
    ``merge_to_single(net)`` (same global labelling, same trajectory).

The run goes on the card unless the caller passes ``device="cpu"``.

With ``SimConfig(gather="auto")``, the default, on a partition the event
engine can serve, each chunk's mean spike rate feeds a running average;
below ``EVENT_ACTIVITY_THRESHOLD`` the next chunk runs the event-driven
gather, above it the dense one (``session.py:547-594`` of the reference).
The engines give identical rasters, so the switch changes no trajectory;
``last_gather_modes`` records what each chunk of the last run took.

Plastic nets (``syn_stdp`` edges) run ``fused_plastic`` on the card and
``unfused`` with ``SimConfig(fused=False)``; both update the weights and
e-traces in the carry.  They never take the event gather, so every chunk
of a plastic run with ``gather="auto"`` reports ``"dense"``.

Not in this slice, each raising ``NotImplementedError`` that names the
ROADMAP queue item porting it: snapshot paths as input and the
save/restore pair, ``run(checkpoint_every=...)``, ``run_supervised``, and
``RuleSpec`` input.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..core.dcsr import DCSRNetwork, merge_to_single
from ..kernels.dispatch import EVENT_ACTIVITY_THRESHOLD, resolve_device
from .simulator import SimConfig, Simulator, _not_ported as _unported

_DEFAULT_CHUNK = 128


def _raises(what: str, queue_item: str):
    def stub(*args, **kwargs):
        raise _unported(what, queue_item)

    stub.__doc__ = f"Not ported yet: raises NotImplementedError ({queue_item})."
    return stub


@dataclasses.dataclass(frozen=True, eq=False)
class RunResult(collections.abc.Mapping):
    """Host-side result of ``Session.run``; mapping access exposes
    ``result["spike_count"]`` and ``result["overflow"]``."""

    spike_count: np.ndarray  # (steps,) int32
    t_final: int
    chunks: Tuple[int, ...]  # chunk lengths actually executed
    overflow: np.ndarray = None  # (steps,) int32; zeros at k=1

    def __getitem__(self, key):
        if key == "spike_count":
            return self.spike_count
        if key == "overflow":
            return self.overflow
        raise KeyError(key)

    def __iter__(self):
        return iter(("spike_count", "overflow"))

    def __len__(self):
        return 2


class Session:
    """One object for build -> simulate; see the module docstring."""

    def __init__(
        self,
        net_or_path,
        cfg: Optional[SimConfig] = None,
        *,
        engine: str = "auto",
        device=None,
        _noise_fn=None,
    ):
        if isinstance(net_or_path, (str, os.PathLike)):
            raise _unported("Session(snapshot path)", "snapshots in the reference format")
        if type(net_or_path).__name__ == "RuleSpec":
            raise _unported(
                "Session(RuleSpec)", "procedural construction and streaming ingest"
            )
        if not isinstance(net_or_path, DCSRNetwork):
            raise TypeError(
                f"Session expects a DCSRNetwork, got {type(net_or_path).__name__}"
            )
        net = net_or_path
        self.cfg = cfg if cfg is not None else SimConfig()
        self.device = resolve_device(device)
        self.source_k = net.k
        self.engine_kind = self._select_engine_kind(net, engine, self.device)
        self.net = merge_to_single(net) if net.k > 1 else net
        # built once, eagerly: surfaces SimConfig/device errors here, and
        # the recordings are per run, so the panels are uploaded only once
        self._sim = Simulator(self.net, self.cfg, device=self.device, _noise_fn=_noise_fn)
        self._state: Optional[Dict] = None
        # gather mode each chunk of the last run() actually executed with
        self.last_gather_modes: Tuple[str, ...] = ()

    # -- engine selection --------------------------------------------------
    @staticmethod
    def _select_engine_kind(net: DCSRNetwork, engine: str, device) -> str:
        if engine not in ("auto", "single", "spmd"):
            raise ValueError(
                f"engine={engine!r}: expected 'auto', 'single' or 'spmd'"
            )
        cards = torch.cuda.device_count() if device.type == "cuda" else 1
        uniform = len({p.n for p in net.parts}) == 1
        if engine == "spmd" or (
            engine == "auto" and net.k > 1 and uniform and cards >= net.k
        ):
            raise _unported(
                f"the one-partition-per-card engine (k={net.k} on {cards} cards)",
                "k>1 engine",
            )
        return "single"

    def _ensure_state(self) -> None:
        if self._state is None:
            self._state = self._sim.init_state()

    # -- introspection -----------------------------------------------------
    @property
    def n(self) -> int:
        return self.net.n

    @property
    def m(self) -> int:
        return self.net.m

    @property
    def k(self) -> int:
        """Partitions actually simulated (1 for the merged fallback)."""
        return self.net.k

    @property
    def dt(self) -> float:
        return self._sim.dt

    @property
    def d_ring(self) -> int:
        return self._sim.d_ring

    @property
    def t(self) -> int:
        """Next step index (steps completed since t=0)."""
        return int(self._state["t"]) if self._state is not None else 0

    @property
    def state(self) -> Dict:
        """The device-side carry, made on first access."""
        self._ensure_state()
        return self._state

    @property
    def engine_choice(self):
        """Step-engine decision of the kernel layer for the next chunk."""
        return self._sim.engine_choice

    @property
    def simulator(self) -> Simulator:
        """The k=1 engine behind this session: its ELL and device panels."""
        return self._sim

    @property
    def permanent_ids(self) -> np.ndarray:
        """Permanent (pre-partitioning) neuron id per current global row."""
        return np.concatenate([p.global_ids for p in self.net.parts])

    def describe(self) -> Dict:
        sim = self.simulator
        return dict(
            n=self.n, m=self.m, k=self.k, source_k=self.source_k,
            engine=self.engine_kind, t=self.t,
            step_engine=self.engine_choice.engine,
            gather=sim.gather,
            overlap=self.engine_choice.overlap,
            backend=sim.backend,
            device=str(self.device),
            ell_fill=sim.ell.fill_factor,
        )

    # -- simulate ----------------------------------------------------------
    def run(
        self,
        steps: int,
        monitors: Iterable = (),
        *,
        chunk_size: Optional[int] = None,
        checkpoint_every: Optional[int] = None,
    ) -> RunResult:
        """Advance ``steps`` steps in chunks of ``chunk_size`` (default
        128); the trajectory is identical for any chunk size.  ``monitors``
        are streaming accumulators (see :mod:`.monitors`); the recordings
        they need are turned on from their ``requires`` sets."""
        if steps <= 0:
            raise ValueError(f"steps must be positive, got {steps}")
        if checkpoint_every is not None:
            raise _unported(
                "Session.run(checkpoint_every=...)",
                "snapshots in the reference format",
            )
        monitors = tuple(monitors)
        need = set()
        for mon in monitors:
            need |= set(getattr(mon, "requires", ()))
        record_raster = self.cfg.record_raster or "raster" in need
        record_v = self.cfg.record_v or "v_mean" in need
        self._ensure_state()
        adaptive = self.cfg.gather == "auto" and self._sim.event_capable
        rate_ema: Optional[float] = None
        chunk_size = max(1, int(chunk_size or min(steps, _DEFAULT_CHUNK)))
        t_run0 = self.t
        for mon in monitors:
            mon.begin(self)
        counts, overflows, chunks, gather_modes = [], [], [], []
        done = 0
        while done < steps:
            c = min(chunk_size, steps - done)
            self._state, dev_outs = self._sim.run(
                self._state, c, record_raster=record_raster, record_v=record_v
            )
            # one copy to the host per chunk and output
            outs = {k: v.cpu().numpy() for k, v in dev_outs.items()}
            for mon in monitors:
                mon.on_chunk(t_run0 + done, outs)
            counts.append(outs["spike_count"])
            overflows.append(outs["overflow"])
            chunks.append(c)
            gather_modes.append(self._sim.gather)
            done += c
            if adaptive:
                rate = float(np.mean(outs["spike_count"])) / max(self.n, 1)
                rate_ema = rate if rate_ema is None else 0.5 * rate_ema + 0.5 * rate
                self._sim.set_gather(
                    "event" if rate_ema < EVENT_ACTIVITY_THRESHOLD else "dense"
                )
        for mon in monitors:
            mon.finalize()
        self.last_gather_modes = tuple(gather_modes)
        return RunResult(
            spike_count=np.concatenate(counts),
            t_final=t_run0 + done,
            chunks=tuple(chunks),
            overflow=np.concatenate(overflows),
        )

    # -- not ported yet (ROADMAP queue) ------------------------------------
    save = _raises("Session.save", "snapshots in the reference format")
    restore = classmethod(
        _raises("Session.restore", "snapshots in the reference format")
    )
    run_supervised = _raises("Session.run_supervised", "fault tolerance")
