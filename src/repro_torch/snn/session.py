"""``Session``: the port's entry point for build -> simulate.

Counterpart of ``repro/snn/session.py``.  ``Session(net, cfg)`` picks the
engine, runs the simulation in chunks so recordings stream to host-side
monitors (the device holds one ``(chunk, n)`` raster block at a time, copied
to the host once per chunk), and reports what it chose.

Engine selection (``engine="auto"``), as in the reference
(``session.py:372-394``):

  * ``k == 1``                          -> single-partition engine;
  * ``k > 1``, uniform partitions and   -> ``spmd``: ``DistSimulator``, each
    at least k cards (or ``devices=``)     partition on a card of its own;
  * otherwise                           -> single engine over
    ``merge_to_single(net)`` (same global labelling, same trajectory).

``engine="spmd", devices=[...]`` places the k partitions on the given
devices, which may repeat: ``devices=["cuda:0"] * k`` runs k partitions on
one card, ``["cpu"] * k`` on the CPU with the plain versions.  The spmd
engine's spike counts and overflow are summed over partitions, its raster
has the merged labelling ``(steps, k * n_p)`` and ``v_mean`` is the mean of
the partitions' means.  A lossy index exchange (``RunResult.overflow``
nonzero) always comes with a ``UserWarning``.

The run goes on the card unless the caller passes ``device="cpu"`` (or CPU
``devices``).

With ``SimConfig(gather="auto")``, the default, on a partition the event
engine can serve, each chunk's mean spike rate feeds a running average;
below ``EVENT_ACTIVITY_THRESHOLD`` the next chunk runs the event-driven
gather, above it the dense one (``session.py:547-594`` of the reference).
The engines give identical rasters, so the switch changes no trajectory;
``last_gather_modes`` records what each chunk of the last run took.

Plastic nets (``syn_stdp`` edges) run ``fused_plastic`` (k = 1) or
``fused_split_plastic`` (spmd) on the card and ``unfused`` with
``SimConfig(fused=False)``; all update the weights and e-traces in the
carry.  They never take the event gather, so every chunk of a plastic run
with ``gather="auto"`` reports ``"dense"``.

``Session(spec, cfg, k=...)`` builds from a procedural ``RuleSpec``
(``builder.build_network``, ``uniform`` when k > 1): each partition's dCSR
rows are emitted directly, with the keystream on the session's device
(``devices[0]`` for spmd) unless ``build_path="ref"`` asks for the numpy
oracle; ``k`` applies only to a ``RuleSpec``, as in the reference.

Not in this slice, each raising ``NotImplementedError`` that names the
ROADMAP queue item porting it: snapshot paths as input and the
save/restore pair, ``run(checkpoint_every=...)`` and ``run_supervised``.
"""
from __future__ import annotations

import collections.abc
import dataclasses
import os
import warnings
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..builder.procedural import DEFAULT_CHUNK_ROWS, build_network
from ..builder.rules import RuleSpec
from ..core.dcsr import DCSRNetwork, merge_to_single
from ..kernels.dispatch import EVENT_ACTIVITY_THRESHOLD, resolve_device
from .dist_sim import DistSimulator
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
    overflow: np.ndarray = None  # (steps,) int32, summed over partitions

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
        devices: Optional[Sequence] = None,
        k: Optional[int] = None,
        build_chunk_rows: Optional[int] = None,
        build_path: str = "auto",
        _noise_fn=None,
        _share: Optional["Session"] = None,
    ):
        if isinstance(net_or_path, RuleSpec):
            # procedural one-call build: each partition's dCSR rows are
            # emitted directly (chunked, counter-based seeding), with the
            # keystream on the device the session runs on
            kk = 1 if k is None else int(k)
            net = build_network(
                net_or_path, k=kk, uniform=kk > 1,
                chunk_rows=build_chunk_rows or DEFAULT_CHUNK_ROWS,
                path=build_path, device=devices[0] if devices else device,
            )
        elif k is not None:
            raise ValueError(
                "Session(k=...) only applies when building from a RuleSpec; "
                "use Session.restore(path, k=...) for snapshots"
            )
        elif isinstance(net_or_path, (str, os.PathLike)):
            raise _unported("Session(snapshot path)", "snapshots in the reference format")
        elif isinstance(net_or_path, DCSRNetwork):
            net = net_or_path
        else:
            raise TypeError(
                "Session expects a DCSRNetwork, a RuleSpec or a snapshot "
                f"path, got {type(net_or_path).__name__}"
            )
        self.cfg = cfg if cfg is not None else SimConfig()
        self.source_k = net.k
        self.engine_kind = self._select_engine_kind(net, engine, device, devices)
        if self.engine_kind == "spmd":
            # built once, eagerly: surfaces SimConfig/device errors here
            # _share: a spmd Session of the same net lends its panels
            self._sim = DistSimulator(
                net, self.cfg, devices=devices, _noise_fn=_noise_fn,
                _share=None if _share is None else _share.simulator,
            )
            self.net = net
            self.device = self._sim.devices[0]
        else:
            self.device = resolve_device(device)
            self.net = merge_to_single(net) if net.k > 1 else net
            self._sim = Simulator(self.net, self.cfg, device=self.device, _noise_fn=_noise_fn)
        self._state = None
        # chunk lengths and gather mode of each chunk the last run() executed
        self.last_run_chunks: Tuple[int, ...] = ()
        self.last_gather_modes: Tuple[str, ...] = ()

    # -- engine selection --------------------------------------------------
    @staticmethod
    def _select_engine_kind(net: DCSRNetwork, engine: str, device, devices) -> str:
        if engine not in ("auto", "single", "spmd"):
            raise ValueError(
                f"engine={engine!r}: expected 'auto', 'single' or 'spmd'"
            )
        uniform = len({p.n for p in net.parts}) == 1
        if devices is not None:
            enough = len(devices) == net.k
        elif device is None or torch.device(device).type == "cuda":
            enough = torch.cuda.is_available() and torch.cuda.device_count() >= net.k
        else:
            enough = False  # one CPU device for k partitions: merge
        if engine == "spmd":
            if net.k == 1:
                raise ValueError("engine='spmd' needs a k>1 network")
            if not uniform:
                raise ValueError(
                    "engine='spmd' needs uniform partitions; build with "
                    "to_dcsr(..., uniform=True)"
                )
            if not enough:
                raise ValueError(
                    f"engine='spmd' needs {net.k} devices: devices=[...] with one "
                    f"entry per partition, or {net.k} CUDA cards"
                )
            return "spmd"
        if devices is not None and engine == "single":
            raise ValueError("devices=[...] places partitions; the single engine takes device=")
        if engine == "single" or net.k == 1:
            return "single"
        return "spmd" if (uniform and enough) else "single"

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
        if self._state is None:
            return 0
        return int((self._state[0] if self.engine_kind == "spmd" else self._state)["t"])

    @property
    def state(self):
        """The device-side carry, made on first access: a dict at k = 1, the
        list of per-partition carries on the spmd engine."""
        self._ensure_state()
        return self._state

    @property
    def engine_choice(self):
        """Step-engine decision of the kernel layer for the next chunk."""
        return self._sim.engine_choice

    @property
    def simulator(self):
        """The engine behind this session: the k = 1 :class:`Simulator`
        (its ELL and device panels) or the spmd :class:`DistSimulator`."""
        return self._sim

    @property
    def permanent_ids(self) -> np.ndarray:
        """Permanent (pre-partitioning) neuron id per current global row."""
        return np.concatenate([p.global_ids for p in self.net.parts])

    def describe(self) -> Dict:
        sim = self.simulator
        d = dict(
            n=self.n, m=self.m, k=self.k, source_k=self.source_k,
            engine=self.engine_kind, t=self.t,
            step_engine=self.engine_choice.engine,
            gather=sim.gather,
            overlap=self.engine_choice.overlap,
            backend=sim.backend,
            device=str(self.device),
        )
        # the gathers' reduction per bucket, chosen from the weights at upload
        # ("active": real slots and active sources' weights only; "row_dot":
        # every slot, where a weight is not finite or the net is plastic)
        if self.engine_kind == "spmd":
            d["exchange"] = sim.exchange
            d["devices"] = [str(x) for x in sim.devices]
            d["reduce"] = [dev.reduce for dev in sim.devs]
            if sim.devs[0].cols_local is not None:
                d["reduce_local"] = [dev.reduce_local for dev in sim.devs]
                d["reduce_remote"] = [dev.reduce_remote for dev in sim.devs]
        else:
            d["ell_fill"] = sim.ell.fill_factor
            d["reduce"] = sim.dev.reduce
        return d

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
            if self.engine_kind == "spmd":  # (c, k, ...) -> merged labelling
                outs["spike_count"] = outs["spike_count"].sum(axis=1).astype(np.int32)
                outs["overflow"] = outs["overflow"].sum(axis=1).astype(np.int32)
                if "raster" in outs:
                    outs["raster"] = outs["raster"].reshape(c, -1)
                if "v_mean" in outs:
                    outs["v_mean"] = outs["v_mean"].mean(axis=1).astype(np.float32)
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
        self.last_run_chunks = tuple(chunks)
        self.last_gather_modes = tuple(gather_modes)
        overflow = np.concatenate(overflows)
        dropped = int(overflow.sum())
        if dropped:
            warnings.warn(
                f"compressed index exchange dropped {dropped} spikes over {done} "
                f"steps (effective cap: {getattr(self._sim, 'index_cap', None)} "
                "spike ids per partition per step); raise "
                "SimConfig(index_cap_frac=...) or use exchange='dense' for a "
                "lossless run",
                UserWarning,
                stacklevel=2,
            )
        return RunResult(
            spike_count=np.concatenate(counts),
            t_final=t_run0 + done,
            chunks=tuple(chunks),
            overflow=overflow,
        )

    # -- not ported yet (ROADMAP queue) ------------------------------------
    save = _raises("Session.save", "snapshots in the reference format")
    restore = classmethod(
        _raises("Session.restore", "snapshots in the reference format")
    )
    run_supervised = _raises("Session.run_supervised", "fault tolerance")
