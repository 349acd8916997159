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

Snapshots (``session.save`` / ``Session.restore`` / ``Session(path)``),
as in the reference (``session.py:24-72``) and in its on-disk format 1.0
(``docs/FORMAT.md``), so either package restores the other's:

  * ``save`` captures the state between steps: it syncs the carry back
    into the dCSR partitions (vertex state, and weights through the ELL's
    edge index), copies them and the in-flight runtime (``ring``,
    ``hist``, ``tr_plus``, ``tr_minus``) to host buffers, and hands the
    copy to a background writer (``io.AsyncWriter``) that writes
    ``part<p>.npz`` shards from a thread pool and the manifest last,
    through an atomic directory swap.  ``wait=True`` (the default) returns
    once it is durable; the writer never touches a tensor.
  * ``Session.restore(path, k=..., assignment=...)`` is elastic: a
    snapshot taken at one k continues bit for bit at another, since the
    noise is a function of ``(seed, t, permanent id)`` on every device.
    ``path`` may be a root of ``step_XXXXXXXX`` snapshots, walked
    newest-first past corrupt ones.  The panels are uploaded from the
    restored net, so each gather's reduction is chosen from the restored
    weights; with ``gather="auto"`` the restored session starts dense.
  * ``run(checkpoint_every=..., checkpoint_dir=...)`` aligns its chunks to
    the checkpoint boundaries and saves without waiting; ``wait()``,
    ``close()`` or leaving a ``with`` block makes the writes durable, and a
    background write error is raised at the next boundary or there.

Not in this slice, each raising ``NotImplementedError`` that names the
ROADMAP queue item porting it: ``run_supervised`` and streaming restore
(``Session.restore(..., streaming=True)``).
"""
from __future__ import annotations

import collections.abc
import dataclasses
import os
import shutil
import threading
import time
import warnings
import weakref
from typing import Dict, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..builder.procedural import DEFAULT_CHUNK_ROWS, build_network
from ..builder.rules import RuleSpec
from ..core.dcsr import DCSRNetwork, merge_to_single
from ..core.partition import block_partition
from ..io.async_writer import AsyncWriter
from ..io.dcsr_binary import (
    load_latest_valid, snapshot_network, snapshot_steps, write_snapshot,
)
from ..kernels.dispatch import EVENT_ACTIVITY_THRESHOLD, resolve_device
from .dist_sim import DistSimulator
from .reshard import reshard_sim_state
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
    """One object for build -> simulate -> checkpoint -> restart; see the
    module docstring."""

    # advanced by the AsyncWriter worker, read on the run loop's thread
    _guarded_by_ = {"_last_good_ckpt_step": "_ckpt_mark_lock"}

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
        sim_state, t_now, load_s = None, 0, None
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
            t_load = time.perf_counter()
            net, sim_state, t_now = load_latest_valid(os.fspath(net_or_path))
            load_s = time.perf_counter() - t_load
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
        # a restored snapshot's step and runtime, applied when the carry is made
        self._t0 = int(t_now)
        self._pending_runtime = sim_state if sim_state else None
        # chunk lengths and gather mode of each chunk the last run() executed
        self.last_run_chunks: Tuple[int, ...] = ()
        self.last_gather_modes: Tuple[str, ...] = ()
        # run-loop stall (seconds) of each checkpoint of the last
        # run(checkpoint_every=...)
        self.last_ckpt_stalls: Tuple[float, ...] = ()
        # step of the newest snapshot whose background write landed: the
        # rollback point named when a later write fails
        self._last_good_ckpt_step: Optional[int] = None
        self._ckpt_mark_lock = threading.Lock()
        self._writer: Optional[AsyncWriter] = None
        # host seconds of a restore: reading the snapshot (``load``), the
        # elastic reshard and the engine build (``build``); None otherwise
        self.restore_seconds: Optional[Dict[str, float]] = None
        if load_s is not None:
            self.restore_seconds = dict(
                load=load_s, reshard=0.0, build=time.perf_counter() - t_load - load_s
            )

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
            st = self._sim.init_state(self._t0)
            if self._pending_runtime is not None:
                st = self._sim.load_runtime(st, self._pending_runtime)
                self._pending_runtime = None
            self._state = st

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
            return self._t0
        return int((self._state[0] if self.engine_kind == "spmd" else self._state)["t"])

    @property
    def state(self):
        """The device-side carry, made on first access (with a restored
        snapshot's runtime): a dict at k = 1, the list of per-partition
        carries on the spmd engine."""
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
        checkpoint_dir: Optional[str] = None,
        max_to_keep: Optional[int] = None,
        checkpoint_sync: bool = False,
    ) -> RunResult:
        """Advance ``steps`` steps in chunks of ``chunk_size`` (default
        128); the trajectory is identical for any chunk size.  ``monitors``
        are streaming accumulators (see :mod:`.monitors`); the recordings
        they need are turned on from their ``requires`` sets.

        ``checkpoint_every`` saves a snapshot to
        ``checkpoint_dir/step_XXXXXXXX`` every that many steps (chunks end
        on the boundaries) without waiting for the write, unless
        ``checkpoint_sync``; ``max_to_keep`` removes older step snapshots
        from the writer's queue, after the writes before it.  The stall of
        each checkpoint is in ``last_ckpt_stalls``."""
        if steps <= 0:
            raise ValueError(f"steps must be positive, got {steps}")
        if checkpoint_every is not None:
            if checkpoint_every <= 0:
                raise ValueError("checkpoint_every must be positive")
            if checkpoint_dir is None:
                raise ValueError("checkpoint_every requires checkpoint_dir")
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
        counts, overflows, chunks, gather_modes, stalls = [], [], [], [], []
        done = 0
        next_ckpt = checkpoint_every
        while done < steps:
            c = min(chunk_size, steps - done)
            if next_ckpt is not None:
                c = min(c, next_ckpt - done)
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
            if next_ckpt is not None and done == next_ckpt:
                stalls.append(self._checkpoint(
                    checkpoint_dir, t_run0 + done, max_to_keep, checkpoint_sync
                ))
                next_ckpt += checkpoint_every
        for mon in monitors:
            mon.finalize()
        self.last_run_chunks = tuple(chunks)
        self.last_gather_modes = tuple(gather_modes)
        if checkpoint_every is not None:
            self.last_ckpt_stalls = tuple(stalls)
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

    def _checkpoint(self, root: str, step: int, max_to_keep: Optional[int],
                    sync: bool) -> float:
        """One checkpoint of ``run``: save ``root/step_XXXXXXXX`` (and queue
        the retention behind it); returns the run loop's stall in seconds."""
        t_ck = time.perf_counter()
        try:
            self.save(os.path.join(root, f"step_{step:08d}"), wait=sync)
        except OSError as e:
            with self._ckpt_mark_lock:
                last = self._last_good_ckpt_step
            raise OSError(
                f"checkpoint at step {step} failed (writer retries exhausted); "
                "last successful checkpoint: "
                + (f"step {last}" if last is not None else "none from this session")
                + " — that is your rollback point"
            ) from e
        if max_to_keep:
            # retention rides the writes' FIFO queue, so it never runs ahead
            # of an older step still in flight
            if sync:
                self._gc_checkpoints(root, max_to_keep)
            else:
                self._writer_obj().submit(self._gc_checkpoints, root, max_to_keep)
        return time.perf_counter() - t_ck

    # -- checkpoint / restart ----------------------------------------------
    def _writer_obj(self) -> AsyncWriter:
        if self._writer is None:
            # a bounded queue is backpressure: when the disk falls behind,
            # save() blocks instead of piling up host copies of the state
            self._writer = AsyncWriter(name="dcsr-ckpt-writer", max_pending=4)
            # a Session dropped without close() stops its worker (queued
            # jobs still flush first)
            weakref.finalize(self, self._writer.close, drain=False)
        return self._writer

    def save(self, path: str, *, wait: bool = True) -> str:
        """Snapshot the session to ``path``: sync the carry back into the
        dCSR partitions, copy them and the runtime to host buffers, and
        write them atomically on the background writer.

        At return the content is captured (a later step, ``save`` or GC
        cannot change it) and any earlier background error has been
        raised; with ``wait=True`` (the default) this snapshot and every
        one queued before it are durable on disk."""
        self._ensure_state()
        if self._writer is not None:
            self._writer.check()  # surface earlier background failures
        self._sim.state_to_dcsr(self._state)
        step = self.t
        snap = snapshot_network(self.net, self._sim.runtime_state(self._state), step)
        w = self._writer_obj()
        w.submit(self._write_and_mark, snap, path, step, context=dict(step=step, path=path))
        if wait:
            w.wait()
        return path

    def _write_and_mark(self, snap, path: str, step: int) -> None:
        """Background write body: only a write that fully landed advances
        ``_last_good_ckpt_step``."""
        write_snapshot(snap, path, atomic=True)
        with self._ckpt_mark_lock:
            self._last_good_ckpt_step = step

    def wait(self) -> None:
        """Block until every queued snapshot (and retention) has landed,
        raising any background write error."""
        if self._writer is not None:
            self._writer.wait()

    def close(self) -> None:
        """Drain the checkpoint queue and stop the background writer
        (raising any pending background error); a later ``save`` starts a
        new writer."""
        if self._writer is not None:
            w, self._writer = self._writer, None
            w.close()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:
            try:  # do not mask the exception in flight with a drain error
                self.close()
            except Exception as drain_err:
                warnings.warn(
                    "background checkpoint write failed while unwinding "
                    f"another exception: {drain_err!r}",
                    RuntimeWarning,
                    stacklevel=2,
                )
        return False

    @classmethod
    def restore(
        cls,
        path: str,
        *,
        k: Optional[int] = None,
        cfg: Optional[SimConfig] = None,
        assignment: Optional[np.ndarray] = None,
        engine: str = "auto",
        device=None,
        devices: Optional[Sequence] = None,
        streaming: bool = False,
        _noise_fn=None,
    ) -> "Session":
        """A session from ``save``'s output, or from the newest valid step
        of a ``checkpoint_every`` root.  A ``k`` or ``assignment`` unlike
        the snapshot's repartitions the net and its runtime
        (:func:`.reshard.reshard_sim_state`, ``block_partition`` for
        ``k``) before the engine is built; the continued trajectory is the
        uninterrupted run's.  ``engine``, ``device`` and ``devices`` are as
        in ``Session(net)``."""
        if streaming:
            raise _unported("Session.restore(streaming=True)", "streaming ingest")
        t0 = time.perf_counter()
        net, sim_state, t_now = load_latest_valid(os.fspath(path))
        t1 = time.perf_counter()
        if assignment is not None or (k is not None and k != net.k):
            asn = (np.asarray(assignment, np.int64) if assignment is not None
                   else block_partition(net.n, k))
            net, sim_state = reshard_sim_state(net, sim_state, asn)
        t2 = time.perf_counter()
        ses = cls(net, cfg, engine=engine, device=device, devices=devices, _noise_fn=_noise_fn)
        ses._t0 = int(t_now)
        ses._pending_runtime = sim_state if sim_state else None
        ses.restore_seconds = dict(load=t1 - t0, reshard=t2 - t1, build=time.perf_counter() - t2)
        return ses

    @staticmethod
    def _gc_checkpoints(root: str, keep: int) -> None:
        for step in snapshot_steps(root)[:-keep]:
            d = os.path.join(root, f"step_{step:08d}")
            shutil.rmtree(d, ignore_errors=True)
            shutil.rmtree(d + ".old", ignore_errors=True)

    # -- not ported yet (ROADMAP queue) ------------------------------------
    run_supervised = _raises("Session.run_supervised", "fault tolerance")
