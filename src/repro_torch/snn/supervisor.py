"""Self-healing supervised run loop and resilient (quarantining) restore.

A port of the reference's ``repro/snn/supervisor.py``: the same policies,
events, warnings and messages, over the port's ``Session`` and io layer.

* :func:`run_supervised` (surfaced as ``Session.run_supervised``) drives the
  chunked run with a per-chunk **health check** (non-finite membrane state,
  a membrane-magnitude ceiling, spike-storm rate runaway, exchange overflow
  and its escalation) and, on a violation or a checkpoint IO failure that
  survived the writer's own retries, rolls the session back to the newest
  valid checkpoint, with bounded consecutive rollbacks and exponential
  backoff.  Health gates the checkpoints: a chunk's state is checked
  *before* the boundary save, so the newest checkpoint is always a safe
  rollback target.

* :func:`restore_resilient` is the quarantining restore walk behind the
  rollback: steps are tried newest-first; a step whose manifest is intact
  but whose shard fails CRC has that shard renamed aside to
  ``part<p>.npz.quarantine`` and the walk continues to the next older step.
  When the snapshot carries its generating ``RuleSpec``, the quarantined
  partition's topology is regenerated from the counter-based keystream
  (``builder.procedural.build_partition``, on the session's device: the
  keystream kernel on the card) and verified against the restored step.  A
  ``UserWarning`` accounts for exactly which steps were lost.

Where the port differs from the reference:

* The health gate reduces on the device: one non-finite count and one
  ``max |V|`` of column 0 per partition's carry, read back in one copy a
  chunk, instead of copying the whole ``vtx_state`` to the host.
* The rollback keeps the engine when it can (``Session._reload_from_snapshot``):
  a restored net whose topology, delays and (non-plastic) weights equal the
  running engine's is uploaded into a new carry of the same simulator, so
  its panels and its captured CUDA graphs stay; otherwise it rebuilds the
  engine, as the reference does.
* The state hook is the port's own (``io.hooks.apply_state_faults``): the
  port's active ``testing.fault_plans`` plans write their ``nan`` and
  ``storm`` faults into the carry in place; without one it returns the
  carry unchanged.

Because the trajectory is a pure function of ``(seed, t, permanent id)`` and
chunking is bit-transparent, a rollback and re-run reproduces the pre-fault
trajectory bit for bit.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from ..io.dcsr_binary import (
    _snapshot_dir_candidates,
    load_binary,
    quarantine_shards,
    snapshot_steps,
    verify_snapshot,
)
from ..io.hooks import apply_state_faults
from .simulator import TOPOLOGY_FIELDS

_DEFAULT_CHUNK = 128


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Per-chunk health checks for :func:`run_supervised`.

    ``check_finite`` scans the membrane state for NaN/Inf after every chunk;
    ``max_vm`` is a membrane-magnitude ceiling on the same scan (column 0),
    so a storm-primed state is caught on the chunk it appears, before the
    boundary checkpoint; the spike-rate ceiling ``max_rate`` (spikes per
    neuron per step, chunk mean) sees a storm only in the chunk's output.
    ``max_overflow_rate`` bounds spikes dropped by a lossy exchange per
    neuron per step; ``overflow_escalations`` trips when the per-chunk
    overflow rate rises strictly for that many consecutive chunks (0
    disables).  ``None`` disables a check."""

    check_finite: bool = True
    max_vm: Optional[float] = 1e3
    max_rate: Optional[float] = 0.8
    max_overflow_rate: Optional[float] = None
    overflow_escalations: int = 3


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Rollback budget: at most ``max_rollbacks`` *consecutive* rollbacks
    without forward progress (progress past the furthest step previously
    reached resets the counter), sleeping ``backoff_s * factor**i`` before
    re-running after the i-th consecutive rollback."""

    max_rollbacks: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0


@dataclasses.dataclass(frozen=True)
class SupervisorEvent:
    kind: str    # "health" | "io_error" | "rollback" | "quarantine"
    t: int       # session step when the event was observed
    detail: str


@dataclasses.dataclass
class RestoreReport:
    """What :func:`restore_resilient` did: every step dir it skipped and
    why, the shards it quarantined, the partitions whose topology it
    regenerated from the RuleSpec keystream, and the regeneration's host
    seconds."""

    t_now: int = -1
    skipped: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    quarantined: List[Tuple[str, int, List[int]]] = dataclasses.field(
        default_factory=list
    )  # (dir, t_now of that step, part ids)
    regenerated: List[int] = dataclasses.field(default_factory=list)
    regenerate_seconds: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class SupervisedResult:
    """Mapping-compatible with :class:`~.session.RunResult`
    (``result["spike_count"]`` etc.) plus the supervision ledger."""

    spike_count: np.ndarray
    t_final: int
    chunks: Tuple[int, ...]
    overflow: np.ndarray
    rollbacks: int
    steps_lost: int
    events: Tuple[SupervisorEvent, ...]
    restore_reports: Tuple[RestoreReport, ...]

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

    def keys(self):
        return ("spike_count", "overflow")


# ---------------------------------------------------------------------------
# Resilient restore (quarantine + keystream topology regeneration)
# ---------------------------------------------------------------------------


def _regenerate_quarantined(net, parts: Iterable[int], report: RestoreReport,
                            device=None) -> None:
    """Rebuild each quarantined partition's topology from the RuleSpec
    keystream on ``device``, verify it is bit-identical to the restored
    step's, and substitute it into ``net``."""
    rs = getattr(net, "rule_spec", None)
    parts = sorted(set(parts))
    if rs is None:
        warnings.warn(
            f"quarantined shard(s) {parts}: snapshot carries no RuleSpec "
            "(network was not procedurally built at this k) — topology "
            "cannot be regenerated, restored entirely from the older "
            "checkpoint instead",
            UserWarning, stacklevel=3,
        )
        return
    if int(rs.get("k", -1)) != net.k:
        warnings.warn(
            f"quarantined shard(s) {parts}: RuleSpec was recorded at "
            f"k={rs.get('k')} but the snapshot is k={net.k} (elastic "
            "reshard in between) — skipping keystream regeneration",
            UserWarning, stacklevel=3,
        )
        return
    from ..builder.procedural import build_partition
    from ..builder.rules import spec_from_dict

    t0 = time.perf_counter()
    spec = spec_from_dict(rs["spec"])
    for p in parts:
        regen = build_partition(spec, net.k, p, uniform=rs["uniform"], device=device)
        for fld in TOPOLOGY_FIELDS:
            if not np.array_equal(getattr(regen, fld), getattr(net.parts[p], fld)):
                raise RuntimeError(
                    f"keystream regeneration of partition {p} diverged "
                    f"from the checkpoint on {fld!r} — refusing to "
                    "continue with unverifiable topology"
                )
            setattr(net.parts[p], fld, getattr(regen, fld))
        report.regenerated.append(p)
    report.regenerate_seconds += time.perf_counter() - t0


def restore_resilient(
    path: str, *, verify: bool = True, regenerate: bool = True, device=None,
) -> Tuple[object, Dict, int, RestoreReport]:
    """Quarantining restore: like ``load_latest_valid`` but a step whose
    shard fails CRC is quarantined (shard renamed to ``.quarantine``)
    rather than silently skipped, and, when the manifest carries the
    generating RuleSpec, the quarantined partition's topology is
    regenerated from the keystream on ``device`` (the card unless the
    caller names another; only needed when a shard was quarantined) and
    verified against the restored older step.  Returns ``(net, sim_state,
    t_now, report)``."""
    path = os.fspath(path)
    if os.path.exists(os.path.join(path, "manifest.json")) or \
            os.path.exists(os.path.join(path + ".old", "manifest.json")):
        cands = [(0, path)]
        if os.path.exists(os.path.join(path + ".old", "manifest.json")):
            cands.append((0, path + ".old"))
    else:
        cands = _snapshot_dir_candidates(path)
    report = RestoreReport()
    newest_t: Optional[int] = None
    for _step, d in cands:
        try:
            man, bad = verify_snapshot(d)
        except (OSError, ValueError, KeyError) as e:
            report.skipped.append((d, f"manifest unreadable: {e}"))
            continue
        t_step = int(man.get("t_now", -1))
        if newest_t is None:
            newest_t = t_step
        if bad:
            quarantine_shards(d, bad)
            report.quarantined.append((d, t_step, list(bad)))
            report.skipped.append((d, f"shards {bad} failed CRC -> quarantined"))
            continue
        try:
            net, sim_state, t_now = load_binary(d, verify=verify)
        except (OSError, ValueError, KeyError) as e:
            report.skipped.append((d, f"load failed after CRC pass: {e}"))
            continue
        report.t_now = int(t_now)
        if report.quarantined:
            bad_parts = sorted({p for _, _, ps in report.quarantined for p in ps})
            if regenerate:
                _regenerate_quarantined(net, bad_parts, report, device)
            lost = (newest_t - t_now) if newest_t is not None and \
                newest_t >= 0 else "unknown"
            warnings.warn(
                f"restore quarantined corrupt shard(s) "
                f"{[(os.path.basename(q[0]), q[2]) for q in report.quarantined]} "
                f"and fell back to checkpoint step {t_now}: exactly "
                f"{lost} simulated steps (t={t_now}..{newest_t}) were "
                f"lost"
                + (
                    f"; topology of partition(s) {report.regenerated} "
                    "regenerated bit-identically from the RuleSpec "
                    "keystream"
                    if report.regenerated else ""
                ),
                UserWarning, stacklevel=2,
            )
        return net, sim_state, int(t_now), report
    raise FileNotFoundError(
        f"no valid dCSR snapshot under {path!r} "
        f"(skipped: {report.skipped or 'nothing found'})"
    )


# ---------------------------------------------------------------------------
# Supervised run loop
# ---------------------------------------------------------------------------


class _Capture:
    """Single-chunk monitor shim: ``run`` enables recordings from this
    ``requires`` set and hands the full host outs to ``on_chunk``; the
    supervisor buffers them and replays them to the real monitors only once
    the run has survived to the end."""

    def __init__(self, requires):
        self.requires = tuple(requires)
        self.outs: Optional[Dict] = None

    def begin(self, session):
        pass

    def on_chunk(self, t0: int, outs: Dict) -> None:
        self.outs = outs

    def finalize(self):
        pass


def membrane_stats(state) -> Tuple[int, float]:
    """``(non-finite values, max |V| of column 0 ignoring NaN)`` over every
    partition's ``vtx_state`` (a carry dict, or the spmd engine's list of
    them), reduced on the carries' devices and read back in one copy;
    ``(0, -inf)`` for an empty state."""
    carries = state if isinstance(state, (list, tuple)) else [state]
    home = carries[0]["vtx_state"].device
    rows = []
    for c in carries:
        v = c["vtx_state"]
        if not v.numel():
            continue
        col = v[..., 0].abs()
        vmax = torch.where(torch.isnan(col), float("-inf"), col).max()
        rows.append(torch.stack([(~torch.isfinite(v)).sum().double(),
                                 vmax.double()]).to(home))
    if not rows:
        return 0, float("-inf")
    s = torch.stack(rows).cpu()
    return int(s[:, 0].sum()), float(s[:, 1].max())


def _check_health(session, outs: Dict, health: HealthConfig,
                  overflow_rates: List[float]) -> Optional[str]:
    """None when healthy, else a human-readable violation."""
    if health.check_finite or health.max_vm is not None:
        n_bad, vmax = membrane_stats(session.state)
        if health.check_finite and n_bad:
            return f"non-finite membrane state ({n_bad} values)"
        if health.max_vm is not None and vmax > health.max_vm:
            return (
                f"membrane runaway: |V|max = {vmax:.4g} exceeds the "
                f"ceiling {health.max_vm}"
            )
    n = max(session.n, 1)
    steps = max(len(outs["spike_count"]), 1)
    if health.max_rate is not None:
        rate = float(np.mean(outs["spike_count"])) / n
        if rate > health.max_rate:
            return (
                f"spike storm: {rate:.4f} spikes/neuron/step exceeds the "
                f"ceiling {health.max_rate}"
            )
    ov_rate = float(np.sum(outs["overflow"])) / (n * steps)
    overflow_rates.append(ov_rate)
    if health.max_overflow_rate is not None and \
            ov_rate > health.max_overflow_rate:
        return (
            f"exchange overflow: {ov_rate:.6f} dropped/neuron/step "
            f"exceeds the ceiling {health.max_overflow_rate}"
        )
    esc = health.overflow_escalations
    if esc and len(overflow_rates) > esc:
        tail = overflow_rates[-(esc + 1):]
        if all(b > a for a, b in zip(tail, tail[1:])) and tail[-1] > 0:
            return (
                f"escalating exchange overflow: dropped-spike rate rose "
                f"for {esc} consecutive chunks (latest {tail[-1]:.6f} "
                "/neuron/step)"
            )
    return None


def run_supervised(
    session,
    steps: int,
    monitors: Iterable = (),
    *,
    chunk_size: Optional[int] = None,
    checkpoint_every: int,
    checkpoint_dir: str,
    max_to_keep: Optional[int] = None,
    health: Optional[HealthConfig] = None,
    retry: Optional[RetryPolicy] = None,
) -> SupervisedResult:
    """Supervised, self-healing version of ``Session.run`` (see the module
    docstring).  ``checkpoint_every``/``checkpoint_dir`` are required:
    checkpoints are the rollback substrate; if the directory holds no
    snapshot yet, one is taken synchronously at the current step before the
    first chunk.

    Monitors are fed *committed* chunks only, in order, once the run has
    completed: outputs from a span later rolled back are discarded and
    replaced by the re-run.  Raises ``RuntimeError`` after
    ``retry.max_rollbacks`` consecutive rollbacks without forward progress,
    chaining the last cause.  ``session.last_rollbacks`` holds, per
    rollback, its steps, the host seconds of the writer's drain, of
    :func:`restore_resilient` (and of its keystream regeneration) and of
    the reload, and whether the reload kept the engine (``in_place``);
    ``session.last_ckpt_stalls`` the run loop's stall of each boundary
    checkpoint."""
    if steps <= 0:
        raise ValueError(f"steps must be positive, got {steps}")
    if checkpoint_every is None or checkpoint_every <= 0:
        raise ValueError("run_supervised requires checkpoint_every > 0")
    if not checkpoint_dir:
        raise ValueError("run_supervised requires checkpoint_dir")
    health = health or HealthConfig()
    retry = retry or RetryPolicy()
    monitors = tuple(monitors)
    need = set()
    for mon in monitors:
        need |= set(getattr(mon, "requires", ()))

    # the step on the host: reading the carry's device t would sync
    t = t_start = session.t
    target = t_start + steps
    if not snapshot_steps(checkpoint_dir):
        # no rollback target yet: make one before the first chunk
        session.save(os.path.join(checkpoint_dir, f"step_{t_start:08d}"), wait=True)
    if chunk_size is None:
        chunk_size = min(steps, _DEFAULT_CHUNK)
    chunk_size = max(1, int(chunk_size))

    buffered: Dict[int, Dict] = {}   # chunk start step -> host outs
    events: List[SupervisorEvent] = []
    reports: List[RestoreReport] = []
    timings: List[Dict] = []
    stalls: List[float] = []
    overflow_rates: List[float] = []
    rollbacks = 0
    steps_lost = 0
    attempts = 0          # consecutive rollbacks without progress
    progress_mark = t_start   # furthest step reached before last rollback

    def _rollback(cur_t: int, reason: str, cause: Optional[BaseException]) -> int:
        nonlocal rollbacks, steps_lost, attempts, progress_mark
        t_drain = time.perf_counter()
        while True:
            # drain in-flight writes before restoring, consuming EVERY stale
            # background error (each wait() surfaces one): failures from the
            # span being rolled back must not poison the saves of the re-run
            try:
                session.wait()
                break
            except OSError as e:
                events.append(SupervisorEvent("io_error", cur_t, f"while draining writer: {e}"))
        t_restore = time.perf_counter()
        net, sim_state, t_now, report = restore_resilient(checkpoint_dir, device=session.device)
        reports.append(report)
        for d, _t_q, ps in report.quarantined:
            events.append(SupervisorEvent(
                "quarantine", cur_t, f"{os.path.basename(d)}: shards {ps} quarantined"
            ))
        t_reload = time.perf_counter()
        in_place = session._reload_from_snapshot(net, sim_state, t_now)
        timings.append(dict(
            t_from=cur_t, t_to=t_now, drain=t_restore - t_drain,
            restore=t_reload - t_restore, reload=time.perf_counter() - t_reload,
            regenerate=report.regenerate_seconds, in_place=in_place,
        ))
        # discard buffered outputs from the rolled-back span; the re-run
        # replaces them (bit-identically when the span was healthy)
        for t0 in [t0 for t0 in buffered if t0 >= t_now]:
            del buffered[t0]
        rollbacks += 1
        steps_lost += max(cur_t - t_now, 0)
        if cur_t > progress_mark:
            attempts = 1          # made progress since the last rollback
            progress_mark = cur_t
        else:
            attempts += 1
        warnings.warn(
            f"supervised run rolled back from step {cur_t} to checkpoint "
            f"step {t_now} ({max(cur_t - t_now, 0)} steps lost, rollback "
            f"{rollbacks}, attempt {attempts}/{retry.max_rollbacks}); "
            f"reason: {reason}",
            UserWarning, stacklevel=3,
        )
        events.append(SupervisorEvent("rollback", cur_t, f"to step {t_now}: {reason}"))
        if attempts > retry.max_rollbacks:
            raise RuntimeError(
                f"supervised run giving up after {attempts} consecutive "
                f"rollbacks without progress past step {progress_mark}; "
                f"last reason: {reason}"
            ) from cause
        time.sleep(retry.backoff_s * retry.backoff_factor ** (attempts - 1))
        return t_now

    session.last_rollbacks = ()
    for mon in monitors:
        mon.begin(session)
    try:
        while True:
            while t < target:
                done = t - t_start
                # chunk grid: aligned to checkpoint boundaries and
                # deterministic in `done`, so a re-run hits the same starts
                to_ckpt = checkpoint_every - (done % checkpoint_every)
                c = min(chunk_size, target - t, to_ckpt)
                t0 = t
                cap = _Capture(need)
                try:
                    session.run(c, monitors=(cap,), chunk_size=c)
                except OSError as e:
                    # a background checkpoint error surfacing at this boundary
                    events.append(SupervisorEvent("io_error", t0, str(e)))
                    t = _rollback(t0, f"checkpoint write failure: {e}", e)
                    continue
                t = t0 + c
                buffered[t0] = cap.outs
                # fault-injection point for state corruption, then the health
                # gate, BEFORE the boundary checkpoint: poisoned state is never
                # checkpointed
                session._state = apply_state_faults("supervisor:state", session._state)
                sick = _check_health(session, cap.outs, health, overflow_rates)
                if sick is not None:
                    events.append(SupervisorEvent("health", t, sick))
                    t = _rollback(t, sick, None)
                    continue
                done = t - t_start
                if done % checkpoint_every == 0 or t == target:
                    try:
                        t_ck = time.perf_counter()
                        session.save(os.path.join(checkpoint_dir, f"step_{t:08d}"), wait=False)
                        if max_to_keep:
                            session._writer_obj().submit(
                                session._gc_checkpoints, checkpoint_dir, max_to_keep,
                            )
                        stalls.append(time.perf_counter() - t_ck)
                    except OSError as e:
                        events.append(SupervisorEvent("io_error", t, str(e)))
                        t = _rollback(t, f"checkpoint write failure: {e}", e)
                        continue
            try:
                session.wait()    # the final checkpoint must be durable
                break
            except OSError as e:
                events.append(SupervisorEvent("io_error", t, str(e)))
                t = _rollback(t, f"final checkpoint failed: {e}", e)
                # the outer loop re-runs the span the rollback re-opened
    finally:
        session.last_rollbacks = tuple(timings)
        session.last_ckpt_stalls = tuple(stalls)

    # committed: replay the buffered chunks to the real monitors in order
    starts = sorted(buffered)
    for t0 in starts:
        for mon in monitors:
            mon.on_chunk(t0, buffered[t0])
    for mon in monitors:
        mon.finalize()
    return SupervisedResult(
        spike_count=np.concatenate([buffered[t0]["spike_count"] for t0 in starts]),
        t_final=t,
        chunks=tuple(len(buffered[t0]["spike_count"]) for t0 in starts),
        overflow=np.concatenate([buffered[t0]["overflow"] for t0 in starts]),
        rollbacks=rollbacks,
        steps_lost=steps_lost,
        events=tuple(events),
        restore_reports=tuple(reports),
    )
