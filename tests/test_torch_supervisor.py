"""The port's self-healing supervised run and resilient restore
(``repro_torch.snn.supervisor``) on the CPU.

* The green tests of the reference's ``tests/test_supervisor.py`` over the
  port, the reference's ``FaultPlan`` driving it: file faults through
  ``repro_torch.io.fault_hook(repro.testing.faults.fault_point)``, state
  faults through an adapter that hands the reference's
  ``apply_state_faults`` the port's membranes in the reference's layout
  (``(n, S)`` at k = 1, the stacked ``(k, n_p, S)`` on spmd), so one plan
  seed poisons the same neuron in both packages.
* The k=2 chaos acceptance run, in process on ``devices=["cpu"] * 2``.
* The same net and plan through both packages (the reference's noise
  through ``_noise_fn``): equal rollbacks, steps lost, events and rasters.
* The rollback that keeps the engine against the one that rebuilds it.
"""
import contextlib
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.snn import Session as JSession
from repro.snn import SimConfig as JSimConfig
from repro.snn import monitors as jmon
from repro.snn import network as jnet
from repro.testing import Fault, FaultPlan
from repro.testing.faults import apply_state_faults as j_apply_state_faults
from repro.testing.faults import fault_point as j_fault_point
from repro.testing.faults import no_faults
from repro_torch import io as tio
from repro_torch.builder import balanced_ei_rules
from repro_torch.builder.procedural import build_network, build_partition
from repro_torch.io import load_latest_valid, save_binary, snapshot_steps
from repro_torch.io.async_writer import WriteJobError
from repro_torch.io.dcsr_binary import load_binary
from repro_torch.snn import (
    HealthConfig,
    RasterMonitor,
    RetryPolicy,
    Session,
    SimConfig,
    balanced_ei,
    restore_resilient,
    to_dcsr,
)
from repro_torch.snn import network as tnet
from repro_torch.snn import session as session_mod
from repro_torch.snn.supervisor import _check_health, membrane_stats

CPU = dict(device="cpu")


def k1_net(seed=3, mod=tnet):
    return mod.to_dcsr(mod.balanced_ei(n=120, seed=seed), k=1)


def _flip_byte(path, off=200):
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ 0xFF]))


def _ref_state_faults(site, state):
    """The reference's ``apply_state_faults`` on the port's carry, in the
    reference's layout, written back into the carry when a fault fired."""
    carries = state if isinstance(state, list) else [state]
    v = np.stack([c["vtx_state"].cpu().numpy() for c in carries])
    arg = {"vtx_state": jnp.asarray(v if isinstance(state, list) else v[0])}
    out = j_apply_state_faults(site, arg)
    if out is arg:
        return state
    new = np.asarray(out["vtx_state"]).reshape(v.shape)
    res = [dict(c, vtx_state=torch.tensor(x, device=c["vtx_state"].device))
           for c, x in zip(carries, new)]
    return res if isinstance(state, list) else res[0]


@contextlib.contextmanager
def ref_faults(*faults, seed=0):
    """A reference ``FaultPlan`` of ``faults`` driving the port's hooks (and
    no session-wide plan besides)."""
    plan = FaultPlan(list(faults), seed=seed)
    with no_faults(), plan, tio.fault_hook(j_fault_point), \
            tio.state_fault_hook(_ref_state_faults):
        yield plan


@pytest.fixture(autouse=True)
def _no_fsync():
    with tio.fsync_override(False):
        yield


# -- resilient restore: quarantine + keystream regeneration -----------------

def test_restore_resilient_quarantines_and_regenerates(tmp_path):
    spec = balanced_ei_rules(n=120, seed=3, stdp=False)
    net = build_network(spec, k=3, uniform=True, device="cpu")
    root = str(tmp_path / "steps")
    save_binary(net, os.path.join(root, "step_00000000"), t_now=0, atomic=True)
    save_binary(net, os.path.join(root, "step_00000010"), t_now=10, atomic=True)
    shard = os.path.join(root, "step_00000010", "part1.npz")
    _flip_byte(shard)

    with no_faults(), pytest.warns(UserWarning, match="quarantined"):
        net2, _sim, t, report = restore_resilient(root, device="cpu")
    assert t == 0                        # fell back past the corrupt step
    assert report.regenerated == [1]
    assert report.regenerate_seconds > 0
    assert [ps for _, _, ps in report.quarantined] == [[1]]
    # damaged bytes kept aside for post-mortem; shard no longer restorable
    assert os.path.exists(shard + ".quarantine")
    assert not os.path.exists(shard)
    _, _, t2 = load_latest_valid(root)
    assert t2 == 0
    # regenerated topology is bit-identical to the original partition
    for fld in ("row_ptr", "col_idx", "coords", "global_ids"):
        np.testing.assert_array_equal(getattr(net2.parts[1], fld), getattr(net.parts[1], fld))


def test_restore_resilient_without_rulespec_warns(tmp_path):
    """A snapshot of a non-procedural network carries no RuleSpec: the
    corrupt shard is still quarantined and the older step restored, but
    regeneration is impossible and says so."""
    net = to_dcsr(balanced_ei(n=80, seed=1), k=2, uniform=True)
    root = str(tmp_path / "steps")
    save_binary(net, os.path.join(root, "step_00000000"), t_now=0, atomic=True)
    save_binary(net, os.path.join(root, "step_00000010"), t_now=10, atomic=True)
    _flip_byte(os.path.join(root, "step_00000010", "part0.npz"))

    with no_faults(), pytest.warns(UserWarning, match="cannot be regenerated"):
        net2, _sim, t, report = restore_resilient(root)
    assert t == 0
    assert report.regenerated == []
    np.testing.assert_array_equal(net2.parts[0].col_idx, net.parts[0].col_idx)


def test_restore_resilient_raises_when_nothing_valid(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_resilient(str(tmp_path / "empty"))


# -- supervised loop: health rollback heals bit-identically -----------------

@pytest.fixture(scope="module")
def reference_run():
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    ras = RasterMonitor()
    res = ses.run(120, monitors=[ras], chunk_size=30)
    return res, ras, ses.state["vtx_state"].clone()


def test_supervised_nan_rollback_bit_identical(tmp_path, reference_run):
    res_ref, ras_ref, v_ref = reference_run
    root = str(tmp_path / "ck")
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    sim = ses.simulator
    ras = RasterMonitor()
    with ref_faults(Fault("supervisor:state", "nan", after=1, count=1), seed=5):
        with pytest.warns(UserWarning, match="rolled back"):
            res = ses.run_supervised(
                120, monitors=[ras], chunk_size=30,
                checkpoint_every=30, checkpoint_dir=root,
            )
    assert res.rollbacks == 1
    assert res.steps_lost == 30          # t=60 back to the t=30 checkpoint
    assert res.t_final == 120
    assert [ev.kind for ev in res.events][:2] == ["health", "rollback"]
    assert res.events[0].detail == "non-finite membrane state (1 values)"
    # committed outputs replace the rolled-back span bit-identically
    np.testing.assert_array_equal(res.spike_count, res_ref.spike_count)
    np.testing.assert_array_equal(ras.raster, ras_ref.raster)
    assert torch.equal(ses.state["vtx_state"], v_ref)
    # the rollback kept the engine
    assert ses.simulator is sim
    (rb,) = ses.last_rollbacks
    assert rb["in_place"] and (rb["t_from"], rb["t_to"]) == (60, 30)
    # mapping contract (summary() etc. treat it like a RunResult)
    assert set(res.keys()) == {"spike_count", "overflow"}
    np.testing.assert_array_equal(res["spike_count"], res.spike_count)
    ses.close()


def test_supervised_storm_trips_membrane_ceiling(tmp_path, reference_run):
    """A storm-primed state (|V| blown far past threshold) is caught by
    the max_vm gate on the very chunk it appears, before the boundary
    checkpoint, so no snapshot on disk ever holds poisoned state."""
    res_ref, ras_ref, v_ref = reference_run
    root = str(tmp_path / "ck")
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    ras = RasterMonitor()
    with ref_faults(Fault("supervisor:state", "storm", after=1, count=1), seed=6):
        with pytest.warns(UserWarning, match="rolled back"):
            res = ses.run_supervised(
                120, monitors=[ras], chunk_size=30,
                checkpoint_every=30, checkpoint_dir=root,
            )
    assert res.rollbacks == 1
    assert any("membrane runaway" in ev.detail for ev in res.events)
    np.testing.assert_array_equal(ras.raster, ras_ref.raster)
    ses.close()
    # the health gate held: every checkpoint on disk is finite and sane
    for step in snapshot_steps(root):
        net_s, _, _ = load_binary(os.path.join(root, f"step_{step:08d}"))
        for part in net_s.parts:
            v = part.vtx_state[:, 0]
            assert np.all(np.isfinite(v)) and np.all(np.abs(v) <= 1e3)


def test_supervised_gives_up_after_bounded_rollbacks(tmp_path):
    root = str(tmp_path / "ck")
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    with ref_faults(Fault("supervisor:state", "nan", count=-1), seed=0):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match="giving up"):
                ses.run_supervised(
                    120, chunk_size=30, checkpoint_every=30, checkpoint_dir=root,
                    retry=RetryPolicy(max_rollbacks=2, backoff_s=0.001),
                )
    assert len(ses.last_rollbacks) == 3
    ses.close()


def test_supervised_checkpoint_failure_rolls_back_then_gives_up(tmp_path):
    """A persistent manifest-write failure (survives every write- and
    queue-level retry) triggers rollbacks, then a bounded giveup chaining
    the background error with its job context."""
    root = str(tmp_path / "ck")
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    # every checkpoint from t=60 on fails persistently: no rollback target
    # past step 30 can ever become durable, so the run must give up
    faults = [Fault("manifest_write", "io_error", match=f"step_{s:08d}", count=-1)
              for s in (60, 90, 120)]
    with ref_faults(*faults, seed=0):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pytest.raises(RuntimeError, match="giving up") as ei:
                ses.run_supervised(
                    120, chunk_size=30, checkpoint_every=30, checkpoint_dir=root,
                    retry=RetryPolicy(max_rollbacks=2, backoff_s=0.001),
                )
    cause = ei.value.__cause__
    assert isinstance(cause, WriteJobError)
    assert cause.step in (60, 90, 120)   # the job context names the step
    # nothing past the last healthy checkpoint ever became durable
    assert max(snapshot_steps(root)) == 30
    ses.close()


def test_supervised_validates_arguments(tmp_path):
    ses = Session(k1_net(), SimConfig(align_k=8), **CPU)
    with pytest.raises(ValueError, match="checkpoint_every"):
        ses.run_supervised(10, checkpoint_every=0, checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint_dir"):
        ses.run_supervised(10, checkpoint_every=5, checkpoint_dir="")
    with pytest.raises(ValueError, match="steps"):
        ses.run_supervised(0, checkpoint_every=5, checkpoint_dir=str(tmp_path))
    ses.close()


def test_health_config_overflow_escalation_detector():
    """Unit check of the escalation rule: strictly rising overflow for N
    consecutive chunks trips, plateaus do not."""

    class _FakeSession:
        n = 100
        state = {"vtx_state": torch.zeros((100, 2))}

    hc = HealthConfig(max_rate=None, overflow_escalations=3)
    rates = []
    outs = {"spike_count": np.zeros(10, np.int32), "overflow": np.zeros(10, np.int32)}
    ses = _FakeSession()
    for ov in (0, 1, 2, 3):              # strictly rising
        outs = dict(outs, overflow=np.full(10, ov, np.int32))
        sick = _check_health(ses, outs, hc, rates)
    assert sick is not None and "escalating" in sick
    rates = []
    for ov in (0, 2, 2, 2):              # plateau: no trip
        outs = dict(outs, overflow=np.full(10, ov, np.int32))
        sick = _check_health(ses, outs, hc, rates)
    assert sick is None


def test_membrane_stats_match_the_reference_host_scan():
    """The device reduction gives the reference's count and max: every
    non-finite value over all columns and partitions, and max |V| of
    column 0 ignoring NaN (an infinite membrane is a runaway)."""
    rng = np.random.default_rng(0)
    parts = [rng.normal(-60, 5, (50, 3)).astype(np.float32) for _ in range(3)]
    parts[1][4, 0] = np.nan
    parts[2][7, 2] = np.inf
    parts[0][9, 0] = -2e3
    state = [{"vtx_state": torch.from_numpy(p)} for p in parts]
    v = np.stack(parts)
    n_bad, vmax = membrane_stats(state)
    assert n_bad == int(v.size - np.isfinite(v).sum()) == 2
    assert vmax == float(np.nanmax(np.abs(v[..., 0]))) == 2e3
    assert membrane_stats(state[1]) == (1, float(np.nanmax(np.abs(parts[1][:, 0]))))


def test_run_supervised_is_surfaced_on_session():
    assert callable(getattr(Session, "run_supervised"))
    assert HealthConfig().max_vm == 1e3  # storm gate on by default


# -- the rollback keeps the engine, or rebuilds it -----------------------------

def _plastic_spec():
    return balanced_ei_rules(n=240, seed=7, stdp=True)


@pytest.mark.parametrize("k", [1, 2])
def test_in_place_rollback_equals_the_rebuild(tmp_path, monkeypatch, k):
    """On a plastic net (weights in the carry), a rollback that keeps the
    engine and one that rebuilds it (the reference's way, forced by a
    topology check that says no) give the same raster, spike counts,
    ``vtx_state``, weights and traces; only the first keeps
    ``ses.simulator``."""
    spec = _plastic_spec()
    cfg = SimConfig(align_k=8, exchange="dense")
    kw = dict(k=k, engine="spmd", devices=["cpu"] * k) if k > 1 else CPU
    out = {}
    for how in ("in_place", "rebuild"):
        ses = Session(spec, cfg, **kw)
        sim = ses.simulator
        if how == "rebuild":
            monkeypatch.setattr(session_mod, "same_engine_inputs", lambda *a: False)
        ras = RasterMonitor()
        with ref_faults(Fault("supervisor:state", "nan", after=2, count=1), seed=3):
            with pytest.warns(UserWarning, match="rolled back"):
                res = ses.run_supervised(100, monitors=[ras], chunk_size=25,
                                         checkpoint_every=50,
                                         checkpoint_dir=str(tmp_path / how))
        monkeypatch.undo()
        assert (res.rollbacks, res.steps_lost) == (1, 25)
        assert (ses.simulator is sim) == (how == "in_place")
        assert ses.last_rollbacks[0]["in_place"] == (how == "in_place")
        carries = ses.state if k > 1 else [ses.state]
        out[how] = (ras.raster, res.spike_count,
                    [c[key] for c in carries for key in ("vtx_state", "tr_plus", "tr_minus")],
                    [w for c in carries for w in c["weights"]])
        ses.close()
    a, b = out["in_place"], out["rebuild"]
    assert a[0].sum() > 0
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for x, y in zip(a[2] + a[3], b[2] + b[3]):
        assert torch.equal(x, y)


# -- end-to-end acceptance: k=2 plastic run under a seeded chaos plan -------

def test_supervised_e2e_k2_chaos_bit_identical(tmp_path):
    """The reference's acceptance run, in process on the port's spmd engine
    with two CPU partitions: a transient writer IO error, one injected NaN
    and one bit-flipped shard.  run_supervised completes; raster, spike
    counts, vtx_state and weights are bit-identical to an undisturbed run;
    the quarantined shard's topology is regenerated from the keystream."""
    spec = balanced_ei_rules(n=240, seed=7, stdp=True)
    cfg = SimConfig(align_k=8, exchange="dense")
    spmd = dict(k=2, engine="spmd", devices=["cpu"] * 2)

    ref = Session(spec, cfg, **spmd)
    assert ref.engine_kind == "spmd"
    ras_ref = RasterMonitor()
    res_ref = ref.run(120, monitors=[ras_ref], chunk_size=30)

    ses = Session(spec, cfg, **spmd)
    sim = ses.simulator
    ras = RasterMonitor()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with ref_faults(
            Fault("shard_write", "io_error", per_path=True),
            Fault("supervisor:state", "nan", after=1, count=1),
            Fault("shard_read", "bit_flip", match="step_00000030/part0", count=1),
            seed=11,
        ) as plan:
            res = ses.run_supervised(120, monitors=[ras], chunk_size=30,
                                     checkpoint_every=30, checkpoint_dir=str(tmp_path))
    kinds = [kind for _, _, kind in plan.fired]
    assert {"io_error", "nan", "bit_flip"} <= set(kinds)
    # NaN at t=60 -> rollback; step_00000030's part0 was bit-flipped on
    # read -> quarantined -> fell back to step_00000000
    assert res.rollbacks == 1, res.rollbacks
    assert res.steps_lost == 60, res.steps_lost
    assert res.t_final == 120
    rep = res.restore_reports[0]
    assert rep.regenerated == [0], rep
    assert any(0 in ps for _, _, ps in rep.quarantined)
    assert any(ev.kind == "quarantine" for ev in res.events)
    # the regenerated partition has the engine's topology: it stayed
    assert ses.simulator is sim and ses.last_rollbacks[0]["in_place"]
    # bit-identical to the undisturbed run from the rollback on
    np.testing.assert_array_equal(res.spike_count, res_ref.spike_count)
    np.testing.assert_array_equal(ras.raster, ras_ref.raster)
    for a, b in zip(ses.state, ref.state):
        for key in ("vtx_state", "tr_plus", "tr_minus"):
            assert torch.equal(a[key], b[key]), key
        for wa, wb in zip(a["weights"], b["weights"]):
            assert torch.equal(wa, wb)
    # the session now runs on keystream-regenerated topology, bit-identical
    # to a fresh procedural build of partition 0
    regen = build_partition(spec, 2, 0, uniform=True, device="cpu")
    for fld in ("row_ptr", "col_idx", "vtx_model", "edge_model", "coords", "global_ids"):
        np.testing.assert_array_equal(getattr(ses.net.parts[0], fld), getattr(regen, fld))
    assert ses.net is sim.net
    ses.close()
    ref.close()


# -- across packages -----------------------------------------------------------

def _reference_noise(net):
    """The reference's noise draw at ``SimConfig().seed``, for the seam."""
    sigma, n = float(net.meta["noise_sigma"]), net.n
    key = jax.random.PRNGKey(SimConfig().seed)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


def test_same_plan_same_recovery_in_both_packages(tmp_path):
    """One net, one plan (a NaN after the second chunk, seed 5): the
    reference's supervised run and the port's, the reference's noise in
    both, give equal rollbacks, steps lost, events (kinds, steps and
    texts), spike counts and rasters."""
    faults = [Fault("supervisor:state", "nan", after=1, count=1)]
    jses = JSession(k1_net(mod=jnet), JSimConfig(align_k=8))
    jras = jmon.RasterMonitor()
    with no_faults(), FaultPlan(faults, seed=5):
        with pytest.warns(UserWarning, match="rolled back"):
            jres = jses.run_supervised(120, monitors=[jras], chunk_size=30,
                                       checkpoint_every=30, checkpoint_dir=str(tmp_path / "j"))
    jses.close()

    net = k1_net()
    ses = Session(net, SimConfig(align_k=8), _noise_fn=_reference_noise(net), **CPU)
    ras = RasterMonitor()
    with ref_faults(*faults, seed=5):
        with pytest.warns(UserWarning, match="rolled back"):
            res = ses.run_supervised(120, monitors=[ras], chunk_size=30,
                                     checkpoint_every=30, checkpoint_dir=str(tmp_path / "t"))
    ses.close()
    assert jres.rollbacks == res.rollbacks == 1
    assert jres.steps_lost == res.steps_lost == 30
    assert jres.t_final == res.t_final == 120
    assert [(e.kind, e.t, e.detail) for e in res.events] == \
        [(e.kind, e.t, e.detail) for e in jres.events]
    assert jras.raster.sum() > 0
    np.testing.assert_array_equal(res.spike_count, np.asarray(jres.spike_count))
    np.testing.assert_array_equal(ras.raster, jras.raster)
