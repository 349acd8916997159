"""The heavy-row split (``SimConfig(max_k=...)``) in the port against the
reference, on the CPU.

* ``build_delay_ell(max_k=...)``: the port's copy gives the reference's
  arrays byte for byte, on the microcircuit and on the reference's
  one-heavy-row case (``tests/test_dcsr.py:test_ell_heavy_row_split``).
* ``ref.spike_gather_segment_ref`` against the reference's
  ``spike_gather_ref`` plus ``jax.ops.segment_sum``.
* 50 steps of the port on ``microcircuit(0.01)`` (``max_k=16``) and on a
  plastic ``balanced_ei(200)`` (``max_k=4``: its rows hold 3-6 synapses a
  bucket, so a cap of 16 would split none; 4 splits 13 of its 15 buckets
  and leaves 2 whole) against the reference with its noise injected
  through ``_noise_fn``: rasters equal, weights and traces equal to the
  reference run op by op (``jax.disable_jit()``, ROADMAP F4).
* ``fused=True`` raises the reference's blocker; at k=2 ``max_k`` changes
  nothing in either package; snapshots taken with ``max_k`` continue
  bit-equal within each package and raster-equal across them; a supervised
  run with a NaN rolls back in place.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.ell import build_delay_ell as j_build_delay_ell
from repro.kernels import ref as jref
from repro.snn import Session as JSession
from repro.snn import SimConfig as JSimConfig
from repro.snn import dist_sim as jdist
from repro.snn import network as jnet
from repro.snn.simulator import Simulator as JSimulator
from repro_torch import io as tio
from repro_torch.core import block_partition, build_delay_ell, from_edges
from repro_torch.kernels import ops, ref
from repro_torch.kernels.segment_gather import segment_plan
from repro_torch.snn import RasterMonitor, Session, SimConfig
from repro_torch.snn import network as tnet
from repro_torch.snn.dist_sim import DistSimulator
from repro_torch.snn.neurons import LIF_BIAS

SEED = 42  # SimConfig's default noise seed, in both packages
STEPS = 50
# (net, max_k, align_k): the microcircuit's rows are wider than 16 in both
# buckets; balanced_ei(200)'s rows hold 3-6 synapses a bucket
CASES = {
    "microcircuit": (lambda m: m.microcircuit(scale=0.01), 16, 4),
    "plastic": (lambda m: m.balanced_ei(n=200, stdp=True), 4, 4),
}
# added to the plastic net's bias column in both packages: at its own bias
# (14-16) it fires a handful of spikes in 50 steps, at +10 about 80 and
# changes about 400 weights
PLASTIC_DRIVE = 10.0
BUCKET_FIELDS = ("cols", "weights", "valid", "edge_index", "row_map")


def _reference_noise(net):
    sigma, n = float(net.meta["noise_sigma"]), net.n
    key = jax.random.PRNGKey(SEED)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


def _nets(case):
    make = CASES[case][0]
    nets = jnet.to_dcsr(make(jnet), k=1), tnet.to_dcsr(make(tnet), k=1)
    if case == "plastic":
        for d in nets:
            d.parts[0].vtx_state[:, LIF_BIAS] += PLASTIC_DRIVE
    return nets


def _cfgs(case, jkw=(), **kw):
    """The reference's and the port's config of a case (``jkw``: fields
    only the reference has, such as ``backend``)."""
    _, max_k, align_k = CASES[case]
    return (JSimConfig(max_k=max_k, align_k=align_k, **dict(jkw), **kw),
            SimConfig(max_k=max_k, align_k=align_k, **kw))


def _host(st):
    return {key: (np.asarray(st[key]) if key != "weights"
                  else [np.asarray(w) for w in st[key]])
            for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus", "weights")}


def _segment_sums(act, cols, weights, row_ptr):
    """One split bucket's row sums through ``ops.segment_gather_ring``: its
    ring add at t = 0, delay 0 into a zeroed one-row ring."""
    n_p = len(row_ptr) - 1
    ring = torch.zeros((1, n_p))
    plan = segment_plan([row_ptr], [cols.shape[1]], n_p, "cpu")
    ops.segment_gather_ring(act, ring, 0, [0], plan, [cols], [weights],
                            row_ptr=[torch.from_numpy(row_ptr)])
    return ring[0]


# -- the ELL and the plain segmented gather ---------------------------------

@pytest.mark.parametrize("max_k,align_k", [(16, 4), (64, 32), (None, 32)])
def test_build_delay_ell_max_k_matches_reference(max_k, align_k):
    jd, td = _nets("microcircuit")
    want = j_build_delay_ell(jd.parts[0], jd.n, align_k=align_k, max_k=max_k)
    got = build_delay_ell(td.parts[0], td.n, align_k=align_k, max_k=max_k)
    assert len(got.buckets) == len(want.buckets) >= 2
    assert any(not b.identity_rows for b in got.buckets) == (max_k is not None)
    for a, b in zip(got.buckets, want.buckets):
        assert (a.delay, a.identity_rows) == (b.delay, b.identity_rows)
        for f in BUCKET_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), f
    assert got.fill_factor == want.fill_factor


def test_one_heavy_row_split_matches_reference(rng):
    """The reference's ``test_ell_heavy_row_split`` case: half of 600
    edges hit row 0, which splits into virtual rows of 16."""
    n, m = 20, 600
    src = rng.integers(0, n, m)
    dst = np.zeros(m, dtype=np.int64)
    dst[m // 2:] = rng.integers(0, n, m - m // 2)
    edge_state = np.stack([rng.normal(size=m).astype(np.float32), np.ones(m, np.float32)], 1)
    from repro.core.dcsr import from_edges as j_from_edges

    jp = j_from_edges(n, src, dst, edge_state, k=1).parts[0]
    tp = from_edges(n, src, dst, edge_state, k=1).parts[0]
    want = j_build_delay_ell(jp, n, align_k=4, align_rows=4, max_k=16).buckets[0]
    got = build_delay_ell(tp, n, align_k=4, align_rows=4, max_k=16).buckets[0]
    assert not got.identity_rows and got.cols.shape[1] <= 16
    for f in BUCKET_FIELDS:
        assert getattr(got, f).tobytes() == getattr(want, f).tobytes(), f
    # the segmented gather re-reduces the virtual rows to the row sums
    from repro_torch.snn.simulator import split_row_ptr

    row_ptr = split_row_ptr(got.row_map, n)
    act = torch.from_numpy(rng.random(n).astype(np.float32))
    cur = _segment_sums(act, torch.from_numpy(got.cols), torch.from_numpy(got.weights), row_ptr)
    dense = np.zeros(n, np.float32)
    np.add.at(dense, dst, edge_state[:, 0] * act.numpy()[src])
    np.testing.assert_allclose(cur.numpy(), dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,n_rows,K,depth", [(50, 10, 8, 1), (300, 64, 16, 4), (1000, 200, 32, 9)])
def test_segment_ref_matches_reference_segment_sum(rng, n, n_rows, K, depth):
    counts = rng.integers(1, depth + 1, n_rows)
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    R = int(row_ptr[-1]) + 5  # padding virtual rows, mapped to row 0 as the builder maps them
    row_map = np.zeros(R, np.int32)
    row_map[: row_ptr[-1]] = np.repeat(np.arange(n_rows, dtype=np.int32), counts)
    cols = rng.integers(0, n, (R, K)).astype(np.int32)
    w = (rng.normal(size=(R, K)) * (rng.random((R, K)) < 0.7)).astype(np.float32)
    w[row_ptr[-1]:] = 0.0
    cols[row_ptr[-1]:] = 0
    act = (rng.random(n) < 0.3).astype(np.float32)
    want = jax.ops.segment_sum(jref.spike_gather_ref(jnp.asarray(act), jnp.asarray(cols),
                                                     jnp.asarray(w)),
                               jnp.asarray(row_map), num_segments=n_rows)
    args = [torch.from_numpy(a) for a in (act, cols, w, row_ptr)]
    got = ref.spike_gather_segment_ref(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert torch.equal(got, ref.spike_gather_segment_ref(*args, depth=int(counts.max())))
    assert torch.equal(got, _segment_sums(*args[:3], row_ptr))


# -- the engine against the reference ---------------------------------------

@pytest.fixture(scope="module", params=list(CASES))
def reference(request):
    case = request.param
    jd, td = _nets(case)
    jcfg, _ = _cfgs(case, jkw=dict(backend="ref"), record_raster=True)
    jsim = JSimulator(jd, jcfg)
    assert jsim.engine_choice.engine == "unfused"
    _, out_c = jsim.run(jsim.init_state(), STEPS)
    with jax.disable_jit():
        st_e, out_e = jsim.run(jsim.init_state(), STEPS)
    return dict(case=case, jd=jd, td=td, raster=np.asarray(out_c["raster"]),
                raster_eager=np.asarray(out_e["raster"]), eager=_host(st_e),
                w0=[np.asarray(w) for w in jsim.dev.weights0])


def test_max_k_session_matches_reference(reference):
    case, jd, td = reference["case"], reference["jd"], reference["td"]
    _, cfg = _cfgs(case)
    ses = Session(td, cfg, device="cpu", _noise_fn=_reference_noise(jd))
    dev = ses.simulator.dev
    assert ses.describe()["step_engine"] == "unfused"
    assert any(not x for x in dev.identity_rows)
    raster = RasterMonitor()
    ses.run(STEPS, monitors=[raster])
    assert reference["raster"].sum() > 0
    np.testing.assert_array_equal(raster.raster, reference["raster"])
    np.testing.assert_array_equal(raster.raster, reference["raster_eager"])
    got, want = _host(ses.state), reference["eager"]
    np.testing.assert_array_equal(got["hist"], want["hist"])
    for key in ("tr_plus", "tr_minus", "vtx_state", "ring"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-6, err_msg=key)
    changed = 0
    for a, b, w0 in zip(got["weights"], want["weights"], reference["w0"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        changed += int((a != w0).sum())
    assert (changed > 0) == (case == "plastic")


def test_fused_true_raises_the_reference_blocker():
    jd, td = _nets("microcircuit")
    jcfg, cfg = _cfgs("microcircuit", fused=True)
    with pytest.raises(ValueError) as want:
        JSimulator(jd, jcfg)
    with pytest.raises(ValueError) as got:
        Session(td, cfg, device="cpu")
    assert "heavy-row-split ELL needs the segment-sum re-reduction" in str(want.value)
    assert str(got.value) == str(want.value)


def test_k2_ignores_max_k_in_both_packages():
    """k > 1 builds whole rows whatever ``max_k`` says, in both packages:
    the reference's stacked panels and the port's k=2 run are the same
    with and without it."""
    make = CASES["microcircuit"][0]
    nets = [m.to_dcsr(make(m), assignment=block_partition(make(tnet).n, 2), uniform=True)
            for m in (jnet, tnet)]
    with_k, without = (JSimConfig(max_k=16, align_k=4), JSimConfig(align_k=4))
    a, b = jdist.stack_partitions(nets[0], with_k), jdist.stack_partitions(nets[0], without)
    assert a.identity_rows and b.identity_rows
    for x, y in zip(a.cols + a.weights, b.cols + b.weights):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()
    outs = []
    for cfg in (SimConfig(max_k=16, align_k=4), SimConfig(align_k=4)):
        dsim = DistSimulator(nets[1], cfg, devices=["cpu"] * 2)
        assert dsim.stacked.identity_rows
        st, out = dsim.run(dsim.init_state(), 30, record_raster=True)
        outs.append((st, out["raster"]))
    (sa, ra), (sb, rb) = outs
    assert int(ra.sum()) > 0 and torch.equal(ra, rb)
    for ca, cb in zip(sa, sb):
        for key in ("vtx_state", "ring", "hist"):
            assert torch.equal(ca[key], cb[key])


def test_snapshots_with_max_k_continue_in_both_packages(tmp_path):
    """A port snapshot and a reference snapshot, each taken at t=20 with
    ``max_k``, restored by both packages: each package continues its own
    file bit-equal to its live session, and all four continuations give
    one raster (the reference's noise injected into the port)."""
    jd, td = _nets("microcircuit")
    jcfg, cfg = _cfgs("microcircuit")
    noise = _reference_noise(jd)
    port = Session(td, cfg, device="cpu", _noise_fn=noise)
    port.run(20)
    port.save(str(tmp_path / "port"), wait=True)
    jses = JSession(jd, jcfg)
    jses.run(20)
    jses.save(str(tmp_path / "ref"))
    runs = {}
    for src in ("port", "ref"):
        p = Session.restore(str(tmp_path / src), cfg=cfg, device="cpu", _noise_fn=noise)
        assert p.t == 20 and any(not x for x in p.simulator.dev.identity_rows)
        mon = RasterMonitor()
        p.run(30, monitors=[mon])
        runs["port", src] = (mon.raster, _host(p.state))
        j = JSession.restore(str(tmp_path / src), cfg=jcfg)
        assert j.t == 20
        from repro.snn import monitors as jmon

        jm = jmon.RasterMonitor()
        j.run(30, monitors=[jm])
        runs["ref", src] = (jm.raster, _host(j.state))
    # each package continues its own file bit-equal to its live session
    port.run(30)
    jses.run(30)
    for pkg, live in (("port", _host(port.state)), ("ref", _host(jses.state))):
        got = runs[pkg, pkg][1]
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            assert np.array_equal(got[key], live[key]), (pkg, key)
    # and the four continuations (either package, either file) spike alike
    first = runs["port", "port"][0]
    assert first.sum() > 0
    for raster, _ in runs.values():
        np.testing.assert_array_equal(raster, first)


def test_supervised_rollback_with_max_k_stays_in_place(tmp_path):
    """A NaN after the third chunk of a supervised plastic run with
    ``max_k``: one rollback that keeps the engine (the split panels, their
    ``row_ptr`` and ``row_map``), and the raster, weights and traces of an
    undisturbed run."""
    _, td = _nets("plastic")
    _, cfg = _cfgs("plastic")
    ses = Session(td, cfg, device="cpu")
    sim = ses.simulator
    st0 = ses.state
    plain = RasterMonitor()
    ses.run(80, monitors=[plain], chunk_size=20)
    want = _host(ses.state)
    ses._state = st0
    calls = []

    def poison(site, state):
        calls.append(site)
        if len(calls) == 3:
            state["vtx_state"][5, 0] = float("nan")
        return state

    mon = RasterMonitor()
    with tio.state_fault_hook(poison), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = ses.run_supervised(80, monitors=[mon], chunk_size=20, checkpoint_every=40,
                                 checkpoint_dir=str(tmp_path))
    assert (res.rollbacks, res.steps_lost, res.t_final) == (1, 20, 80)
    assert ses.simulator is sim and ses.last_rollbacks[0]["in_place"]
    assert plain.raster.sum() > 0
    np.testing.assert_array_equal(mon.raster, plain.raster)
    got = _host(ses.state)
    for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for a, b in zip(got["weights"], want["weights"]):
        np.testing.assert_array_equal(a, b)
    ses.close()
