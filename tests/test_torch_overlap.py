"""The port's exchange/compute overlap modes of the split engines, on the CPU.

The contract, as the reference's ``tests/test_overlap.py`` states it:

* the local and remote passes compose to the serialized post-exchange pass
  (within 1e-6: the split reorders the f32 sums), and the plastic remote
  pass gives the serialized pass's weights exactly (STDP is elementwise);
* end to end, ``overlap="local"`` gives ``"off"``'s raster, spike counts,
  overflow, traces and weights; ``"double_buffer"`` is bit-exact against
  ``"local"``, ring included, at any chunk size (the deferred remote pass
  is flushed at the end of every run);
* the selector resolves the mode: ``"auto"`` is ``"local"`` on ``cuda`` and
  ``"off"`` on ``ref``; an identity exchange has nothing to overlap.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import block_partition
from repro_torch.kernels import dispatch, ops
from repro_torch.snn import RasterMonitor, Session, SimConfig, Simulator
from repro_torch.snn import network as tnet

STDP = dict(a_plus=0.01, a_minus=0.012, w_min=-2.0, w_max=2.0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(rng, n_p=8, n=16, D=4, nd=2, R=8, K=8):
    cols = [_t(rng.integers(0, n, (R, K)).astype(np.int32)) for _ in range(nd)]
    w = [_t(rng.normal(size=(R, K)).astype(np.float32)) for _ in range(nd)]
    act = _t((rng.random(n) < 0.4).astype(np.float32))
    ring = _t(rng.normal(size=(D, n_p)).astype(np.float32))
    clear = _t((np.arange(D) != 1).astype(np.float32))
    oh = _t((rng.random((nd, D)) < 0.5).astype(np.float32))
    own = torch.zeros(n)
    own[n_p:] = act[n_p:]  # partition 1 owns [n_p, 2 n_p)
    rem = act.clone()
    rem[n_p:] = 0.0
    return cols, w, act, ring, clear, oh, own, rem


def test_local_plus_remote_composes_to_the_full_pass():
    cols, w, act, ring, clear, oh, own, rem = _case(np.random.default_rng(0))
    full = ops.fused_post_exchange(act, ring, clear, oh, cols, w)
    loc = ops.fused_post_exchange_local(own, ring, clear, oh, cols, w)
    both = ops.fused_post_exchange_remote(rem, loc, oh, cols, w)
    torch.testing.assert_close(both, full, rtol=0, atol=1e-6)


def test_remote_plastic_weights_equal_the_serialized_pass():
    rng = np.random.default_rng(1)
    cols, w, act, ring, clear, oh, own, rem = _case(rng)
    pre = _t(rng.random(16).astype(np.float32))
    post_t = _t(rng.random(8).astype(np.float32))
    post_s = _t((rng.random(8) < 0.3).astype(np.float32))
    pl = [_t((rng.random((8, 8)) < 0.5).astype(np.float32)) for _ in range(2)]
    ring_s, w_s = ops.fused_post_exchange_plastic(act, pre, ring, clear, oh, post_t, post_s,
                                                  cols, w, pl, stdp=STDP)
    loc = ops.fused_post_exchange_local(own, ring, clear, oh, cols, w)
    ring_o, w_o = ops.fused_post_exchange_remote_plastic(rem, act, pre, loc, oh, post_t,
                                                         post_s, cols, w, pl, stdp=STDP)
    torch.testing.assert_close(ring_o, ring_s, rtol=0, atol=1e-6)
    for a, b in zip(w_o, w_s):
        assert torch.equal(a, b)  # elementwise STDP: no tolerance


@pytest.mark.parametrize("backend,identity,overlap,fused,want", [
    ("cuda", False, "auto", None, "local"),
    ("ref", False, "auto", True, "off"),
    ("cuda", True, "auto", None, "off"),
    ("cuda", False, "double_buffer", None, "double_buffer"),
    ("ref", False, "local", True, "local"),
    ("cuda", True, "local", None, "off"),  # nothing to overlap: falls back
])
def test_overlap_resolution(backend, identity, overlap, fused, want):
    c = dispatch.select_step_engine(
        backend=backend, models_present=("lif",), identity_rows=True, n_delay_buckets=2,
        identity_exchange=identity, n_global=64, fused=fused, overlap=overlap,
    )
    assert c.overlap == want
    assert c.split == (not identity)
    assert c.engine in dispatch.STEP_ENGINES and c.engine == ("fused" if identity else "fused_split")


def test_identity_exchange_refuses_a_forced_overlap():
    with pytest.raises(ValueError, match="no collective to overlap"):
        dispatch.select_step_engine(
            backend="cuda", models_present=("lif",), identity_rows=True, n_delay_buckets=2,
            fused=True, overlap="local",
        )
    d = tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=1)
    sim = Simulator(d, SimConfig(align_k=32, overlap="double_buffer"), device="cpu")
    assert sim.engine_choice.overlap == "off"
    with pytest.raises(ValueError, match="no collective to overlap"):
        Simulator(d, SimConfig(align_k=32, overlap="local", fused=True), device="cpu")


def test_selector_variants_for_the_split_placement():
    kw = dict(backend="cuda", models_present=("lif",), identity_rows=True,
              n_delay_buckets=3, identity_exchange=False, n_global=400)
    assert dispatch.select_step_engine(**kw).engine == "fused_split"
    assert dispatch.select_step_engine(**kw, any_plastic=True).engine == "fused_split_plastic"
    assert dispatch.select_step_engine(**kw, gather="event").engine == "fused_split_event"
    c = dispatch.select_step_engine(**kw, any_plastic=True, gather="event")
    assert c.engine == "fused_split_plastic" and "event gather unavailable" in c.reason
    assert c.plastic and c.split and not c.event
    with pytest.raises(ValueError, match="event-driven gather requested"):
        dispatch.select_step_engine(**kw, any_plastic=True, gather="event", fused=True)
    assert dispatch.select_step_engine(**dict(kw, backend="ref")).engine == "unfused"


def _net(kind, k):
    if kind == "plastic":
        net = tnet.balanced_ei(160, stdp=True, seed=7, delay_steps=5)
        net.vtx_state[:, 2] += 6.0
    else:
        net = tnet.spatial_random(240, avg_degree=10, seed=4)
        net.vtx_state[:, 2] += 50.0
    return tnet.to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)


def _run(d, k, chunk, **kw):
    ses = Session(d, SimConfig(align_k=8, fused=True, **kw), engine="spmd", devices=["cpu"] * k)
    raster = RasterMonitor()
    res = ses.run(60, monitors=[raster], chunk_size=chunk)
    assert all("_pending" not in c for c in ses.state)
    return ses, raster.raster, res


@pytest.mark.parametrize("chunk", [1, 7, 64])
@pytest.mark.parametrize("kind,k,exchange,gather", [
    ("plain", 4, "index", "dense"),
    ("plain", 2, "dense", "event"),
    ("plastic", 4, "dense", "dense"),
    ("plastic", 2, "index", "dense"),
])
def test_overlap_modes_agree(kind, k, exchange, gather, chunk):
    d = _net(kind, k)
    runs = {ov: _run(d, k, chunk, exchange=exchange, gather=gather, overlap=ov)
            for ov in ("off", "local", "double_buffer")}
    ses_off, r_off, res_off = runs["off"]
    assert r_off.sum() > 20 and ses_off.engine_choice.overlap == "off"
    for ov in ("local", "double_buffer"):
        ses, r, res = runs[ov]
        assert ses.engine_choice.overlap == ov
        np.testing.assert_array_equal(r, r_off)
        np.testing.assert_array_equal(res.overflow, res_off.overflow)
        for a, b in zip(ses.state, ses_off.state):
            for name in ("tr_plus", "tr_minus", "hist"):
                assert torch.equal(a[name], b[name]), name
            for wa, wb in zip(a["weights"], b["weights"]):
                assert torch.equal(wa, wb)
    # double_buffer replays local's per-slot add sequence: ring and all
    for a, b in zip(runs["double_buffer"][0].state, runs["local"][0].state):
        for name in ("ring", "vtx_state"):
            assert torch.equal(a[name], b[name]), name


def test_overlap_sub_panels_only_for_non_plastic_nets():
    d = _net("plain", 2)
    sim = Session(d, SimConfig(align_k=8, fused=True, overlap="local"), engine="spmd",
                  devices=["cpu"] * 2).simulator
    assert all(dv.cols_local is not None and dv.cols_remote is not None for dv in sim.devs)
    n_p = sim.stacked.n_p
    assert all(int(c.max()) < n_p for dv in sim.devs for c in dv.cols_local)
    sim_p = Session(_net("plastic", 2), SimConfig(align_k=8, fused=True, overlap="local"),
                    engine="spmd", devices=["cpu"] * 2).simulator
    assert all(dv.cols_local is None for dv in sim_p.devs)
    assert sim_p.engine_choice.engine == "fused_split_plastic"


@pytest.mark.parametrize("kind", ["plain", "plastic"])
def test_engines_on_a_shared_build_agree(kind):
    """``Session(..., _share=base)`` runs another engine on ``base``'s panels
    (no second host build) and gives ``base``'s raster, traces and weights;
    the shared panels stay as they were."""
    d = _net(kind, 4)
    base, r_base, _ = _run(d, 4, 16, overlap="local")
    w0 = [w.clone() for dv in base.simulator.devs for w in dv.weights0]
    for kw in (dict(overlap="off"), dict(overlap="double_buffer"), dict(fused=False)):
        ses = Session(d, SimConfig(align_k=8, fused=kw.pop("fused", True), **kw),
                      engine="spmd", devices=["cpu"] * 4, _share=base)
        assert ses.simulator.devs is base.simulator.devs
        assert ses.simulator.stacked is base.simulator.stacked
        raster = RasterMonitor()
        ses.run(60, monitors=[raster], chunk_size=16)
        np.testing.assert_array_equal(raster.raster, r_base)
        for a, b in zip(ses.state, base.state):
            for name in ("tr_plus", "tr_minus", "hist"):
                assert torch.equal(a[name], b[name]), name
            for wa, wb in zip(a["weights"], b["weights"]):
                assert torch.equal(wa, wb)
    assert all(torch.equal(a, b) for a, b in
               zip(w0, [w for dv in base.simulator.devs for w in dv.weights0]))
    with pytest.raises(ValueError, match="_share needs"):
        Session(_net(kind, 4), SimConfig(align_k=8), engine="spmd", devices=["cpu"] * 4,
                _share=base)
