"""The port's ``Session`` against the reference ``Session`` on the CPU, and
the surfaces this slice leaves to later ones."""
import numpy as np
import pytest
import torch

from repro.snn import Session as JSession
from repro.snn import SimConfig as JSimConfig
from repro.snn import monitors as jmon
from repro.snn import network as jnet
from repro_torch.snn import (
    RasterMonitor, RateMonitor, Session, SimConfig, Simulator, VMeanMonitor,
)
from repro_torch.snn import network as tnet

STEPS = 100


def _noise_free(mod, k=1):
    d = mod.to_dcsr(mod.microcircuit(scale=0.01), k=k)
    d.meta["noise_sigma"] = 0.0
    return d


@pytest.fixture(scope="module")
def reference():
    ses = JSession(_noise_free(jnet), JSimConfig(align_k=32))
    rate, raster = jmon.RateMonitor(), jmon.RasterMonitor()
    res = ses.run(STEPS, monitors=[rate, raster])
    return ses.describe(), res, rate.rates, raster.raster


def test_session_matches_reference(reference):
    j_desc, j_res, j_rates, j_raster = reference
    ses = Session(_noise_free(tnet), SimConfig(align_k=32), device="cpu")
    rate, raster = RateMonitor(), RasterMonitor()
    res = ses.run(STEPS, monitors=[rate, raster])
    assert j_raster.sum() > 0
    np.testing.assert_array_equal(raster.raster, j_raster)
    np.testing.assert_array_equal(res.spike_count, j_res.spike_count)
    np.testing.assert_array_equal(rate.rates, j_rates)
    desc = ses.describe()
    for key in ("n", "m", "k", "source_k", "engine", "step_engine", "t", "gather", "overlap"):
        assert desc[key] == j_desc[key], key
    assert desc["ell_fill"] == pytest.approx(j_desc["ell_fill"])
    assert res.t_final == j_res.t_final == STEPS
    assert res.chunks == j_res.chunks


def test_k4_net_runs_merged(reference):
    _, _, _, j_raster = reference
    ses = Session(_noise_free(tnet, k=4), SimConfig(align_k=32), device="cpu")
    desc = ses.describe()
    assert (desc["k"], desc["source_k"], desc["engine"]) == (1, 4, "single")
    raster = RasterMonitor()
    ses.run(STEPS, monitors=[raster])
    np.testing.assert_array_equal(raster.raster[:, np.argsort(ses.permanent_ids)], j_raster)


@pytest.mark.parametrize("chunk_size", [7, 128])
def test_chunk_size_is_bit_transparent(chunk_size):
    d = tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=1)
    ses = Session(d, SimConfig(align_k=32, fused=True), device="cpu")
    raster, vmean = RasterMonitor(), VMeanMonitor()
    res = ses.run(60, monitors=[raster, vmean], chunk_size=chunk_size)
    whole = Session(d, SimConfig(align_k=32, fused=True), device="cpu")
    raster_w = RasterMonitor()
    whole.run(60, monitors=[raster_w], chunk_size=60)
    np.testing.assert_array_equal(raster.raster, raster_w.raster)
    for key in ("vtx_state", "ring", "hist"):
        assert torch.equal(ses.state[key], whole.state[key])
    assert sum(res.chunks) == 60 and vmean.v_mean.shape == (60,)
    # chunks after the first may take the event gather (gather="auto"):
    # the trajectory is the same either way
    assert ses.last_gather_modes[0] == "dense" and ses.t == 60
    assert ses.engine_choice.engine in ("fused", "fused_event")
    assert whole.last_gather_modes == ("dense",)


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Session(d)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulator(d)


@pytest.mark.parametrize("kw,match", [
    (dict(max_k=64), "heavy-row split"),
])
def test_unported_config_values_raise(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        SimConfig(**kw)


@pytest.mark.parametrize("kw", [dict(exchange="index"), dict(overlap="local")])
def test_k_gt_1_config_values_run(kw):
    """The k>1 engine's knobs construct since its slice; at k = 1 the
    exchange is the identity, so they change nothing, as in the reference."""
    d = tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=1)
    ses = Session(d, SimConfig(align_k=32, **kw), device="cpu")
    assert ses.describe()["overlap"] == "off"
    assert ses.run(5).overflow.sum() == 0


def test_config_checks_mirror_the_reference():
    with pytest.raises(ValueError, match="alignments"):
        SimConfig(align_k=0)
    with pytest.raises(ValueError, match="gather"):
        SimConfig(gather="sparse")
    with pytest.raises(ValueError, match="event_cap_frac"):
        SimConfig(event_cap_frac=0.0)
    with pytest.raises(TypeError):
        SimConfig(backend="cuda")  # the device decides the backend


def test_unported_session_surfaces_raise(tmp_path):
    d = tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=1)
    ses = Session(d, SimConfig(align_k=32), device="cpu")
    with pytest.raises(NotImplementedError, match="snapshots"):
        ses.save(str(tmp_path / "snap"))
    with pytest.raises(NotImplementedError, match="snapshots"):
        Session.restore(str(tmp_path / "snap"))
    with pytest.raises(NotImplementedError, match="snapshots"):
        ses.run(10, checkpoint_every=5)
    with pytest.raises(NotImplementedError, match="fault tolerance"):
        ses.run_supervised(10)
    with pytest.raises(NotImplementedError, match="snapshots"):
        Session(str(tmp_path), device="cpu")
    # plastic nets run since the plasticity slice
    plastic = Session(tnet.to_dcsr(tnet.balanced_ei(n=200, stdp=True), k=1), device="cpu")
    assert plastic.simulator.dev.any_plastic
    assert plastic.run(5).t_final == 5
    assert ses.t == 0


@pytest.mark.parametrize("runs", [
    ((150, 25),),  # the reference's own chunked run (tests/test_session.py:64)
    ((70, 20), (35, None)),  # an uneven last chunk, then the default chunk
])
def test_last_run_chunks_match_reference(runs):
    """``last_run_chunks`` is () before a run and, after each run, the
    chunk lengths it executed, as the reference's ``Session`` records them."""
    jses = JSession(_noise_free(jnet), JSimConfig(align_k=32))
    ses = Session(_noise_free(tnet), SimConfig(align_k=32), device="cpu")
    assert ses.last_run_chunks == jses.last_run_chunks == ()
    for steps, chunk in runs:
        j_res = jses.run(steps, chunk_size=chunk)
        res = ses.run(steps, chunk_size=chunk)
        assert ses.last_run_chunks == jses.last_run_chunks == res.chunks == j_res.chunks
        assert len(ses.last_gather_modes) == len(ses.last_run_chunks)
