"""The port's k=1 ``Simulator`` against the reference ``Simulator`` on the
same noise-free networks, on the CPU.

The reference runs with ``backend="ref"``, as its own tests run it, once
compiled (``sim.run`` under ``jit``) and once op by op
(``jax.disable_jit()``).  Rasters and spike counts must equal both.  The
membrane state is held to 1e-5 against the op-by-op run: compiled, XLA
contracts the LIF arithmetic into fused multiply-adds, which the port
forbids on the card, so the compiled run drifts from the port by a few ulps
a step.
"""
import jax
import numpy as np
import pytest
import torch

from repro.snn import SimConfig as JSimConfig
from repro.snn import network as jnet
from repro.snn.simulator import Simulator as JSimulator
from repro_torch.snn import SimConfig, Simulator
from repro_torch.snn import network as tnet

STEPS = 50

NETS = {
    "microcircuit": ("microcircuit", dict(scale=0.01)),
    "balanced_ei": ("balanced_ei", dict(n=500, stdp=False)),
}


def _nets(name):
    fn, kw = NETS[name]
    jd = jnet.to_dcsr(getattr(jnet, fn)(**kw), k=1)
    td = tnet.to_dcsr(getattr(tnet, fn)(**kw), k=1)
    jd.meta["noise_sigma"] = 0.0
    td.meta["noise_sigma"] = 0.0
    return jd, td


@pytest.fixture(scope="module", params=sorted(NETS))
def case(request):
    jd, td = _nets(request.param)
    sim = JSimulator(jd, JSimConfig(align_k=32, backend="ref", record_raster=True))
    _, out = sim.run(sim.init_state(), STEPS)
    with jax.disable_jit():
        st_e, out_e = sim.run(sim.init_state(), STEPS)
    ref = dict(
        raster=np.asarray(out["raster"]),
        spike_count=np.asarray(out["spike_count"]).astype(np.int32),
        raster_eager=np.asarray(out_e["raster"]),
        vtx_state=np.asarray(st_e["vtx_state"]),
        ring=np.asarray(st_e["ring"]),
        hist=np.asarray(st_e["hist"]),
    )
    return request.param, td, ref


@pytest.mark.parametrize("fused", [None, True, False])
def test_simulator_matches_reference_noise_free(case, fused):
    name, td, ref = case
    sim = Simulator(
        td, SimConfig(align_k=32, record_raster=True, fused=fused), device="cpu"
    )
    want = "unfused" if fused is None else ("fused" if fused else "unfused")
    assert sim.engine_choice.engine == want
    st, out = sim.run(sim.init_state(), STEPS)
    raster = out["raster"].numpy()
    assert ref["raster"].sum() > 0, f"{name}: no spikes to compare"
    np.testing.assert_array_equal(raster, ref["raster"])
    np.testing.assert_array_equal(raster, ref["raster_eager"])
    np.testing.assert_array_equal(out["spike_count"].numpy(), ref["spike_count"])
    assert st["t"] == STEPS
    np.testing.assert_allclose(
        st["vtx_state"].numpy(), ref["vtx_state"], rtol=1e-5, atol=1e-5
    )
    # f32 gather sums in another order: ring within 1e-5
    np.testing.assert_allclose(st["ring"].numpy(), ref["ring"], rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(st["hist"].numpy(), ref["hist"])


def test_run_leaves_the_callers_state_alone():
    _, td = _nets("microcircuit")
    sim = Simulator(td, SimConfig(align_k=32), device="cpu")
    st0 = sim.init_state()
    copy = {k: st0[k].clone() for k in ("vtx_state", "ring", "hist")}
    sim.run(st0, 5)
    assert st0["t"] == 0
    for k, v in copy.items():
        assert torch.equal(st0[k], v)
    # on a plastic net the weights and traces change too: neither the
    # caller's state nor the initial weights may, with either engine, and
    # two runs from init_state() give the same bits
    plastic = tnet.to_dcsr(tnet.balanced_ei(n=400, stdp=True), k=1)
    for fused in (True, False):
        sim = Simulator(plastic, SimConfig(align_k=32, fused=fused), device="cpu")
        st0 = sim.init_state()
        keys = ("vtx_state", "ring", "hist", "tr_plus", "tr_minus")
        copy = {k: st0[k].clone() for k in keys}
        w0 = [w.clone() for w in sim.dev.weights0]
        runs = [sim.run(st0, 60)[0], sim.run(sim.init_state(), 60)[0]]
        assert any(not torch.equal(a, b) for a, b in zip(runs[0]["weights"], w0))
        for k, v in copy.items():
            assert torch.equal(st0[k], v), k
        for a, b, c in zip(st0["weights"], sim.dev.weights0, w0):
            assert torch.equal(a, c) and torch.equal(b, c)
        for k in keys:
            assert torch.equal(runs[0][k], runs[1][k]), k
        for a, b in zip(runs[0]["weights"], runs[1]["weights"]):
            assert torch.equal(a, b)


def test_state_to_dcsr_and_runtime_state():
    _, td = _nets("microcircuit")
    sim = Simulator(td, SimConfig(align_k=32), device="cpu")
    w_before = td.parts[0].edge_state.copy()
    st, _ = sim.run(sim.init_state(), 10)
    sim.state_to_dcsr(st)
    np.testing.assert_array_equal(td.parts[0].vtx_state, st["vtx_state"].numpy())
    np.testing.assert_array_equal(td.parts[0].edge_state, w_before)
    rt = sim.runtime_state(st)
    assert sorted(rt[0]) == ["hist", "ring", "tr_minus", "tr_plus"]
    assert rt[0]["ring"].shape == (sim.d_ring, td.n)
