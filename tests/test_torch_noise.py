"""The port's k=1 ``Simulator`` with the reference's own noise injected, and
teacher-forced from a mid-run reference carry, on the CPU; and the port's
own noise and engines held against each other.

torch cannot reproduce ``jax.random.normal``, so the reference's per-step
noise ``sigma * normal(fold_in(PRNGKey(seed), t), (n,))`` is computed with
JAX and handed to the port through ``Simulator``'s ``_noise_fn`` seam.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.snn import SimConfig as JSimConfig
from repro.snn import network as jnet
from repro.snn.simulator import Simulator as JSimulator
from repro_torch import convert
from repro_torch.snn import SimConfig, Simulator
from repro_torch.snn import network as tnet

SEED = 42  # SimConfig's default noise seed, in both packages


def _reference_noise(net):
    sigma, n = float(net.meta["noise_sigma"]), net.n
    key = jax.random.PRNGKey(SEED)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


@pytest.fixture(scope="module")
def nets():
    return (
        jnet.to_dcsr(jnet.microcircuit(scale=0.01), k=1),
        tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=1),
    )


@pytest.mark.parametrize("fused", [False, True])
def test_injected_reference_noise_gives_equal_rasters(nets, fused):
    jd, td = nets
    steps = 50
    jsim = JSimulator(jd, JSimConfig(align_k=32, backend="ref", record_raster=True))
    _, jout = jsim.run(jsim.init_state(), steps)
    sim = Simulator(
        td, SimConfig(align_k=32, record_raster=True, fused=fused),
        device="cpu", _noise_fn=_reference_noise(jd),
    )
    _, out = sim.run(sim.init_state(), steps)
    assert np.asarray(jout["raster"]).sum() > 0
    np.testing.assert_array_equal(out["raster"].numpy(), np.asarray(jout["raster"]))


@pytest.mark.parametrize("fused", [False, True])
def test_teacher_forced_step_from_reference_carry(nets, fused):
    jd, td = nets
    jsim = JSimulator(jd, JSimConfig(align_k=32, backend="ref", record_raster=True))
    st20, _ = jsim.run(jsim.init_state(), 20)
    st21, jout = jsim.run(st20, 1)
    carry = convert.carry_from_arrays(
        t=int(st20["t"]), vtx_state=np.asarray(st20["vtx_state"]),
        ring=np.asarray(st20["ring"]), hist=np.asarray(st20["hist"]),
        weights=[np.asarray(w) for w in st20["weights"]],
        tr_plus=np.asarray(st20["tr_plus"]), tr_minus=np.asarray(st20["tr_minus"]),
        device="cpu",
    )
    sim = Simulator(
        td, SimConfig(align_k=32, record_raster=True, fused=fused),
        device="cpu", _noise_fn=_reference_noise(jd),
    )
    st, out = sim.run(carry, 1)
    assert st["t"] == 21
    np.testing.assert_array_equal(out["raster"].numpy(), np.asarray(jout["raster"]))
    # f32 gather sums in another order: ring within 1e-5
    np.testing.assert_allclose(
        st["ring"].numpy(), np.asarray(st21["ring"]), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_array_equal(st["hist"].numpy(), np.asarray(st21["hist"]))


def test_port_noise_fused_and_unfused_identical(nets):
    _, td = nets
    runs = []
    for fused in (True, False):
        sim = Simulator(td, SimConfig(align_k=32, record_raster=True, fused=fused), device="cpu")
        runs.append(sim.run(sim.init_state(), 100))
    (st_f, out_f), (st_u, out_u) = runs
    assert out_f["spike_count"].sum() > 0
    assert torch.equal(out_f["raster"], out_u["raster"])
    assert torch.equal(st_f["vtx_state"], st_u["vtx_state"])
    assert torch.equal(st_f["ring"], st_u["ring"])


def test_port_noise_is_a_function_of_seed_step_and_permanent_id(nets):
    _, td = nets
    def run(net, seed=SEED):
        sim = Simulator(net, SimConfig(align_k=32, seed=seed), device="cpu")
        return sim.run(sim.init_state(), 30)[0]["vtx_state"]

    a = run(td)
    assert torch.equal(a, run(td))
    assert not torch.equal(a, run(td, seed=7))
    # the same neurons through a 4-way block partition, merged back
    from repro_torch.core import merge_to_single

    merged = merge_to_single(tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=4))
    assert torch.equal(a, run(merged))


def test_chunked_runs_are_bit_identical(nets):
    _, td = nets
    sim = Simulator(td, SimConfig(align_k=32, record_raster=True), device="cpu")
    st_a, out_a = sim.run(sim.init_state(), 60)
    st, rasters = sim.init_state(), []
    for c in (7, 7, 7, 39):
        st, out = sim.run(st, c)
        rasters.append(out["raster"])
    assert torch.equal(out_a["raster"], torch.cat(rasters))
    for k in ("vtx_state", "ring", "hist"):
        assert torch.equal(st_a[k], st[k])
