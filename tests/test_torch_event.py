"""The port's event-driven gather against the reference's, on the CPU.

The same numpy inputs go through ``repro.kernels.event_step`` (touch
bitmaps, ``event_select``), ``repro.kernels.ops.event_post_exchange`` with
``backend="ref"`` and ``backend="pallas_interpret"``, and the port's
``repro_torch.kernels.event_step`` plain versions.  At the simulator and
session level the port's ``fused_event`` engine and the ``gather="auto"``
switch are held against the reference's rasters and the port's dense
engine.  Tolerances are stated per test.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import event_step as jev
from repro.kernels import ops as jops
from repro.snn import SimConfig as JSimConfig
from repro.snn import network as jnet
from repro.snn.simulator import Simulator as JSimulator
from repro_torch.kernels import event_step as tev
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dispatch import EVENT_ACTIVITY_THRESHOLD
from repro_torch.snn import RasterMonitor, Session, SimConfig, Simulator
from repro_torch.snn import network as tnet


def _panels(rng, n, R, ks, fill=0.6):
    """Per-bucket (R, K) cols/weights/valid with the ELL layout invariant:
    padding slots hold col 0 and weight 0."""
    cols, weights, valid = [], [], []
    for K in ks:
        v = rng.random((R, K)) < fill
        c = np.where(v, rng.integers(0, n, (R, K)), 0).astype(np.int32)
        w = np.where(v, rng.normal(size=(R, K)), 0.0).astype(np.float32)
        cols.append(c)
        weights.append(w)
        valid.append(v)
    return cols, weights, valid


@pytest.mark.parametrize("n,R,ks,block_r", [
    (64, 64, (16,), 8),
    (100, 104, (8, 24), 8),
    (300, 320, (4, 12, 20), 32),
    (500, 512, (32, 64), 128),
])
def test_touch_masks_byte_identical_to_reference(rng, n, R, ks, block_r):
    cols, _, valid = _panels(rng, n, R, ks)
    nb = R // block_r
    got = tev.build_touch_masks(cols, valid, n, nb, block_r)
    want = jev.build_touch_masks(cols, valid, n, nb, block_r)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_touch_masks_take_a_partial_last_block(rng):
    cols, _, valid = _panels(rng, 50, 100, (8,))
    block_r, nb = tev.event_block_geometry(100, 32)
    assert (block_r, nb) == (32, 4)
    (m,) = tev.build_touch_masks(cols, valid, 50, nb, block_r)
    for b in range(nb):
        rows = slice(b * block_r, (b + 1) * block_r)
        want = np.zeros(50, np.uint8)
        want[cols[0][rows][valid[0][rows]]] = 1
        np.testing.assert_array_equal(m[b], want)


@pytest.mark.parametrize("p_active,cap", [
    (0.0, 32), (0.01, 32), (0.05, 64), (0.3, 32),  # the last overflows
])
def test_event_select_flags_match_reference(rng, p_active, cap):
    n, R, block_r = 400, 400, 16
    cols, _, valid = _panels(rng, n, R, (8, 24), fill=0.3)
    nb = R // block_r
    masks = jev.build_touch_masks(cols, valid, n, nb, block_r)
    act = (rng.random(n) < p_active).astype(np.float32)
    _, want = jev.event_select(jnp.asarray(act), [jnp.asarray(m) for m in masks], cap)
    got = tev.event_select_plain(
        torch.from_numpy(act), torch.from_numpy(np.stack(masks)), cap
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if act.sum() > cap:
        assert got.numpy().all()


@pytest.mark.parametrize("n_p,R,ks,block_r,p_active", [
    (64, 64, (16,), 16, 0.02),
    (100, 104, (8, 24), 8, 0.05),
    (250, 256, (4, 12, 20), 32, 0.01),
    (250, 256, (16, 32), 64, 0.0),
])
def test_event_post_exchange_matches_reference(rng, n_p, R, ks, block_r, p_active):
    D, t = 16, 21
    cols, weights, valid = _panels(rng, n_p, R, ks, fill=0.2)
    delays = [2 + 3 * i for i in range(len(ks))]
    nb = R // block_r
    masks = jev.build_touch_masks(cols, valid, n_p, nb, block_r)
    act = (rng.random(n_p) < p_active).astype(np.float32)
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    slot, cap = t % D, 32
    write = [(t + d) % D for d in delays]
    sel, flags = jev.event_select(jnp.asarray(act), [jnp.asarray(m) for m in masks], cap)
    clear = (np.arange(D) != slot).astype(np.float32)
    onehot = (np.asarray(write)[:, None] == np.arange(D)[None, :]).astype(np.float32)

    plan = tev.EventPlan(block_r, nb, cap, torch.from_numpy(np.stack(masks)))
    got_ring = torch.from_numpy(ring.copy())
    got_flags = ops.event_post_exchange(
        torch.from_numpy(act), got_ring, slot, write, plan,
        [torch.from_numpy(c) for c in cols], [torch.from_numpy(w) for w in weights],
    )
    np.testing.assert_array_equal(got_flags.numpy(), np.asarray(flags))
    for backend in ("ref", "pallas_interpret"):
        want = jops.event_post_exchange(
            jnp.asarray(act), jnp.asarray(ring), jnp.asarray(clear),
            jnp.asarray(onehot), sel, flags,
            [jnp.asarray(c) for c in cols], [jnp.asarray(w) for w in weights],
            backend=backend,
        )
        # f32 sums in another order: rtol=atol=1e-5
        np.testing.assert_allclose(got_ring.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_event_ring_equals_the_dense_ring_bit_for_bit(rng):
    """Within the port: the event update equals clear + dense gather-add on
    every row (unflagged rows differ by a signed zero at most)."""
    n_p, R, D, t = 300, 304, 12, 7
    cols, weights, valid = _panels(rng, n_p, R, (8, 16, 24), fill=0.05)
    delays = (1, 4, 12)
    plan = tev.EventPlan.build(cols, valid, n_p, 64, "cpu", block_r=16)
    act = torch.from_numpy((rng.random(n_p) < 0.02).astype(np.float32))
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32))
    tc = [torch.from_numpy(c) for c in cols]
    tw = [torch.from_numpy(w) for w in weights]
    event = ring.clone()
    flags = ops.event_post_exchange(act, event, t % D, [(t + d) % D for d in delays],
                                    plan, tc, tw)
    assert 0 < int(flags.sum()) < flags.numel()  # some blocks are skipped
    dense = ring.clone()
    dense[t % D] = 0.0
    for c, w, d in zip(tc, tw, delays):
        dense[(t + d) % D] += ref.spike_gather_ref(act, c, w)[:n_p]
    assert torch.equal(event, dense)


def _nets(name):
    fn, kw = {
        "microcircuit": ("microcircuit", dict(scale=0.01)),
        "balanced_ei": ("balanced_ei", dict(n=500, stdp=False)),
    }[name]
    jd = jnet.to_dcsr(getattr(jnet, fn)(**kw), k=1)
    td = tnet.to_dcsr(getattr(tnet, fn)(**kw), k=1)
    jd.meta["noise_sigma"] = 0.0
    td.meta["noise_sigma"] = 0.0
    return jd, td


@pytest.mark.parametrize("name", ["microcircuit", "balanced_ei"])
def test_event_engine_matches_reference_simulator(name):
    jd, td = _nets(name)
    jsim = JSimulator(jd, JSimConfig(align_k=32, backend="ref", record_raster=True))
    _, jout = jsim.run(jsim.init_state(), 50)
    sim = Simulator(td, SimConfig(align_k=32, record_raster=True, fused=True,
                                  gather="event"), device="cpu")
    assert sim.engine_choice.engine == "fused_event" and sim.event_capable
    _, out = sim.run(sim.init_state(), 50)
    assert np.asarray(jout["raster"]).sum() > 0
    np.testing.assert_array_equal(out["raster"].numpy(), np.asarray(jout["raster"]))
    np.testing.assert_array_equal(
        out["spike_count"].numpy(), np.asarray(jout["spike_count"]).astype(np.int32)
    )


def test_auto_gather_switches_on_the_spike_rate():
    _, td = _nets("microcircuit")
    rasters, modes = {}, {}
    for gather in ("dense", "auto"):
        ses = Session(td, SimConfig(align_k=32, fused=True, gather=gather), device="cpu")
        mon = RasterMonitor()
        res = ses.run(120, monitors=[mon], chunk_size=30)
        rasters[gather], modes[gather] = mon.raster, ses.last_gather_modes
        rates = res.spike_count.reshape(4, 30).mean(axis=1) / td.n
    assert modes["dense"] == ("dense",) * 4
    # the first chunk is dense; each later one follows the running mean
    ema, want = None, ["dense"]
    for r in rates[:-1]:
        ema = r if ema is None else 0.5 * ema + 0.5 * r
        want.append("event" if ema < EVENT_ACTIVITY_THRESHOLD else "dense")
    assert modes["auto"] == tuple(want) and "event" in want
    assert rasters["dense"].sum() > 0
    np.testing.assert_array_equal(rasters["auto"], rasters["dense"])


def test_auto_gather_stays_dense_without_an_event_engine():
    """On the 'ref' backend the default engine is unfused, which has no
    event variant: the reference does not switch there either."""
    _, td = _nets("microcircuit")
    ses = Session(td, SimConfig(align_k=32), device="cpu")
    ses.run(60, chunk_size=20)
    assert ses.last_gather_modes == ("dense",) * 3
    assert ses.engine_choice.engine == "unfused" and ses.describe()["gather"] == "dense"
