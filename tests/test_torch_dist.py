"""The port's k>1 engine against the reference's, on the CPU.

Kernel level: the port's plain split-step versions (``fused_pre_exchange``,
``fused_post_exchange`` and its local/remote passes, the two plastic
post-exchange passes, the event gather over an ``(n_global,)`` activity
with no clear) against ``repro.kernels.ref`` and against
``backend="pallas_interpret"`` (the TPU kernel bodies in interpret mode).
Host level: ``stack_partitions`` and ``split_overlap_panels`` against the
reference's, array for array.

Engine level: the port's ``DistSimulator`` on ``devices=["cpu"] * k`` with
``fused=True`` (the split engines' plain versions) against the reference
``DistSimulator`` over k fake host devices, run once in a subprocess
(``helpers.run_with_devices``) for k in {2, 4}, exchange in {dense, index},
plain and plastic nets, noise-free.  Rasters, spike counts and overflow
must be equal; ``vtx_state``, traces and weights within 1e-4, the
reference's own tolerance for its jitted drift (``test_dist_sim.py:34``).
Within the port, exactly: split engines == k>1 ``unfused`` == the k=1 run
of ``merge_to_single``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import run_with_devices
from repro.kernels import event_step as jev
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.snn import SimConfig as JSimConfig
from repro.snn import dist_sim as jdist
from repro.snn import network as jnet
from repro_torch import convert
from repro_torch.core import block_partition, merge_to_single
from repro_torch.kernels import event_step as tev
from repro_torch.kernels import ops, ref
from repro_torch.snn import DistSimulator, RasterMonitor, Session, SimConfig
from repro_torch.snn import dist_sim as tdist
from repro_torch.snn import network as tnet

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)
STDP = dict(a_plus=0.01, a_minus=0.012, w_min=-2.0, w_max=2.0)
TAUS = (20.0, 15.0)
STEPS = 40


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# -- kernel level ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 37, 1000])
def test_pre_exchange_plain_matches_reference(rng, n):
    v = (-66.0 + 20.0 * rng.random(n)).astype(np.float32)
    refrac = rng.integers(0, 3, n).astype(np.float32)
    i = (30.0 * rng.random(n)).astype(np.float32)
    tp, tm = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    args = (v, refrac, i, tp, tm)
    got = [x.numpy() for x in ops.fused_pre_exchange(
        *map(_t, args), params=LIF_PARAMS, taus=TAUS)]
    with jax.disable_jit():  # op by op: the plain version's rounding, exactly
        oracle = jref.fused_pre_exchange_ref(*map(_j, args), params=LIF_PARAMS, taus=TAUS)
    for a, b in zip(got, oracle):
        np.testing.assert_array_equal(a, np.asarray(b))
    interp = jops.fused_pre_exchange(*map(_j, args), params=LIF_PARAMS, taus=TAUS,
                                     backend="pallas_interpret")
    # the interpret kernel is compiled: v and the traces within 1e-6
    for a, b in zip(got, interp):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)
    # the trace-free variant is lif_step
    three = ops.fused_pre_exchange(*map(_t, args[:3]), params=LIF_PARAMS)
    assert len(three) == 3 and all(np.array_equal(a.numpy(), b) for a, b in zip(three, got))


def _post_case(rng, n_p, n, D, R, ks, fill=0.6):
    cols, weights = [], []
    for K in ks:
        v = rng.random((R, K)) < fill
        cols.append(np.where(v, rng.integers(0, n, (R, K)), 0).astype(np.int32))
        w = np.where(v, rng.normal(size=(R, K)), 0.0).astype(np.float32)
        w[n_p:] = 0.0
        weights.append(w)
    act = (rng.random(n) < 0.3).astype(np.float32)
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    slot, delays = 2, [1 + 2 * i for i in range(len(ks))]
    clear = (np.arange(D) != slot).astype(np.float32)
    onehot = (((slot + np.asarray(delays)) % D)[:, None] == np.arange(D)[None, :]).astype(np.float32)
    return act, ring, clear, onehot, cols, weights


@pytest.mark.parametrize("variant", ["full", "local", "remote"])
def test_post_exchange_plain_matches_reference(rng, variant):
    n_p, D, R = 16, 5, 16
    n = n_p if variant == "local" else 4 * n_p
    act, ring, clear, onehot, cols, weights = _post_case(rng, n_p, n, D, R, (8, 16, 24))
    tc, tw, jc, jw = [_t(c) for c in cols], [_t(w) for w in weights], \
        [_j(c) for c in cols], [_j(w) for w in weights]
    if variant == "remote":
        got = ops.fused_post_exchange_remote(_t(act), _t(ring), _t(onehot), tc, tw)
        want = [jref.fused_post_exchange_remote_ref(_j(act), _j(ring), _j(onehot), jc, jw)]
        want.append(jops.fused_post_exchange_remote(_j(act), _j(ring), _j(onehot), jc, jw,
                                                    backend="pallas_interpret"))
    else:
        op = ops.fused_post_exchange_local if variant == "local" else ops.fused_post_exchange
        jop = (jops.fused_post_exchange_local if variant == "local"
               else jops.fused_post_exchange)
        got = op(_t(act), _t(ring), _t(clear), _t(onehot), tc, tw)
        want = [jref.fused_post_exchange_ref(_j(act), _j(ring), _j(clear), _j(onehot), jc, jw),
                jop(_j(act), _j(ring), _j(clear), _j(onehot), jc, jw,
                    backend="pallas_interpret")]
    for w in want:
        # f32 sums in another order: rtol=atol=1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    # out= writes the same ring in place
    out = _t(ring).clone()
    if variant == "remote":
        ops.fused_post_exchange_remote(_t(act), out, _t(onehot), tc, tw, out=out)
    else:
        op(_t(act), out, _t(clear), _t(onehot), tc, tw, out=out)
    assert torch.equal(out, got)


def test_post_exchange_ring_is_the_dense_engines_ring():
    """Within the port: the mask-multiply ring equals clear + per-bucket
    gather-adds, the k=1 engines' formulation, up to signed zeros."""
    rng = np.random.default_rng(3)
    n_p, D = 24, 6
    act, ring, clear, onehot, cols, weights = _post_case(rng, n_p, 96, D, 24, (8, 16))
    tc, tw = [_t(c) for c in cols], [_t(w) for w in weights]
    got = ops.fused_post_exchange(_t(act), _t(ring), _t(clear), _t(onehot), tc, tw)
    dense = _t(ring).clone()
    dense[2] = 0.0
    for c, w, oh in zip(tc, tw, onehot):
        dense[int(oh.argmax())] += ref.spike_gather_ref(_t(act), c, w)[:n_p]
    assert torch.equal(got, dense)


@pytest.mark.parametrize("variant", ["serial", "remote"])
def test_post_exchange_plastic_plain_matches_reference(rng, variant):
    n_p, n, D, R = 16, 64, 4, 16
    act, ring, clear, onehot, cols, weights = _post_case(rng, n_p, n, D, R, (8, 16))
    pre = rng.random(n).astype(np.float32)
    post_t = rng.random(n_p).astype(np.float32)
    post_s = (rng.random(n_p) < 0.3).astype(np.float32)
    pl = [(rng.random(c.shape) < 0.5).astype(np.float32) for c in cols]
    act_remote = act.copy()
    act_remote[16:32] = 0.0  # the own slice of partition 1
    T = [[_t(a) for a in group] for group in (cols, weights, pl)]
    J = [[_j(a) for a in group] for group in (cols, weights, pl)]
    if variant == "serial":
        got = ops.fused_post_exchange_plastic(
            _t(act), _t(pre), _t(ring), _t(clear), _t(onehot), _t(post_t), _t(post_s),
            *T, stdp=STDP)
        jargs = (_j(act), _j(pre), _j(ring), _j(clear), _j(onehot), _j(post_t), _j(post_s), *J)
        with jax.disable_jit():
            oracle = jref.fused_post_exchange_plastic_ref(*jargs, stdp=STDP)
        interp = jops.fused_post_exchange_plastic(*jargs, stdp=STDP, backend="pallas_interpret")
    else:
        got = ops.fused_post_exchange_remote_plastic(
            _t(act_remote), _t(act), _t(pre), _t(ring), _t(onehot), _t(post_t), _t(post_s),
            *T, stdp=STDP)
        jargs = (_j(act_remote), _j(act), _j(pre), _j(ring), _j(onehot), _j(post_t),
                 _j(post_s), *J)
        with jax.disable_jit():
            oracle = jref.fused_post_exchange_remote_plastic_ref(*jargs, stdp=STDP)
        interp = jops.fused_post_exchange_remote_plastic(*jargs, stdp=STDP,
                                                         backend="pallas_interpret")
    # STDP is elementwise: the weights exactly equal the op-by-op oracle's
    # and within 1e-6 of the compiled interpret kernel's; the ring sums
    # in another order: rtol=atol=1e-5
    for want, w_tol in ((oracle, 0.0), (interp, 1e-6)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=w_tol)
    assert any((a.numpy() != w).any() for a, w in zip(got[1], weights))


@pytest.mark.parametrize("slot", [3, None])
def test_event_split_use_matches_reference(rng, slot):
    """The event gather over an (n_global,) activity into an (D, n_p) ring,
    with the delivered slot cleared or (remote pass) no clear."""
    n_p, n, R, D, block_r = 40, 160, 40, 8, 8
    ks, delays = (8, 16), (2, 5)
    cols, weights, valid = [], [], []
    for K in ks:
        v = rng.random((R, K)) < 0.3
        cols.append(np.where(v, rng.integers(0, n, (R, K)), 0).astype(np.int32))
        weights.append(np.where(v, rng.normal(size=(R, K)), 0.0).astype(np.float32))
        valid.append(v)
    nb = R // block_r
    masks = jev.build_touch_masks(cols, valid, n, nb, block_r)
    act = (rng.random(n) < 0.02).astype(np.float32)
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    t, cap = 11, 32
    write = [(t + d) % D for d in delays]
    sel, flags = jev.event_select(_j(act), [_j(m) for m in masks], cap)
    clear = np.ones(D, np.float32) if slot is None else (np.arange(D) != slot).astype(np.float32)
    onehot = (np.asarray(write)[:, None] == np.arange(D)[None, :]).astype(np.float32)
    plan = tev.EventPlan(block_r, nb, cap, _t(np.stack(masks)))
    got = _t(ring).clone()
    got_flags = ops.event_post_exchange(_t(act), got, slot, write, plan,
                                        [_t(c) for c in cols], [_t(w) for w in weights])
    np.testing.assert_array_equal(got_flags.numpy(), np.asarray(flags))
    assert 0 < int(got_flags.sum()) < got_flags.numel()
    for backend in ("ref", "pallas_interpret"):
        want = jops.event_post_exchange(
            _j(act), _j(ring), _j(clear), _j(onehot), sel, flags,
            [_j(c) for c in cols], [_j(w) for w in weights], backend=backend,
        )
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    if slot is None:  # no clear: the delivered slots keep their values
        untouched = [s for s in range(D) if s not in write]
        assert torch.equal(got[untouched], _t(ring)[untouched])


# -- host level -----------------------------------------------------------

def _nets(kind, k, noise=False):
    """The same k-partition uniform net from both packages' builders."""
    out = []
    for mod in (jnet, tnet):
        if kind == "plastic":
            net = mod.balanced_ei(160, stdp=True, seed=7, delay_steps=5)
            net.vtx_state[:, 2] += 6.0  # drive real activity through STDP
        else:
            net = mod.spatial_random(240, avg_degree=10, seed=4)
            # drive real activity through the exchange; "burst" fires
            # synchronously, past the index exchange's capacity
            net.vtx_state[:, 2] += 400.0 if kind == "burst" else 50.0
        d = mod.to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)
        if not noise:
            d.meta["noise_sigma"] = 0.0
        out.append(d)
    return out


@pytest.mark.parametrize("kind,k", [("plain", 2), ("plain", 4), ("plastic", 4)])
def test_stacked_panels_match_reference(kind, k):
    jd, td = _nets(kind, k)
    want = jdist.stack_partitions(jd, JSimConfig(align_k=8))
    got = tdist.stack_partitions(td, SimConfig(align_k=8))
    assert (got.n_p, got.k, got.delays, got.d_ring) == (want.n_p, want.k, want.delays, want.d_ring)
    assert got.any_plastic == want.any_plastic == (kind == "plastic")
    for name in ("cols", "weights", "valid") + (("plastic",) if got.any_plastic else ()):
        for a, b in zip(getattr(got, name), getattr(want, name)):
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
    np.testing.assert_array_equal(got.vtx_state0, want.vtx_state0)
    if kind == "plastic":
        return
    for a, b in zip(tdist.split_overlap_panels(got, 8), jdist.split_overlap_panels(want, 8)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("p_on,cap", [(0.0, 8), (0.1, 8), (0.5, 8), (0.5, 64)])
def test_index_compaction_keeps_the_lowest_ids(rng, p_on, cap):
    spikes = (rng.random(60) < p_on).astype(np.float32)
    ids, dropped = tdist.compact_spike_ids(_t(spikes), cap)
    want = np.asarray(jnp.nonzero(_j(spikes), size=cap, fill_value=60)[0])
    np.testing.assert_array_equal(ids.numpy(), want)
    assert int(dropped) == max(int(spikes.sum()) - cap, 0)


# -- engine level against the reference DistSimulator ----------------------

REFERENCE_RUNS = """
import numpy as np, jax
from jax.sharding import Mesh
from repro.core import block_partition
from repro.snn import SimConfig, network as jnet
from repro.snn.dist_sim import DistSimulator

def build(kind, k):
    if kind == "plastic":
        net = jnet.balanced_ei(160, stdp=True, seed=7, delay_steps=5)
        net.vtx_state[:, 2] += 6.0
    else:
        net = jnet.spatial_random(240, avg_degree=10, seed=4)
        net.vtx_state[:, 2] += 400.0 if kind == "burst" else 50.0
    d = jnet.to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)
    d.meta["noise_sigma"] = 0.0
    return d

out = {{}}
def dump(key, st, o):
    for name in ("raster", "spike_count", "overflow"):
        out[f"{{key}}/{{name}}"] = np.asarray(o[name])
    for name in ("vtx_state", "tr_plus", "tr_minus", "ring", "hist"):
        out[f"{{key}}/{{name}}"] = np.asarray(st[name])
    for i, w in enumerate(st["weights"]):
        out[f"{{key}}/w{{i}}"] = np.asarray(w)

for kind, k, exchange, frac in [
    ("plain", 2, "dense", 0.25), ("plain", 2, "index", 0.25),
    ("plain", 4, "dense", 0.25), ("plain", 4, "index", 0.25),
    ("burst", 4, "index", 0.05),  # cap 8 ids: a synchronous burst overflows
    ("plastic", 2, "dense", 0.25), ("plastic", 4, "dense", 0.25),
    ("plastic", 4, "index", 0.25),
]:
    mesh = Mesh(np.array(jax.devices()[:k]), ("parts",))
    cfg = SimConfig(align_k=8, record_raster=True, exchange=exchange, index_cap_frac=frac)
    sim = DistSimulator(build(kind, k), cfg, mesh=mesh)
    half = sim.init_state()
    half, o1 = sim.run(half, {steps} // 2)
    if frac == 0.25:
        dump(f"{{kind}}-{{k}}-{{exchange}}-half", half, o1)
    st, o = sim.run(sim.init_state(), {steps})
    dump(f"{{kind}}-{{k}}-{{exchange}}-{{frac}}", st, o)
np.savez({path!r}, **out)
print("REFERENCE RUNS OK")
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("dist") / "reference.npz")
    out = run_with_devices(REFERENCE_RUNS.format(steps=STEPS, path=path), n_devices=4)
    assert "REFERENCE RUNS OK" in out
    with np.load(path) as z:
        return {key: z[key] for key in z.files}


def _port_run(kind, k, exchange, frac=0.25, **kw):
    _, td = _nets(kind, k)
    sim = DistSimulator(td, SimConfig(align_k=8, record_raster=True, fused=True,
                                      exchange=exchange, index_cap_frac=frac, **kw),
                        devices=["cpu"] * k)
    st, o = sim.run(sim.init_state(), STEPS)
    return sim, st, {name: v.numpy() for name, v in o.items()}


def _stack(state, key):
    return np.stack([c[key].numpy() for c in state])


def _assert_state_close(st, ref, key, n_buckets):
    for name in ("vtx_state", "tr_plus", "tr_minus"):
        np.testing.assert_allclose(_stack(st, name), ref[f"{key}/{name}"], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(_stack(st, "hist"), ref[f"{key}/hist"])
    for i in range(n_buckets):
        w = np.stack([c["weights"][i].numpy() for c in st])
        np.testing.assert_allclose(w, ref[f"{key}/w{i}"], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind,k,exchange", [
    ("plain", 2, "dense"), ("plain", 2, "index"), ("plain", 4, "dense"),
    ("plain", 4, "index"), ("plastic", 2, "dense"), ("plastic", 4, "dense"),
    ("plastic", 4, "index"),
])
def test_dist_engine_matches_reference(reference_runs, kind, k, exchange):
    sim, st, o = _port_run(kind, k, exchange)
    key = f"{kind}-{k}-{exchange}-0.25"
    want = "fused_split_plastic" if kind == "plastic" else "fused_split"
    assert sim.engine_choice.engine == want and sim.exchange == exchange
    assert reference_runs[f"{key}/raster"].sum() > 20
    np.testing.assert_array_equal(o["raster"], reference_runs[f"{key}/raster"])
    np.testing.assert_array_equal(o["spike_count"], reference_runs[f"{key}/spike_count"])
    np.testing.assert_array_equal(o["overflow"], reference_runs[f"{key}/overflow"])
    _assert_state_close(st, reference_runs, key, len(sim.stacked.delays))
    if kind == "plastic":  # the net learned, and the port learned the same
        w0 = sim.stacked.weights
        assert any((np.stack([c["weights"][i].numpy() for c in st]) != w0[i]).any()
                   for i in range(len(w0)))


def test_index_overflow_matches_reference_and_warns(reference_runs):
    key = "burst-4-index-0.05"
    sim, _, o = _port_run("burst", 4, "index", frac=0.05)
    assert sim.index_cap == 8
    assert reference_runs[f"{key}/overflow"].sum() > 0
    np.testing.assert_array_equal(o["overflow"], reference_runs[f"{key}/overflow"])
    np.testing.assert_array_equal(o["raster"], reference_runs[f"{key}/raster"])
    _, td = _nets("burst", 4)
    ses = Session(td, SimConfig(align_k=8, fused=True, exchange="index", index_cap_frac=0.05),
                  engine="spmd", devices=["cpu"] * 4)
    with pytest.warns(UserWarning, match="dropped .*effective cap: 8 "):
        res = ses.run(STEPS)
    np.testing.assert_array_equal(res.overflow, reference_runs[f"{key}/overflow"].sum(axis=1))


@pytest.mark.parametrize("kind", ["plain", "plastic"])
def test_reference_mid_run_state_continues_in_the_port(reference_runs, kind):
    """A stacked (k, ...) carry of the reference DistSimulator, carried
    across with ``convert.carry_from_arrays``, continues in the port as it
    does in the reference."""
    k, exchange = 4, ("index" if kind == "plain" else "dense")
    half = f"{kind}-{k}-{exchange}-half"
    r = reference_runs
    n_w = sum(1 for key in r if key.startswith(half + "/w"))
    state = convert.carry_from_arrays(
        t=STEPS // 2, vtx_state=r[f"{half}/vtx_state"], ring=r[f"{half}/ring"],
        hist=r[f"{half}/hist"], weights=[r[f"{half}/w{i}"] for i in range(n_w)],
        tr_plus=r[f"{half}/tr_plus"], tr_minus=r[f"{half}/tr_minus"], device="cpu",
    )
    assert isinstance(state, list) and len(state) == k
    _, td = _nets(kind, k)
    sim = DistSimulator(td, SimConfig(align_k=8, record_raster=True, fused=True,
                                      exchange=exchange), devices=["cpu"] * k)
    _, o = sim.run(state, STEPS - STEPS // 2)
    full = f"{kind}-{k}-{exchange}-0.25"
    np.testing.assert_array_equal(o["raster"].numpy(), r[f"{full}/raster"][STEPS // 2:])
    assert o["raster"].numpy().sum() > 0


# -- within the port, exactly ----------------------------------------------

def _k1(td, **kw):
    sim = Session(merge_to_single(td), SimConfig(align_k=8, **kw), device="cpu").simulator
    st, o = sim.run(sim.init_state(), STEPS, record_raster=True)
    return st, o["raster"].numpy()


@pytest.mark.parametrize("kind,k,exchange", [
    ("plain", 2, "index"), ("plain", 4, "dense"), ("plastic", 2, "dense"),
    ("plastic", 4, "index"),
])
def test_split_engines_match_unfused_and_k1(kind, k, exchange):
    """Port-internal parity with the port's own noise: the split engine, the
    k>1 unfused engine and the k=1 run of merge_to_single give the same
    raster, state, traces and weights (up to signed zeros)."""
    _, td = _nets(kind, k, noise=True)
    runs = {}
    for fused in (True, False):
        sim = DistSimulator(td, SimConfig(align_k=8, fused=fused, exchange=exchange),
                            devices=["cpu"] * k)
        st, o = sim.run(sim.init_state(), STEPS, record_raster=True)
        runs[sim.engine_choice.engine] = (st, o["raster"].numpy().reshape(STEPS, -1))
    split = "fused_split_plastic" if kind == "plastic" else "fused_split"
    assert set(runs) == {split, "unfused"}
    st1, r1 = _k1(td, fused=True)
    assert r1.sum() > 20
    n_p = td.parts[0].n
    for st, raster in runs.values():
        np.testing.assert_array_equal(raster, r1)
        for name in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            dim = 1 if name in ("ring", "hist") else 0
            assert torch.equal(torch.cat([c[name] for c in st], dim=dim), st1[name]), name
        for i, w1 in enumerate(st1["weights"]):
            got = torch.cat([c["weights"][i][:n_p] for c in st])
            assert got.shape[1] == w1.shape[1]
            assert torch.equal(got, w1[: k * n_p])


@pytest.mark.parametrize("overlap", ["local", "double_buffer"])
def test_event_split_engine_matches_dense(overlap):
    _, td = _nets("plain", 4, noise=True)
    rasters = {}
    for gather in ("dense", "event"):
        sim = DistSimulator(td, SimConfig(align_k=8, fused=True, gather=gather, overlap=overlap,
                                          event_cap_frac=0.2), devices=["cpu"] * 4)
        _, o = sim.run(sim.init_state(), STEPS, record_raster=True)
        rasters[sim.engine_choice.engine] = o["raster"].numpy()
    assert set(rasters) == {"fused_split", "fused_split_event"}
    np.testing.assert_array_equal(rasters["fused_split"], rasters["fused_split_event"])


def test_session_spmd_on_cpu_devices():
    _, td = _nets("plain", 4, noise=True)
    ses = Session(td, SimConfig(align_k=8, fused=True), engine="spmd", devices=["cpu"] * 4)
    d = ses.describe()
    assert (d["engine"], d["k"], d["step_engine"], d["exchange"], d["overlap"]) == \
        ("spmd", 4, "fused_split", "index", "off")
    assert d["devices"] == ["cpu"] * 4
    raster = RasterMonitor()
    res = ses.run(STEPS, monitors=[raster], chunk_size=16)
    assert res.chunks == (16, 16, 8) and ses.t == STEPS
    _, r1 = _k1(td, fused=True)
    np.testing.assert_array_equal(raster.raster, r1)
    np.testing.assert_array_equal(res.spike_count, r1.sum(axis=1))
    # the merged fallback without devices, as the reference takes it
    # with fewer devices than partitions
    merged = Session(td, SimConfig(align_k=8, fused=True), device="cpu")
    assert merged.describe()["engine"] == "single" and merged.k == 1
    runtime = ses.simulator.runtime_state(ses.state)
    assert sorted(runtime) == [0, 1, 2, 3]
    np.testing.assert_array_equal(
        np.concatenate([runtime[p]["hist"] for p in range(4)], axis=1),
        np.concatenate([c["hist"].numpy() for c in ses.state], axis=1),
    )


@pytest.mark.parametrize("kw,match", [
    (dict(engine="spmd", devices=["cpu"] * 3), "needs 4 devices"),
    (dict(engine="spmd", device="cpu"), "needs 4 devices"),
    (dict(engine="single", devices=["cpu"] * 4), "places partitions"),
])
def test_session_spmd_selection_errors(kw, match):
    _, td = _nets("plain", 4)
    with pytest.raises(ValueError, match=match):
        Session(td, SimConfig(align_k=8), **kw)


def test_session_spmd_needs_k_gt_1_and_uniform_partitions():
    d1 = tnet.to_dcsr(tnet.spatial_random(60, avg_degree=5, seed=1), k=1)
    with pytest.raises(ValueError, match="k>1"):
        Session(d1, engine="spmd", devices=["cpu"])
    d3 = tnet.to_dcsr(tnet.spatial_random(61, avg_degree=5, seed=1), k=3)
    assert len({p.n for p in d3.parts}) > 1
    with pytest.raises(ValueError, match="uniform"):
        Session(d3, engine="spmd", devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="uniform"):
        DistSimulator(d3, devices=["cpu"] * 3)


def test_dist_state_to_dcsr_writes_learned_weights_back():
    _, td = _nets("plastic", 2, noise=True)
    sim = DistSimulator(td, SimConfig(align_k=8, fused=True), devices=["cpu"] * 2)
    st, _ = sim.run(sim.init_state(), STEPS)
    before = [p.edge_state[:, 0].copy() for p in td.parts]
    sim.state_to_dcsr(st)
    changed = sum(int((p.edge_state[:, 0] != b).sum()) for p, b in zip(td.parts, before))
    assert changed > 0
    merged = Session(merge_to_single(_nets("plastic", 2, noise=True)[1]),
                     SimConfig(align_k=8, fused=True), device="cpu").simulator
    st1, _ = merged.run(merged.init_state(), STEPS)
    merged.state_to_dcsr(st1)
    np.testing.assert_array_equal(
        np.concatenate([p.edge_state[:, 0] for p in merge_to_single(td).parts]),
        merged.net.parts[0].edge_state[:, 0],
    )
    np.testing.assert_array_equal(
        np.concatenate([p.vtx_state for p in td.parts]), merged.net.parts[0].vtx_state
    )


def test_dist_simulator_needs_a_device_per_partition(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, td = _nets("plain", 2)
    with pytest.raises(RuntimeError, match="2 CUDA cards"):
        DistSimulator(td)
    with pytest.raises(ValueError, match="3 devices for 2"):
        DistSimulator(td, devices=["cpu"] * 3)
