"""The port's plasticity path against the reference's, on the CPU.

Kernel level: the port's plain ``stdp_update_ref``, ``trace_decay_ref`` and
``fused_step_plastic_ref`` against ``repro.kernels.ref`` run op by op
(``jax.disable_jit()``), exactly, and against ``backend="pallas_interpret"``
(the TPU kernel bodies in interpret mode) within atol=1e-6.

Simulator level: the port's ``Simulator`` on ``balanced_ei(stdp=True)``,
with each of its engines, against the reference ``Simulator(backend="ref")``
noise-free and with the reference's noise injected.  Rasters must be equal;
traces and weights exactly equal to the reference run op by op and within
1e-5 of the compiled run (XLA contracts the compiled arithmetic into fused
multiply-adds, ROADMAP faults list); ``vtx_state`` and the ring within
1e-5 of both, because the gather sums its slots in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.snn import SimConfig as JSimConfig
from repro.snn import network as jnet
from repro.snn.simulator import Simulator as JSimulator
from repro_torch import convert
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.snn import RasterMonitor, Session, SimConfig, Simulator
from repro_torch.snn import network as tnet

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)
# w_min/w_max inside the normal weights' range, so the clip is exercised
STDP = dict(a_plus=0.01, a_minus=0.012, w_min=-2.0, w_max=2.0)
TAUS = (20.0, 15.0)
SEED = 42  # SimConfig's default noise seed, in both packages
N = 400
STEPS = 100


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _j(a):
    return jnp.asarray(np.asarray(a))


# -- kernel level ---------------------------------------------------------

@pytest.mark.parametrize("dt,tau", [(0.1, 20.0), (0.1, 15.0), (1.0, 20.0)])
def test_trace_decay_constant_is_the_reference_f32(dt, tau):
    want = np.asarray(jnp.exp(-dt / tau).astype(jnp.float32))
    assert np.float32(ref.trace_decay_constant(dt, tau)) == want


@pytest.mark.parametrize("n", [1, 37, 128, 4099])
def test_trace_decay_plain_matches_reference_exactly(rng, n):
    x = rng.random(n).astype(np.float32)
    s = (rng.random(n) < 0.3).astype(np.float32)
    got = ref.trace_decay_ref(_t(x), _t(s), dt=0.1, tau=20.0).numpy()
    with jax.disable_jit():
        want = np.asarray(jref.trace_decay_ref(_j(x), _j(s), dt=0.1, tau=20.0))
    np.testing.assert_array_equal(got, want)


def _stdp_case(rng, R, K, n, p_valid=0.6):
    w = rng.normal(size=(R, K)).astype(np.float32)
    valid = (rng.random((R, K)) < p_valid).astype(np.float32)
    cols = rng.integers(0, n, (R, K)).astype(np.int32)
    pre_t = rng.random(n).astype(np.float32)
    pre_s = (rng.random(n) < 0.3).astype(np.float32)
    post_t = rng.random(R).astype(np.float32)
    post_s = (rng.random(R) < 0.3).astype(np.float32)
    return w, valid, cols, pre_t, pre_s, post_t, post_s


@pytest.mark.parametrize("R,K,n", [
    (8, 8, 64), (32, 64, 500), (64, 16, 64), (104, 24, 100), (40, 20, 37),
])
def test_stdp_update_plain_matches_reference(rng, R, K, n):
    args = _stdp_case(rng, R, K, n)
    got = ops.stdp_update(*map(_t, args), params=STDP).numpy()
    with jax.disable_jit():
        oracle = np.asarray(jref.stdp_update_ref(*map(_j, args), **STDP))
    np.testing.assert_array_equal(got, oracle)
    interp = np.asarray(jops.stdp_update(
        *map(_j, args), params=STDP, backend="pallas_interpret",
        block_r=8, block_k=8,
    ))
    np.testing.assert_allclose(got, interp, rtol=0, atol=1e-6)
    w, valid = args[0], args[1]
    np.testing.assert_array_equal(got[valid == 0], w[valid == 0])
    assert (got != w).any()
    assert got[valid > 0].min() >= STDP["w_min"] and got[valid > 0].max() <= STDP["w_max"]


def test_stdp_update_plain_writes_into_out(rng):
    args = [_t(a) for a in _stdp_case(rng, 32, 64, 500)]
    want = ops.stdp_update(*args, params=STDP)
    w = args[0].clone()
    assert ops.stdp_update(w, *args[1:], params=STDP, out=w) is w
    assert torch.equal(w, want)


def _plastic_case(rng, n_p, R, ks):
    v = (-65.0 + 20.0 * rng.random(n_p)).astype(np.float32)
    refrac = rng.integers(0, 3, n_p).astype(np.float32)
    i_tot = (18.0 * rng.random(n_p)).astype(np.float32)
    tp = rng.random(n_p).astype(np.float32)
    tm = rng.random(n_p).astype(np.float32)
    cols, weights, plastic = [], [], []
    for K in ks:
        c = rng.integers(0, n_p, (R, K)).astype(np.int32)
        w = rng.normal(size=(R, K)).astype(np.float32)
        w[n_p:] = 0  # padded rows carry no synapses
        pm = (rng.random((R, K)) < 0.5).astype(np.float32)
        pm[n_p:] = 0  # ...and no plastic slots
        cols.append(c)
        weights.append(w)
        plastic.append(pm)
    return (v, refrac, i_tot, tp, tm), cols, weights, plastic


@pytest.mark.parametrize("n_p,R,ks", [
    (64, 64, (16,)),  # aligned, single bucket
    (100, 104, (8, 24)),  # non-aligned rows, two buckets
    (37, 40, (4, 12, 20)),  # odd sizes, three buckets
])
def test_fused_step_plastic_plain_matches_reference(rng, n_p, R, ks):
    vecs, cols, weights, plastic = _plastic_case(rng, n_p, R, ks)
    kw = dict(params=LIF_PARAMS, taus=TAUS, stdp=STDP)
    got = ops.fused_step_plastic(
        *map(_t, vecs), [_t(c) for c in cols], [_t(w) for w in weights],
        [_t(p) for p in plastic], **kw,
    )
    jargs = (*map(_j, vecs), [_j(c) for c in cols], [_j(w) for w in weights],
             [_j(p) for p in plastic])
    with jax.disable_jit():
        oracle = jops.fused_step_plastic(*jargs, backend="ref", **kw)
    interp = jops.fused_step_plastic(*jargs, backend="pallas_interpret", **kw)
    assert float(got[2].sum()) > 0, "case emits no spikes"
    # spikes, refractory counters and traces exact; v within an ulp's scale
    # of the op-by-op oracle, whose LIF jnp.where chain rounds as torch does
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(oracle[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(interp[i]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(oracle[0]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(interp[0]), rtol=1e-6, atol=1e-5)
    for a, b, c in zip(got[5], oracle[5], interp[5]):  # currents
        # f32 sums in another order: rtol=atol=1e-5
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=1e-5, atol=1e-5)
    for a, b, c, w0, pm in zip(got[6], oracle[6], interp[6], weights, plastic):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(a.numpy(), np.asarray(c), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(a.numpy()[pm == 0], w0[pm == 0])


def test_fused_plain_is_the_unfused_composition_bit_for_bit(rng):
    vecs, cols, weights, plastic = _plastic_case(rng, 200, 208, (16, 48, 8))
    v, r, i, tp, tm = map(_t, vecs)
    tc, tw, tpm = ([_t(a) for a in x] for x in (cols, weights, plastic))
    out = ops.fused_step_plastic(v, r, i, tp, tm, tc, tw, tpm,
                                 params=LIF_PARAMS, taus=TAUS, stdp=STDP)
    v1, r1, s1 = ops.lif_step(v, r, i, params=LIF_PARAMS)
    tp1 = ref.trace_decay_ref(tp, s1, dt=0.1, tau=TAUS[0])
    tm1 = ref.trace_decay_ref(tm, s1, dt=0.1, tau=TAUS[1])
    for a, b in zip(out[:5], (v1, r1, s1, tp1, tm1)):
        assert torch.equal(a, b)
    post_t = torch.nn.functional.pad(tm1, (0, 8))
    post_s = torch.nn.functional.pad(s1, (0, 8))
    for cur, nw, c, w, pm in zip(out[5], out[6], tc, tw, tpm):
        assert torch.equal(cur, ops.spike_gather(s1, c, w))
        assert torch.equal(nw, ops.stdp_update(w, pm, c, tp1, s1, post_t, post_s,
                                               params=STDP))


def _ell_panels(rng, n_p, R, ks, n_act, p_mask, full_rows):
    """Panels in the ELL layout: row r's ``row_len[r]`` real slots first
    (random ``< K``, or every row ``K`` long with ``full_rows``), then
    ``(col 0, weight +0, mask 0)``; rows past ``n_p`` empty; a plastic
    share ``p_mask`` of the real slots, and weights past ``w_max`` among
    them."""
    cols, weights, plastic, lens = [], [], [], []
    for K in ks:
        rl = np.full(R, K) if full_rows else rng.integers(0, K, R)
        rl[n_p:] = 0
        real = np.arange(K)[None, :] < rl[:, None]
        w = (1.5 * rng.normal(size=(R, K))).astype(np.float32)
        w[: R // 4] += 2.5  # past w_max: clipped where plastic
        cols.append(np.where(real, rng.integers(0, n_act, (R, K)), 0).astype(np.int32))
        weights.append(np.where(real, w, 0.0).astype(np.float32))
        plastic.append((real & (rng.random((R, K)) < p_mask)).astype(np.float32))
        lens.append(rl.astype(np.int32))
    return cols, weights, plastic, lens


def _ring0(rng, D, n_p):
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    ring[:, : n_p // 4] = -0.0  # signed zeros: -0 + +0 is +0
    return ring


@pytest.mark.parametrize("full_rows", [False, True], ids=["row_len<K", "row_len=K"])
@pytest.mark.parametrize("p_mask", [0.0, 0.5, 1.0])
def test_fused_step_plastic_ring_form_matches_reference(rng, p_mask, full_rows):
    """The plain version in the engine's form (row_len, the ring add, the
    weights in place) against the reference's fused_plastic_step op by op,
    its currents added into the ring as the reference's step adds them."""
    n_p, R, ks, D, t = 100, 104, (8, 24, 40), 6, 11
    delays = (1, 3, 6)
    vecs = _plastic_case(rng, n_p, R, ks)[0]
    cols, weights, plastic, lens = _ell_panels(rng, n_p, R, ks, n_p, p_mask, full_rows)
    ring0 = _ring0(rng, D, n_p)
    kw = dict(params=LIF_PARAMS, taus=TAUS, stdp=STDP)
    tw = [_t(w).clone() for w in weights]
    ring = _t(ring0).clone()
    got = ops.fused_step_plastic(
        *map(_t, vecs), [_t(c) for c in cols], tw, [_t(p) for p in plastic],
        [_t(rl) for rl in lens], ring=ring, t=t, delays=delays, weights_out=tw, **kw)
    assert got[5] is ring and all(a is b for a, b in zip(got[6], tw))
    with jax.disable_jit():
        oracle = jops.fused_step_plastic(
            *map(_j, vecs), [_j(c) for c in cols], [_j(w) for w in weights],
            [_j(p) for p in plastic], backend="ref", **kw)
    assert float(got[2].sum()) > 0, "case emits no spikes"
    for i in (1, 2, 3, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(oracle[i]))
    want_ring = ring0.copy()
    for cur, d in zip(oracle[5], delays):
        want_ring[(t + d) % D] += np.asarray(cur)[:n_p]
    # f32 sums in another order: rtol=atol=1e-5
    np.testing.assert_allclose(ring.numpy(), want_ring, rtol=1e-5, atol=1e-5)
    for a, b, w0, pm in zip(tw, oracle[6], weights, plastic):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy()[pm == 0], w0[pm == 0])
        if p_mask == 1.0:
            assert a.numpy().max() <= STDP["w_max"] or not pm.any()
    assert (p_mask == 0.0) == all((a.numpy() == w).all() for a, w in zip(tw, weights))


@pytest.mark.parametrize("p_mask", [0.0, 0.5, 1.0])
@pytest.mark.parametrize("variant", ["serial", "remote_own"])
def test_post_exchange_plastic_engine_forms_match_reference(rng, variant, p_mask):
    """Both post-exchange plastic ops in the engines' form (row_len, the
    weights in place; the remote pass's own slice zeroed by ``own``)
    against the reference's ops op by op."""
    n_p, n, D, R, ks, lo = 24, 96, 5, 24, (8, 16, 40), 24
    cols, weights, plastic, lens = _ell_panels(rng, n_p, R, ks, n, p_mask, False)
    act = (rng.random(n) < 0.3).astype(np.float32)
    pre = rng.random(n).astype(np.float32)
    post_t = rng.random(n_p).astype(np.float32)
    post_s = (rng.random(n_p) < 0.3).astype(np.float32)
    ring0 = _ring0(rng, D, n_p)
    clear = np.ones(D, np.float32)
    clear[2] = 0.0
    onehot = np.zeros((len(ks), D), np.float32)
    onehot[np.arange(len(ks)), [3, 4, 0]] = 1.0
    tw = [_t(w).clone() for w in weights]
    T = ([_t(c) for c in cols], tw, [_t(p) for p in plastic], [_t(rl) for rl in lens])
    J = ([_j(c) for c in cols], [_j(w) for w in weights], [_j(p) for p in plastic])
    if variant == "serial":
        got = ops.fused_post_exchange_plastic(
            _t(act), _t(pre), _t(ring0), _t(clear), _t(onehot), _t(post_t), _t(post_s), *T,
            stdp=STDP, weights_out=tw)
        with jax.disable_jit():
            oracle = jref.fused_post_exchange_plastic_ref(
                _j(act), _j(pre), _j(ring0), _j(clear), _j(onehot), _j(post_t), _j(post_s),
                *J, stdp=STDP)
    else:
        act_remote = act.copy()
        act_remote[lo:lo + n_p] = 0.0  # the own slice of partition 1
        got = ops.fused_post_exchange_remote_plastic(
            None, _t(act), _t(pre), _t(ring0), _t(onehot), _t(post_t), _t(post_s), *T,
            stdp=STDP, own=(lo, lo + n_p), weights_out=tw)
        with jax.disable_jit():
            oracle = jref.fused_post_exchange_remote_plastic_ref(
                _j(act_remote), _j(act), _j(pre), _j(ring0), _j(onehot), _j(post_t),
                _j(post_s), *J, stdp=STDP)
    assert all(a is b for a, b in zip(got[1], tw))
    # the ring sums in another order: rtol=atol=1e-5; STDP is elementwise
    np.testing.assert_allclose(got[0].numpy(), np.asarray(oracle[0]), rtol=1e-5, atol=1e-5)
    for a, b, w0, pm in zip(tw, oracle[1], weights, plastic):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy()[pm == 0], w0[pm == 0])
    assert (p_mask == 0.0) == all((a.numpy() == w).all() for a, w in zip(tw, weights))


@pytest.mark.parametrize("k", [1, 2])
def test_plastic_carry_weights_never_alias_the_panels(k):
    """The plastic engines update a run's carry's weights in place: no
    state a run hands back shares memory with the uploaded panels, which a
    ``_share``d simulator borrows; the panels and the caller's state stay as
    they were, and the borrower's run equals the lender's (k = 2: the split
    engine with its remote pass, overlap ``local``)."""
    from repro_torch.core import block_partition
    from repro_torch.snn import DistSimulator

    ei = tnet.balanced_ei(n=N, stdp=True)
    if k == 1:
        net = tnet.to_dcsr(ei, k=1)
        a = Simulator(net, SimConfig(fused=True), device="cpu")
        b = Simulator(net, SimConfig(fused=True), device="cpu", _share=a)
        devs = [a.dev]
    else:
        net = tnet.to_dcsr(ei, assignment=block_partition(N, k), uniform=True)
        cfg = SimConfig(fused=True, overlap="local")
        a = DistSimulator(net, cfg, devices=["cpu"] * k)
        b = DistSimulator(net, cfg, devices=["cpu"] * k, _share=a)
        assert a.engine_choice.engine == "fused_split_plastic"
        devs = a.devs
    w0 = [w.clone() for d in devs for w in d.weights0]
    panels = {w.untyped_storage().data_ptr() for d in devs for w in d.weights0}

    def weights(state):
        return [w for c in ([state] if k == 1 else state) for w in c["weights"]]

    ends = []
    for sim in (a, b):
        st = sim.init_state()
        end, _ = sim.run(st, STEPS)
        assert not panels & {w.untyped_storage().data_ptr() for w in weights(end)}
        assert any(not torch.equal(x, y) for x, y in zip(weights(end), w0))
        # the caller's state is never changed, the panels neither
        assert all(torch.equal(x, y) for x, y in zip(weights(st), w0))
        assert all(torch.equal(x, y) for x, y in zip([w for d in devs for w in d.weights0], w0))
        ends.append(weights(end))
    assert all(torch.equal(x, y) for x, y in zip(*ends))


# -- engine selection -----------------------------------------------------

def test_plastic_engine_selection():
    sel = dict(models_present=("lif",), identity_rows=True, n_delay_buckets=15,
               any_plastic=True)
    ch = dispatch.select_step_engine(backend="cuda", **sel)
    assert ch.engine == "fused_plastic" and ch.plastic and ch.fused and not ch.event
    ev = dispatch.select_step_engine(backend="cuda", gather="event", **sel)
    assert ev.engine == "fused_plastic" and "event gather unavailable" in ev.reason
    assert dispatch.select_step_engine(backend="ref", **sel).engine == "unfused"
    assert dispatch.select_step_engine(backend="ref", fused=True, **sel).plastic
    assert dispatch.select_step_engine(backend="cuda", fused=False, **sel).engine == "unfused"
    with pytest.raises(ValueError, match="plastic nets stay dense"):
        dispatch.select_step_engine(backend="cuda", fused=True, gather="event", **sel)
    assert dispatch.event_gather_blocker(False) is None
    # no size limit on plastic partitions (the reference's 157,286 neurons)
    assert not hasattr(dispatch, "FUSED_PLASTIC_MAX_N_P")


@pytest.mark.parametrize("fused,gather,engine", [
    (True, "auto", "fused_plastic"), (None, "auto", "unfused"),
    (True, "dense", "fused_plastic"), (None, "event", "unfused"),
])
def test_plastic_session_stays_dense(fused, gather, engine):
    net = tnet.to_dcsr(tnet.balanced_ei(n=300, stdp=True), k=1)
    ses = Session(net, SimConfig(fused=fused, gather=gather), device="cpu")
    assert not ses.simulator.event_capable
    assert ses.engine_choice.engine == engine
    ses.run(40, chunk_size=10)
    assert ses.engine_choice.engine == engine
    assert ses.last_gather_modes == ("event" if gather == "event" else "dense",) * 4


def test_plastic_event_engine_demanded_raises():
    net = tnet.to_dcsr(tnet.balanced_ei(n=300, stdp=True), k=1)
    with pytest.raises(ValueError, match="plastic nets stay dense"):
        Session(net, SimConfig(fused=True, gather="event"), device="cpu")


# -- simulator level ------------------------------------------------------

def _reference_noise(net):
    sigma, n = float(net.meta["noise_sigma"]), net.n
    key = jax.random.PRNGKey(SEED)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


def _nets(noisy):
    jd = jnet.to_dcsr(jnet.balanced_ei(n=N, stdp=True), k=1)
    td = tnet.to_dcsr(tnet.balanced_ei(n=N, stdp=True), k=1)
    if not noisy:
        jd.meta["noise_sigma"] = 0.0
        td.meta["noise_sigma"] = 0.0
    return jd, td


def _host(st):
    return dict(
        vtx_state=np.asarray(st["vtx_state"]), ring=np.asarray(st["ring"]),
        hist=np.asarray(st["hist"]), tr_plus=np.asarray(st["tr_plus"]),
        tr_minus=np.asarray(st["tr_minus"]),
        weights=[np.asarray(w) for w in st["weights"]],
    )


@pytest.fixture(scope="module", params=["noise_free", "noise"])
def reference(request):
    noisy = request.param == "noise"
    jd, td = _nets(noisy)
    jsim = JSimulator(jd, JSimConfig(align_k=32, backend="ref", record_raster=True))
    st_c, out_c = jsim.run(jsim.init_state(), STEPS)
    with jax.disable_jit():
        st_e, out_e = jsim.run(jsim.init_state(), STEPS)
    jsim.state_to_dcsr(st_e)
    return dict(
        noisy=noisy, jd=jd, td=td,
        raster=np.asarray(out_c["raster"]), raster_eager=np.asarray(out_e["raster"]),
        compiled=_host(st_c), eager=_host(st_e),
        w0=[np.asarray(w) for w in jsim.dev.weights0],
        edge_state=jd.parts[0].edge_state.copy(),
    )


def _noise_fn(reference):
    return _reference_noise(reference["jd"]) if reference["noisy"] else None


@pytest.mark.parametrize("fused", [None, True, False])
def test_plastic_simulator_matches_reference(reference, fused):
    td = tnet.to_dcsr(tnet.balanced_ei(n=N, stdp=True), k=1)
    td.meta["noise_sigma"] = reference["td"].meta["noise_sigma"]
    sim = Simulator(td, SimConfig(align_k=32, record_raster=True, fused=fused),
                    device="cpu", _noise_fn=_noise_fn(reference))
    assert sim.engine_choice.engine == ("fused_plastic" if fused else "unfused")
    st, out = sim.run(sim.init_state(), STEPS)
    raster = out["raster"].numpy()
    assert reference["raster"].sum() > 0, "no spikes to compare"
    np.testing.assert_array_equal(raster, reference["raster"])
    np.testing.assert_array_equal(raster, reference["raster_eager"])
    got = _host(st)
    eager, compiled = reference["eager"], reference["compiled"]
    for key in ("tr_plus", "tr_minus", "hist"):
        np.testing.assert_array_equal(got[key], eager[key], err_msg=key)
        np.testing.assert_allclose(got[key], compiled[key], rtol=0, atol=1e-5, err_msg=key)
    for key in ("vtx_state", "ring"):
        # f32 gather sums in another order: within 1e-5
        for want in (eager, compiled):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-5, err_msg=key)
    changed = 0
    for a, b, c, w0 in zip(got["weights"], eager["weights"], compiled["weights"],
                           reference["w0"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(a, c, rtol=0, atol=1e-5)
        changed += int((a != w0).sum())
    assert changed > 0, "no plastic slot changed: the net never learned"
    sim.state_to_dcsr(st)
    np.testing.assert_array_equal(td.parts[0].edge_state, reference["edge_state"])


@pytest.fixture(scope="module")
def continuation():
    """A reference carry at t=60, compiled (weights have changed by then),
    and the reference's continuation from it for 30 steps, op by op."""
    jd, _ = _nets(noisy=True)
    jsim = JSimulator(jd, JSimConfig(align_k=32, backend="ref", record_raster=True))
    st60, _ = jsim.run(jsim.init_state(), 60)
    with jax.disable_jit():
        st90, jout = jsim.run(st60, 30)
    mid = _host(st60)
    assert any((w != np.asarray(w0)).any() for w, w0 in zip(mid["weights"], jsim.dev.weights0))
    assert mid["tr_plus"].any()
    return jd, mid, _host(st90), np.asarray(jout["raster"])


@pytest.mark.parametrize("fused", [True, False])
def test_continuation_from_a_reference_carry(continuation, fused):
    jd, mid, want, raster = continuation
    td = tnet.to_dcsr(tnet.balanced_ei(n=N, stdp=True), k=1)
    carry = convert.carry_from_arrays(t=60, device="cpu", **mid)
    sim = Simulator(td, SimConfig(align_k=32, record_raster=True, fused=fused),
                    device="cpu", _noise_fn=_reference_noise(jd))
    st, out = sim.run(carry, 30)
    assert st["t"] == 90
    assert raster.sum() > 0
    np.testing.assert_array_equal(out["raster"].numpy(), raster)
    got = _host(st)
    for key in ("tr_plus", "tr_minus", "hist"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for a, b in zip(got["weights"], want["weights"]):
        np.testing.assert_array_equal(a, b)
    assert any((a != m).any() for a, m in zip(got["weights"], mid["weights"]))
    np.testing.assert_allclose(got["vtx_state"], want["vtx_state"], rtol=1e-5, atol=1e-5)


def test_plastic_monitors_and_chunks():
    td = tnet.to_dcsr(tnet.balanced_ei(n=N, stdp=True), k=1)
    whole = Session(td, SimConfig(fused=True), device="cpu")
    chunked = Session(td, SimConfig(fused=True), device="cpu")
    rasters = []
    for ses, chunk in ((whole, STEPS), (chunked, 37)):
        mon = RasterMonitor()
        ses.run(STEPS, monitors=[mon], chunk_size=chunk)
        rasters.append(mon.raster)
    np.testing.assert_array_equal(rasters[0], rasters[1])
    for a, b in zip(whole.state["weights"], chunked.state["weights"]):
        assert torch.equal(a, b)
    assert torch.equal(whole.state["tr_plus"], chunked.state["tr_plus"])
