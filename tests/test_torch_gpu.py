"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the ``gpu`` marker and skips inside the ``cuda``
fixture when there is no card.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports no JAX: the kernels are held against the port's own plain
versions, which ``tests/test_torch_kernels.py`` (and, for the keystream,
``tests/test_torch_procedural.py``) holds against the JAX oracles on the
CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import event_step as event_mod
from repro_torch.kernels import fused_step as fused_mod
from repro_torch.kernels import keystream as ks_mod
from repro_torch.kernels import lif_step as lif_mod
from repro_torch.kernels import spike_gather as gather_mod
from repro_torch.kernels import split_step as split_mod
from repro_torch.kernels import step_front as front_mod
from repro_torch.kernels import stdp_update as stdp_mod
from repro_torch.kernels.dispatch import panel_reduce

pytestmark = pytest.mark.gpu

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)
# w_min/w_max inside the normal weights' range, so the clip is exercised
STDP = dict(a_plus=0.01, a_minus=0.012, w_min=-2.0, w_max=2.0)
TAUS = (20.0, 15.0)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _lif_inputs(rng, n, device):
    v = (-66.0 + 20.0 * rng.random(n)).astype(np.float32)
    refrac = rng.integers(0, 3, n).astype(np.float32)
    i = (30.0 * rng.random(n)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (v, refrac, i)]


def _panels(rng, n_act, R, ks, n_rows, device):
    cols, weights = [], []
    for K in ks:
        c = rng.integers(0, n_act, (R, K)).astype(np.int32)
        w = rng.normal(size=(R, K)).astype(np.float32)
        w[n_rows:] = 0.0
        cols.append(torch.from_numpy(c).to(device))
        weights.append(torch.from_numpy(w).to(device))
    return cols, weights


def test_library_builds_with_ptxas_report(cuda):
    info = _build.build()
    assert info.path.exists()
    lib = _build.library()
    assert lib.repro_fused_step_max_buckets() == fused_mod.MAX_BUCKETS
    assert lib.repro_fused_plastic_step_max_buckets() == fused_mod.MAX_BUCKETS
    assert lib.repro_event_step_max_buckets() == event_mod.MAX_BUCKETS


@pytest.mark.parametrize("n", [1, 1000, 77169])
def test_lif_step_kernel_bit_exact(cuda, rng, n):
    v, r, i = _lif_inputs(rng, n, cuda)
    before = lif_mod.COUNTER.launches
    got = ops.lif_step(v, r, i, params=LIF_PARAMS)
    assert lif_mod.COUNTER.launches == before + 1
    want = ref.lif_step_ref(v, r, i, **LIF_PARAMS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n_act,R,K", [
    (64, 8, 32), (100, 104, 24), (1000, 1000, 200), (20000, 20000, 1408),
])
def test_spike_gather_kernel_matches_plain(cuda, rng, n_act, R, K):
    act = torch.from_numpy(
        (rng.random(n_act) < 0.3).astype(np.float32)
    ).to(cuda)
    (c,), (w,) = _panels(rng, n_act, R, (K,), R, cuda)
    got = ops.spike_gather(act, c, w, reduce=panel_reduce([w]))
    want = ref.spike_gather_ref(act, c, w)
    # f32 sums in another order: rtol=atol=1e-5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # deterministic: the same launch gives the same bits
    assert torch.equal(got, ops.spike_gather(act, c, w, reduce=panel_reduce([w])))


@pytest.mark.parametrize("n_p,R,ks", [
    (64, 64, (16,)),
    (100, 104, (8, 24)),
    (37, 40, (4, 12, 20)),
    (500, 504, tuple(range(8, 8 * 16, 8))),  # 15 buckets, as balanced_ei
    (19288, 19288, (512, 1408)),  # microcircuit(0.25) panel widths
])
def test_fused_step_kernel_bit_exact_vs_unfused(cuda, rng, n_p, R, ks):
    v, r, i = _lif_inputs(rng, n_p, cuda)
    cols, weights = _panels(rng, n_p, R, ks, n_p, cuda)
    before = fused_mod.COUNTER.launches
    v2, r2, s2, curs = ops.fused_step(v, r, i, cols, weights, params=LIF_PARAMS,
                                      reduce=panel_reduce(weights))
    assert fused_mod.COUNTER.launches == before + 1
    v1, r1, s1 = ops.lif_step(v, r, i, params=LIF_PARAMS)
    for a, b in zip((v2, r2, s2), (v1, r1, s1)):
        assert torch.equal(a, b)
    for cur, c, w in zip(curs, cols, weights):
        assert torch.equal(cur, ops.spike_gather(s1, c, w, reduce=panel_reduce([w])))
    # and to its row_dot variant, which reads every slot
    forced = ops.fused_step(v, r, i, cols, weights, params=LIF_PARAMS, reduce="row_dot")
    for a, b in zip(curs, forced[3]):
        assert torch.equal(a, b)
    _, _, s_p, curs_p = ref.fused_step_ref(v, r, i, cols, weights, params=LIF_PARAMS)
    assert torch.equal(s2, s_p)
    for a, b in zip(curs, curs_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_kernels_refuse_cpu_tensors_and_bad_operands(cuda):
    v = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        lif_mod.lif_step_cuda(v, v, v, params=LIF_PARAMS)
    act = torch.zeros(8, device=cuda)
    cols = torch.zeros((8, 4), dtype=torch.int64, device=cuda)
    w = torch.zeros((8, 4), device=cuda)
    with pytest.raises(TypeError):
        gather_mod.spike_gather_cuda(act, cols, w)
    too_many = [cols.int()] * (fused_mod.MAX_BUCKETS + 1)
    with pytest.raises(ValueError, match="delay buckets"):
        fused_mod.fused_step_cuda(
            act, act, act, too_many, [w] * len(too_many), params=LIF_PARAMS
        )


@pytest.mark.parametrize("n_p,R,ks,block_r,p_active,cap", [
    (64, 64, (16,), 16, 0.05, 32),
    (100, 104, (8, 24), 8, 0.02, 32),
    (500, 504, tuple(range(8, 8 * 16, 8)), 128, 0.01, 32),  # 15 buckets
    (5000, 5000, (128, 384), 128, 0.001, 250),  # sparse: blocks skipped
    (5000, 5000, (128, 384), 128, 0.2, 250),  # ids overflow: all flagged
    (19288, 19288, (512, 1408), 128, 0.0008, 964),  # microcircuit(0.25)
])
def test_event_kernel_matches_plain_and_dense(cuda, rng, n_p, R, ks, block_r,
                                              p_active, cap):
    D, t = 16, 37
    delays = [1 + (3 * i) % D for i in range(len(ks))]
    cols, weights = _panels(rng, n_p, R, ks, n_p, cuda)
    valid = [(w != 0).cpu().numpy() for w in weights]
    plan = event_mod.EventPlan.build([c.cpu().numpy() for c in cols], valid, n_p,
                                     cap, cuda, block_r=block_r)
    act = torch.from_numpy((rng.random(n_p) < p_active).astype(np.float32)).to(cuda)
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    slot, write = t % D, [(t + d) % D for d in delays]
    got = ring.clone()
    before = event_mod.COUNTER.launches
    flags = ops.event_post_exchange(act, got, slot, write, plan, cols, weights,
                                    reduce=panel_reduce(weights))
    assert event_mod.COUNTER.launches == before + 1
    want = ring.clone()
    want_flags = event_mod.event_post_exchange_plain(act, want, slot, write, plan,
                                                     cols, weights)
    assert torch.equal(flags, want_flags)
    # f32 sums in another order: rtol=atol=1e-5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # against the dense kernel: equal bits on every row
    dense = ring.clone()
    dense[slot] = 0.0
    for c, w, ws in zip(cols, weights, write):
        dense[ws] += ops.spike_gather(act, c, w, reduce=panel_reduce([w]))[:n_p]
    assert torch.equal(got, dense)
    # deterministic although the ids are compacted with atomics
    again = ring.clone()
    assert torch.equal(ops.event_post_exchange(act, again, slot, write, plan, cols,
                                               weights, reduce=panel_reduce(weights)), flags)
    assert torch.equal(again, got)
    # with the row lengths (rows < n_p are K long here): the same ring, equal
    # to the row_dot kernels' (post_exchange's ring formulation)
    with_len = ring.clone()
    assert torch.equal(ops.event_post_exchange(act, with_len, slot, write, plan, cols,
                                               weights, _row_lengths(valid, cuda),
                                               reduce=panel_reduce(weights)), flags)
    assert torch.equal(with_len, got)
    clear, onehot, _ = _slots(D, t, delays, cuda)
    assert torch.equal(got, ops.fused_post_exchange(act, ring, clear, onehot, cols, weights,
                                                    reduce="row_dot"))


@pytest.mark.parametrize("fused,gather", [
    (True, "dense"), (False, "dense"), (True, "event"), (None, "auto"),
])
def test_engines_bit_identical_on_card(cuda, fused, gather):
    from repro_torch.snn import (
        RasterMonitor, Session, SimConfig, microcircuit, to_dcsr,
    )

    net = to_dcsr(microcircuit(scale=0.05), k=1)
    rasters = []
    for cfg in (SimConfig(fused=True, gather="dense"), SimConfig(fused=fused, gather=gather)):
        ses = Session(net, cfg, device=cuda)
        mon = RasterMonitor()
        ses.run(200, monitors=[mon], chunk_size=64)
        rasters.append(mon.raster)
    base, other = rasters
    assert base.sum() > 0
    np.testing.assert_array_equal(other, base)


def _masks(rng, R, ks, n_rows, device, p=0.5):
    out = []
    for K in ks:
        m = (rng.random((R, K)) < p).astype(np.float32)
        m[n_rows:] = 0.0  # padded rows hold no plastic slot
        out.append(torch.from_numpy(m).to(device))
    return out


def _vec(rng, n, device):
    return torch.from_numpy(rng.random(n).astype(np.float32)).to(device)


@pytest.mark.parametrize("n,R,K,p_mask", [
    (64, 8, 32, 0.5), (100, 104, 24, 0.5), (1000, 1000, 37, 0.3),
    (12500, 12504, 128, 0.65), (500, 504, 40, 0.0),  # all-zero mask
])
def test_stdp_update_kernel_bit_exact(cuda, rng, n, R, K, p_mask):
    (c,), (w,) = _panels(rng, n, R, (K,), R, cuda)
    (m,) = _masks(rng, R, (K,), R, cuda, p_mask)
    pre_t, post_t = _vec(rng, n, cuda), _vec(rng, R, cuda)
    pre_s = (_vec(rng, n, cuda) < 0.3).float()
    post_s = (_vec(rng, R, cuda) < 0.3).float()
    args = (w, m, c, pre_t, pre_s, post_t, post_s)
    before = stdp_mod.COUNTER.launches
    got = ops.stdp_update(*args, params=STDP)
    assert stdp_mod.COUNTER.launches == before + 1
    want = stdp_mod.stdp_update_plain(*args, params=STDP)
    assert torch.equal(got, want)
    if p_mask == 0.0:
        assert torch.equal(got, w)
    else:
        assert not torch.equal(got, w)
    # in place and into a separate buffer: the same weights
    inplace = w.clone()
    assert ops.stdp_update(inplace, m, c, pre_t, pre_s, post_t, post_s,
                           params=STDP, out=inplace) is inplace
    assert torch.equal(inplace, got)
    other = torch.full_like(w, float("nan"))
    ops.stdp_update(*args, params=STDP, out=other)
    assert torch.equal(other, got)


def _plastic_case(rng, n_p, R, ks, device, p_mask=0.5):
    v, r, i = _lif_inputs(rng, n_p, device)
    cols, weights = _panels(rng, n_p, R, ks, n_p, device)
    plastic = _masks(rng, R, ks, n_p, device, p_mask)
    return v, r, i, _vec(rng, n_p, device), _vec(rng, n_p, device), cols, weights, plastic


@pytest.mark.parametrize("n_p,R,ks,p_mask", [
    (64, 64, (16,), 0.5),
    (100, 104, (8, 24), 0.5),  # R > n_p
    (37, 40, (4, 12, 20), 0.5),  # K not a multiple of 32
    (500, 504, tuple(range(8, 8 * 16, 8)), 0.5),  # 15 buckets, as balanced_ei
    (1000, 1000, (37,), 0.0),  # one bucket, all-zero mask
    (12500, 12504, (128,) * 15, 0.65),  # balanced_ei(12500) panel widths
])
def test_fused_plastic_kernel_vs_unfused_kernels_and_plain(cuda, rng, n_p, R, ks, p_mask):
    v, r, i, tp, tm, cols, weights, plastic = _plastic_case(rng, n_p, R, ks, cuda, p_mask)
    kw = dict(params=LIF_PARAMS, taus=TAUS, stdp=STDP)
    before = fused_mod.PLASTIC_COUNTER.launches
    out = ops.fused_step_plastic(v, r, i, tp, tm, cols, weights, plastic, **kw)
    assert fused_mod.PLASTIC_COUNTER.launches == before + 1
    v2, r2, s2, tp2, tm2, curs, new_w = out
    assert int(s2.sum()) > 0
    # the unfused engine's kernels and torch ops
    v1, r1, s1 = ops.lif_step(v, r, i, params=LIF_PARAMS)
    tp1 = ref.trace_decay_ref(tp, s1, dt=LIF_PARAMS["dt"], tau=TAUS[0])
    tm1 = ref.trace_decay_ref(tm, s1, dt=LIF_PARAMS["dt"], tau=TAUS[1])
    for a, b in zip((v2, r2, s2, tp2, tm2), (v1, r1, s1, tp1, tm1)):
        assert torch.equal(a, b)
    pad = R - n_p
    post_t = torch.nn.functional.pad(tm1, (0, pad))
    post_s = torch.nn.functional.pad(s1, (0, pad))
    for cur, nw, c, w, pm in zip(curs, new_w, cols, weights, plastic):
        assert torch.equal(cur, ops.spike_gather(s1, c, w, reduce=panel_reduce([w])))
        assert torch.equal(nw, ops.stdp_update(w, pm, c, tp1, s1, post_t, post_s,
                                               params=STDP))
        frozen = pm == 0
        assert torch.equal(nw[frozen], w[frozen])
    # the plain version: bit-exact but for the currents (f32 sums in another
    # order: rtol=atol=1e-5)
    want = fused_mod.fused_step_plastic_plain(v, r, i, tp, tm, cols, weights, plastic, **kw)
    for a, b in zip(out[:5], want[:5]):
        assert torch.equal(a, b)
    for a, b in zip(curs, want[5]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(new_w, want[6]):
        assert torch.equal(a, b)
    if p_mask > 0:
        assert any(not torch.equal(a, b) for a, b in zip(new_w, weights))


def test_plastic_kernels_refuse_cpu_tensors_and_bad_operands(cuda, rng):
    w = torch.zeros((8, 4))
    c = torch.zeros((8, 4), dtype=torch.int32)
    vec = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA"):
        stdp_mod.stdp_update_cuda(w, w, c, vec, vec, vec, vec, params=STDP)
    wg, cg, vg = w.to(cuda), c.to(cuda), vec.to(cuda)
    with pytest.raises(TypeError):
        stdp_mod.stdp_update_cuda(wg, wg, cg.long(), vg, vg, vg, vg, params=STDP)
    with pytest.raises(ValueError, match="rows"):
        stdp_mod.stdp_update_cuda(wg, wg, cg, vg, vg, vg[:4], vg, params=STDP)
    with pytest.raises(ValueError, match="out"):
        stdp_mod.stdp_update_cuda(wg, wg, cg, vg, vg, vg, vg, params=STDP,
                                  out=torch.empty((4, 4), device=cuda))
    kw = dict(params=LIF_PARAMS, taus=TAUS, stdp=STDP)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mod.fused_step_plastic_cuda(vec, vec, vec, vec, vec, [c], [w], [w], **kw)
    too_many = [cg] * (fused_mod.MAX_BUCKETS + 1)
    panels = [wg] * len(too_many)
    with pytest.raises(ValueError, match="delay buckets"):
        fused_mod.fused_step_plastic_cuda(vg, vg, vg, vg, vg, too_many, panels, panels, **kw)
    with pytest.raises(ValueError, match="delay buckets"):
        fused_mod.fused_step_plastic_cuda(vg, vg, vg, vg, vg, [cg], [wg], [], **kw)
    with pytest.raises(ValueError, match="shape"):
        fused_mod.fused_step_plastic_cuda(vg, vg, vg, vg, vg[:4], [cg], [wg], [wg], **kw)


def test_plastic_engines_bit_identical_on_card(cuda):
    from repro_torch.snn import RasterMonitor, Session, SimConfig, balanced_ei, to_dcsr

    net = to_dcsr(balanced_ei(n=2000, stdp=True, seed=0), k=1)
    runs = []
    for fused in (None, False):
        ses = Session(net, SimConfig(fused=fused), device=cuda)
        mon = RasterMonitor()
        ses.run(400, monitors=[mon], chunk_size=128)
        runs.append((ses, mon.raster))
    (fs, fr), (us, ur) = runs
    assert fs.engine_choice.engine == "fused_plastic"
    assert us.engine_choice.engine == "unfused"
    assert fs.last_gather_modes == ("dense",) * 4
    assert fr.sum() > 0
    np.testing.assert_array_equal(ur, fr)
    for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
        assert torch.equal(fs.state[key], us.state[key]), key
    w0 = fs.simulator.dev.weights0
    assert any(not torch.equal(a, b) for a, b in zip(fs.state["weights"], w0))
    for a, b in zip(fs.state["weights"], us.state["weights"]):
        assert torch.equal(a, b)


# -- the split (k>1) step's kernels -----------------------------------------

def test_split_kernels_build(cuda):
    lib = _build.library()
    assert lib.repro_post_exchange_max_buckets() == split_mod.MAX_BUCKETS
    assert lib.repro_post_exchange_plastic_max_buckets() == split_mod.MAX_BUCKETS


@pytest.mark.parametrize("n", [1, 1000, 19293])
def test_pre_exchange_kernel_bit_exact(cuda, rng, n):
    v, r, i = _lif_inputs(rng, n, cuda)
    tp, tm = _vec(rng, n, cuda), _vec(rng, n, cuda)
    before = split_mod.PRE_COUNTER.launches
    got = ops.fused_pre_exchange(v, r, i, tp, tm, params=LIF_PARAMS, taus=TAUS)
    assert split_mod.PRE_COUNTER.launches == before + 1
    want = ref.fused_pre_exchange_ref(v, r, i, tp, tm, params=LIF_PARAMS, taus=TAUS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # the trace-free variant is the lif_step kernel
    before = lif_mod.COUNTER.launches
    three = ops.fused_pre_exchange(v, r, i, params=LIF_PARAMS)
    assert lif_mod.COUNTER.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(three, got))


def _slots(D, t, delays, device):
    clear = (torch.arange(D) != t % D).float().to(device)
    write = [(t + d) % D for d in delays]
    onehot = (torch.tensor(write)[:, None] == torch.arange(D)[None, :]).float().to(device)
    return clear, onehot, write


def _ring_by_kernels(act, ring, clear, onehot, cols, weights, n_p):
    """The reference's ring formulation around the spike_gather kernel."""
    curs = [ops.spike_gather(act, c, w, reduce=panel_reduce([w]))[:n_p]
            for c, w in zip(cols, weights)]
    return ref._ring_accumulate(ring, clear, onehot, curs)


@pytest.mark.parametrize("n_p,n,R,ks,clear_it", [
    (64, 256, 64, (16,), True),
    (100, 400, 104, (8, 24), True),  # R > n_p
    (37, 37, 40, (4, 12, 20), True),  # local ids
    (500, 2000, 504, tuple(range(8, 8 * 16, 8)), False),  # 15 buckets, remote
    (19293, 77172, 19296, (384, 1280), True),  # microcircuit k=4 widths
])
def test_post_exchange_kernel_bit_exact_vs_gather_kernel(cuda, rng, n_p, n, R, ks, clear_it):
    D, t = 16, 21
    delays = [1 + (3 * i) % D for i in range(len(ks))]
    cols, weights = _panels(rng, n, R, ks, n_p, cuda)
    act = (torch.from_numpy(rng.random(n)).to(cuda) < 0.05).float()
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    clear, onehot, _ = _slots(D, t, delays, cuda)
    before = split_mod.POST_COUNTER.launches
    if clear_it:
        got = ops.fused_post_exchange(act, ring, clear, onehot, cols, weights,
                                      reduce=panel_reduce(weights))
        want = ref.fused_post_exchange_ref(act, ring, clear, onehot, cols, weights)
    else:
        got = ops.fused_post_exchange_remote(act, ring, onehot, cols, weights,
                                             reduce=panel_reduce(weights))
        want = ref.fused_post_exchange_remote_ref(act, ring, onehot, cols, weights)
    assert split_mod.POST_COUNTER.launches == before + 1
    exact = _ring_by_kernels(act, ring, clear if clear_it else None, onehot, cols, weights, n_p)
    assert torch.equal(got, exact)
    assert torch.equal(got.view(torch.int32), exact.view(torch.int32))  # signed zeros too
    forced = split_mod.post_exchange_cuda(act, ring, clear if clear_it else None, onehot, cols,
                                          weights, reduce="row_dot")
    assert torch.equal(got.view(torch.int32), forced.view(torch.int32))
    # f32 sums in another order: rtol=atol=1e-5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    inplace = ring.clone()
    if clear_it:
        ops.fused_post_exchange(act, inplace, clear, onehot, cols, weights, out=inplace,
                                reduce=panel_reduce(weights))
    else:
        ops.fused_post_exchange_remote(act, inplace, onehot, cols, weights, out=inplace,
                                       reduce=panel_reduce(weights))
    assert torch.equal(inplace.view(torch.int32), got.view(torch.int32))


@pytest.mark.parametrize("n_p,n,R,ks,remote", [
    (64, 256, 64, (16,), False),
    (100, 400, 104, (8, 24), True),
    (3125, 12500, 3128, (128,) * 15, False),  # balanced_ei(12500) at k=4
    (3125, 12500, 3128, (128,) * 15, True),
])
def test_post_exchange_plastic_kernel_vs_unfused_kernels(cuda, rng, n_p, n, R, ks, remote):
    D, t = 16, 9
    delays = list(range(1, len(ks) + 1))
    cols, weights = _panels(rng, n, R, ks, n_p, cuda)
    plastic = _masks(rng, R, ks, n_p, cuda)
    act = (_vec(rng, n, cuda) < 0.1).float()
    pre = _vec(rng, n, cuda)
    post_t, post_s = _vec(rng, n_p, cuda), (_vec(rng, n_p, cuda) < 0.2).float()
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    clear, onehot, _ = _slots(D, t, delays, cuda)
    act_g = act.clone()
    if remote:
        act_g[:n_p] = 0.0  # partition 0's own slice
    before = split_mod.PLASTIC_COUNTER.launches
    if remote:
        new_ring, new_w = ops.fused_post_exchange_remote_plastic(
            act_g, act, pre, ring, onehot, post_t, post_s, cols, weights, plastic, stdp=STDP)
        want = ref.fused_post_exchange_remote_plastic_ref(
            act_g, act, pre, ring, onehot, post_t, post_s, cols, weights, plastic, stdp=STDP)
    else:
        new_ring, new_w = ops.fused_post_exchange_plastic(
            act, pre, ring, clear, onehot, post_t, post_s, cols, weights, plastic, stdp=STDP)
        want = ref.fused_post_exchange_plastic_ref(
            act, pre, ring, clear, onehot, post_t, post_s, cols, weights, plastic, stdp=STDP)
    assert split_mod.PLASTIC_COUNTER.launches == before + 1
    exact = _ring_by_kernels(act_g, ring, None if remote else clear, onehot, cols, weights, n_p)
    assert torch.equal(new_ring.view(torch.int32), exact.view(torch.int32))
    torch.testing.assert_close(new_ring, want[0], rtol=1e-5, atol=1e-5)
    pad = R - n_p
    pt, ps = (torch.nn.functional.pad(x, (0, pad)) for x in (post_t, post_s))
    for nw, c, w, pm, pw in zip(new_w, cols, weights, plastic, want[1]):
        assert torch.equal(nw, ops.stdp_update(w, pm, c, pre, act, pt, ps, params=STDP))
        assert torch.equal(nw, pw)
    assert any(not torch.equal(a, b) for a, b in zip(new_w, weights))


@pytest.mark.parametrize("slot", [5, None])
def test_event_kernel_split_use(cuda, rng, slot):
    """(n_global,) activity, (D, n_p) ring, per-partition touch bitmaps over
    n_global ids, with and without the clear."""
    n_p, n, R, ks, cap = 5000, 20000, 5000, (128, 384), 1000
    D, t = 16, 21
    delays = (8, 15)
    cols, weights = _panels(rng, n, R, ks, n_p, cuda)
    # each 128-row block reads a window of 500 ids of its own, so a few
    # spikes flag a few blocks and leave the rest
    window = torch.arange(R, device=cuda)[:, None] // 128 * 500
    cols = [(c % 500 + window).to(torch.int32) for c in cols]
    valid = [(w != 0).cpu().numpy() for w in weights]
    plan = event_mod.EventPlan.build([c.cpu().numpy() for c in cols], valid, n, cap, cuda)
    act = (_vec(rng, n, cuda) < 0.0005).float()
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    write = [(t + d) % D for d in delays]
    got, want = ring.clone(), ring.clone()
    flags = ops.event_post_exchange(act, got, slot, write, plan, cols, weights,
                                    reduce=panel_reduce(weights))
    want_flags = event_mod.event_post_exchange_plain(act, want, slot, write, plan, cols, weights)
    assert torch.equal(flags, want_flags) and 0 < int(flags.sum()) < flags.numel()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dense = ring.clone()
    if slot is not None:
        dense[slot] = 0.0
    for c, w, ws in zip(cols, weights, write):
        dense[ws] += ops.spike_gather(act, c, w, reduce=panel_reduce([w]))[:n_p]
    assert torch.equal(got, dense)
    # with the row lengths: the same ring, equal to the row_dot kernels'
    with_len = ring.clone()
    ops.event_post_exchange(act, with_len, slot, write, plan, cols, weights,
                            _row_lengths(valid, cuda), reduce=panel_reduce(weights))
    assert torch.equal(with_len, got)
    clear, onehot, _ = _slots(D, t, delays, cuda)
    if slot is None:
        row_dot = ops.fused_post_exchange_remote(act, ring, onehot, cols, weights,
                                                 reduce="row_dot")
    else:
        row_dot = ops.fused_post_exchange(act, ring, clear, onehot, cols, weights,
                                          reduce="row_dot")
    assert torch.equal(got, row_dot)


# -- row lengths and the activity bitmask: the redesigned gathers -------------
#
# spike_gather and event_post_exchange read only a row's first row_len[r]
# slots and only the weights of active sources.  They must equal the dense
# row_dot kernels (post_exchange, through the reference's ring formulation)
# bit for bit on every row length around the warp width and every kind of
# activity vector.

ROW_LENS = (0, 1, 31, 32, 33, 127, 128, 129)
# more ids than the bitmask can stage in 227 KB of shared memory
LONG_N = 232448 * 8 + 100_000


def _row_lengths(valid, device):
    return [torch.from_numpy(np.asarray(v).sum(axis=1).astype(np.int32)).to(device)
            for v in valid]


def _ell_case(rng, n, R, ks, n_rows, device):
    """Panels as the ELL builder lays them out: row r holds row_len[r]
    synapses first (normal weights, so negative ones among them) and
    ``(col 0, weight 0)`` after; the first rows are ROW_LENS and K long,
    the rest random; rows past n_rows are empty."""
    cols, weights, valid = [], [], []
    for K in ks:
        rl = rng.integers(0, K + 1, R)
        fixed = [min(x, K) for x in ROW_LENS] + [K]
        rl[: len(fixed)] = fixed[: R]
        rl[n_rows:] = 0
        below = np.arange(K)[None, :] < rl[:, None]
        cols.append(torch.from_numpy(
            np.where(below, rng.integers(0, n, (R, K)), 0).astype(np.int32)).to(device))
        weights.append(torch.from_numpy(
            np.where(below, rng.normal(size=(R, K)), 0.0).astype(np.float32)).to(device))
        valid.append(below)
    return cols, weights, valid


def _activity(kind, rng, n, device):
    if kind == "zero":
        a = np.zeros(n, np.float32)
    elif kind == "one spike":
        a = np.zeros(n, np.float32)
        a[n // 3] = 1.0
    elif kind == "all":
        a = np.ones(n, np.float32)
    elif kind == "5%":
        a = (rng.random(n) < 0.05).astype(np.float32)
    else:  # non-binary: 0.5 on 5% of the ids, -0.0 on a seventh
        a = np.where(rng.random(n) < 0.05, 0.5, 0.0).astype(np.float32)
        a[::7] = -0.0
    return torch.from_numpy(a).to(device)


ACT_KINDS = ("zero", "one spike", "all", "5%", "non-binary")


@pytest.mark.parametrize("kind", ACT_KINDS)
@pytest.mark.parametrize("n_p,n,R,ks", [
    (100, 400, 104, (8, 40)),
    (500, 2000, 504, (129, 300)),
    (19293, 77172, 19296, (384, 1280)),  # microcircuit k=4 widths
])
def test_spike_gather_row_len_equals_row_dot_kernels(cuda, rng, kind, n_p, n, R, ks):
    D, t = 16, 21
    delays = [1 + (3 * i) % D for i in range(len(ks))]
    cols, weights, valid = _ell_case(rng, n, R, ks, n_p, cuda)
    row_len = _row_lengths(valid, cuda)
    act = _activity(kind, rng, n, cuda)
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    clear, onehot, _ = _slots(D, t, delays, cuda)
    before = gather_mod.COUNTER.launches
    curs = [ops.spike_gather(act, c, w, rl, reduce=panel_reduce([w]))
            for c, w, rl in zip(cols, weights, row_len)]
    assert gather_mod.COUNTER.launches == before + len(cols)
    for cur, c, w, rl in zip(curs, cols, weights, row_len):
        assert torch.equal(cur, ops.spike_gather(act, c, w, reduce=panel_reduce([w])))
        assert torch.equal(cur, gather_mod.spike_gather_cuda(act, c, w, rl,
                                                             reduce=panel_reduce([w]),
                                                             shared_bitmask=False))
        # f32 sums in another order; with every id active a row sums up to
        # 1,280 unit-normal terms, whose rounding reaches 1.2e-5 (measured on
        # an H100): rtol=1e-5, atol=1e-4
        torch.testing.assert_close(cur, ref.spike_gather_ref(act, c, w), rtol=1e-5, atol=1e-4)
    exact = ref._ring_accumulate(ring, clear, onehot, [cur[:n_p] for cur in curs])
    row_dot = ops.fused_post_exchange(act, ring, clear, onehot, cols, weights, reduce="row_dot")
    assert torch.equal(row_dot.view(torch.int32), exact.view(torch.int32))  # signed zeros too


@pytest.mark.parametrize("kind", ACT_KINDS)
@pytest.mark.parametrize("slot", [5, None])
def test_event_kernel_row_len_equals_row_dot_kernels(cuda, rng, kind, slot):
    """The split use's shapes (an (n_global,) activity, a (D, n_p) ring),
    with the clear (as at k=1) and without (the remote pass)."""
    n_p, n, R, ks, cap = 5000, 20000, 5000, (129, 384), 1000
    D, t = 16, 21
    delays = (8, 15)
    cols, weights, valid = _ell_case(rng, n, R, ks, n_p, cuda)
    plan = event_mod.EventPlan.build([c.cpu().numpy() for c in cols], valid, n, cap, cuda)
    act = _activity(kind, rng, n, cuda)
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    clear, onehot, write = _slots(D, t, delays, cuda)
    row_len = _row_lengths(valid, cuda)
    got = ring.clone()
    before = event_mod.COUNTER.launches
    flags = ops.event_post_exchange(act, got, slot, write, plan, cols, weights, row_len,
                                    reduce=panel_reduce(weights))
    assert event_mod.COUNTER.launches == before + 1
    want, via_l2, no_len = ring.clone(), ring.clone(), ring.clone()
    want_flags = event_mod.event_post_exchange_plain(act, want, slot, write, plan, cols,
                                                     weights, row_len)
    assert torch.equal(flags, want_flags)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    event_mod.event_post_exchange_cuda(act, via_l2, slot, write, plan, cols, weights, row_len,
                                       shared_bitmask=False, reduce=panel_reduce(weights))
    ops.event_post_exchange(act, no_len, slot, write, plan, cols, weights,
                            reduce=panel_reduce(weights))
    assert torch.equal(via_l2, got) and torch.equal(no_len, got)
    if slot is None:
        row_dot = ops.fused_post_exchange_remote(act, ring, onehot, cols, weights,
                                                 reduce="row_dot")
    else:
        row_dot = ops.fused_post_exchange(act, ring, clear, onehot, cols, weights,
                                          reduce="row_dot")
    assert torch.equal(got, row_dot)
    dense = ring.clone()
    if slot is not None:
        dense[slot] = 0.0
    for c, w, rl, ws in zip(cols, weights, row_len, write):
        dense[ws] += ops.spike_gather(act, c, w, rl, reduce=panel_reduce([w]))[:n_p]
    assert torch.equal(got, dense)


@pytest.mark.parametrize("kind", ("one spike", "5%", "all"))
def test_gathers_with_a_bitmask_too_long_for_shared_memory(cuda, rng, kind):
    """LONG_N ids: the bitmask is read from device memory, in both kernels."""
    n_p, R, ks, cap, D, t = 512, 512, (129, 300), 4096, 16, 3
    delays = (2, 9)
    cols, weights, valid = _ell_case(rng, LONG_N, R, ks, n_p, cuda)
    row_len = _row_lengths(valid, cuda)
    act = _activity(kind, rng, LONG_N, cuda)
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    clear, onehot, write = _slots(D, t, delays, cuda)
    curs = [ops.spike_gather(act, c, w, rl, reduce=panel_reduce([w]))
            for c, w, rl in zip(cols, weights, row_len)]
    for cur, c, w in zip(curs, cols, weights):
        assert torch.equal(cur, ops.spike_gather(act, c, w, reduce=panel_reduce([w])))
        torch.testing.assert_close(cur, ref.spike_gather_ref(act, c, w), rtol=1e-5, atol=1e-5)
    row_dot = ops.fused_post_exchange(act, ring, clear, onehot, cols, weights, reduce="row_dot")
    exact = ref._ring_accumulate(ring, clear, onehot, [cur[:n_p] for cur in curs])
    assert torch.equal(row_dot.view(torch.int32), exact.view(torch.int32))
    # post_exchange's active variant with the activity tested in device
    # memory (no bitmask), as it runs for so many ids
    active = split_mod.post_exchange_cuda(act, ring, clear, onehot, cols, weights, row_len,
                                          reduce=panel_reduce(weights))
    assert torch.equal(active.view(torch.int32), row_dot.view(torch.int32))
    plan = event_mod.EventPlan.build([c.cpu().numpy() for c in cols], valid, LONG_N, cap, cuda)
    got = ring.clone()
    ops.event_post_exchange(act, got, t % D, write, plan, cols, weights, row_len,
                            reduce=panel_reduce(weights))
    assert torch.equal(got, row_dot)


def test_gathers_refuse_bad_row_lengths(cuda):
    act = torch.zeros(32, device=cuda)
    c = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    w = torch.zeros((8, 4), device=cuda)
    good = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        gather_mod.spike_gather_cuda(act, c, w, good.long())
    with pytest.raises(ValueError, match="row_len"):
        gather_mod.spike_gather_cuda(act, c, w, good[:4])
    with pytest.raises(ValueError, match="CUDA"):
        gather_mod.spike_gather_cuda(act, c, w, good.cpu())
    plan = event_mod.EventPlan.build([c.cpu().numpy()], [np.zeros((8, 4), bool)], 32, 32, cuda)
    ring = torch.zeros((4, 8), device=cuda)
    with pytest.raises(ValueError, match="row_len"):
        event_mod.event_post_exchange_cuda(act, ring, 0, [1], plan, [c], [w], [good, good])
    with pytest.raises(ValueError, match="row_len"):
        event_mod.event_post_exchange_cuda(act, ring, 0, [1], plan, [c], [w], [good[:4]])


def test_split_kernels_refuse_bad_operands(cuda):
    D, n_p = 4, 8
    ring = torch.zeros((D, n_p), device=cuda)
    act = torch.zeros(32, device=cuda)
    c = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    w = torch.zeros((8, 4), device=cuda)
    oh = torch.zeros((1, D), device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        split_mod.post_exchange_cuda(act.cpu(), ring.cpu(), None, oh.cpu(), [c.cpu()], [w.cpu()])
    with pytest.raises(ValueError, match="write_onehot"):
        split_mod.post_exchange_cuda(act, ring, None, torch.zeros((2, D), device=cuda), [c], [w])
    with pytest.raises(ValueError, match="clear_mask"):
        split_mod.post_exchange_cuda(act, ring, torch.ones(3, device=cuda), oh, [c], [w])
    with pytest.raises(ValueError, match="rows"):
        split_mod.post_exchange_cuda(act, ring, None, oh, [c[:4]], [w[:4]])
    with pytest.raises(ValueError, match="post_trace"):
        split_mod.post_exchange_plastic_cuda(act, act, act, ring, None, oh, act, act, [c], [w],
                                             [w], stdp=STDP)
    with pytest.raises(ValueError, match="shape"):
        split_mod.pre_exchange_cuda(act, act, act, act, act[:4], params=LIF_PARAMS, taus=TAUS)


@pytest.mark.parametrize("kind,exchange,overlap", [
    ("plain", "index", "auto"), ("plain", "dense", "off"), ("plain", "index", "double_buffer"),
    ("plastic", "dense", "auto"), ("plastic", "index", "off"),
])
def test_dist_engine_on_one_card_matches_k1(cuda, kind, exchange, overlap):
    """k=4 partitions on one card (devices=[card] * 4) against the k=1 run
    of the merged net on the card: the same raster, traces and weights."""
    from repro_torch.core import block_partition, merge_to_single
    from repro_torch.snn import (
        RasterMonitor, Session, SimConfig, balanced_ei, microcircuit, to_dcsr,
    )

    net = balanced_ei(n=2000, stdp=True, seed=0) if kind == "plastic" else \
        microcircuit(scale=0.05, seed=0)
    d = to_dcsr(net, assignment=block_partition(net.n, 4), uniform=True)
    base = Session(merge_to_single(d), SimConfig(), device=cuda)
    mb = RasterMonitor()
    base.run(300, monitors=[mb])
    ses = Session(d, SimConfig(exchange=exchange, overlap=overlap), engine="spmd",
                  devices=[cuda] * 4)
    want = "fused_split_plastic" if kind == "plastic" else "fused_split"
    assert ses.engine_choice.engine == want
    assert ses.engine_choice.overlap == ("local" if overlap == "auto" else overlap)
    m = RasterMonitor()
    res = ses.run(300, monitors=[m])
    assert mb.raster.sum() > 0 and int(res.overflow.sum()) == 0
    np.testing.assert_array_equal(m.raster, mb.raster)
    if kind == "plain":
        assert "event" in ses.last_gather_modes
    for name in ("tr_plus", "tr_minus", "hist", "vtx_state", "ring"):
        got = torch.cat([c[name] for c in ses.state], dim=1 if name in ("hist", "ring") else 0)
        if name in ("vtx_state", "ring") and ses.engine_choice.overlap != "off":
            # the remote pass adds on top of the local pass's ring: the
            # sums round in another order
            torch.testing.assert_close(got, base.state[name], rtol=1e-5, atol=1e-5)
        else:
            assert torch.equal(got, base.state[name]), name
    n_p = d.parts[0].n
    for i, w1 in enumerate(base.state["weights"]):
        got = torch.cat([c["weights"][i][:n_p] for c in ses.state])
        assert torch.equal(got, w1[: 4 * n_p])


# -- the builder keystream ----------------------------------------------------

def _keystream_rows(kind, rng):
    if kind == "chunk":  # the largest build call's rows (8,192 x 11,136 words)
        return np.arange(20683, 20683 + 8192, dtype=np.int64)
    rows = rng.integers(0, 2**31, 50_000, dtype=np.int64)
    rows[::7] = rows[3]  # repeats
    rows[-3:] = 2**31 - 1
    return rows


@pytest.mark.parametrize("kind,j0,n_words", [
    ("chunk", 0, 11136), ("gathered", 3, 1001), ("gathered", 0, 4), ("gathered", 1, 1),
    ("gathered", 2, 6), ("gathered", 5, 2),
])
def test_keystream_kernel_bit_exact(cuda, rng, kind, j0, n_words):
    from repro_torch.builder import crng

    rows = _keystream_rows(kind, rng)
    t = torch.from_numpy(rows).to(cuda)
    seed, stream = 7, crng.rule_stream(6, crng.WEIGHT_OFF)
    before = ks_mod.COUNTER.launches
    got = ops.builder_keystream(seed, stream, t, j0, n_words)
    assert ks_mod.COUNTER.launches == before + 1
    assert got.shape == (len(rows), n_words) and got.dtype == torch.int32
    assert torch.equal(got, ks_mod.keystream_plain(seed, stream, t, j0, n_words))
    np.testing.assert_array_equal(ks_mod.as_uint32(got),
                                  crng.word_matrix(seed, stream, rows, j0, n_words))


# the kernel's work items: a persistent grid over (row, group of 4 counter
# pairs), 16-byte stores away from a row's first and last words
@pytest.mark.parametrize("n_rows,j0,n_words", [
    (1, 0, 1), (1, 1, 1), (255, 0, 2), (257, 1, 2), (1000, 3, 1), (4097, 5, 2),
    (333, 0, 7), (333, 1, 8), (333, 3, 9), (77, 5, 15), (77, 0, 16), (77, 2, 17),
    (129, 7, 4097), (3, 1, 11137), (65, 2**32 - 37, 37), (65, 2**32 - 8, 8),
])
def test_keystream_kernel_edges_bit_exact(cuda, rng, n_rows, j0, n_words):
    """Rows not a multiple of a block's items, pairs not a multiple of G,
    odd j0 with odd tails, one and two words a row, counters 2^31-1 and up to
    2^32-1, words up to 2^32: torch.equal to the plain version and numpy."""
    from repro_torch.builder import crng

    rows = rng.integers(0, 2**32, n_rows, dtype=np.int64)
    rows[::3] = 2**31 - 1
    rows[1::5] = 2**32 - 1
    t = torch.from_numpy(rows).to(cuda)
    seed, stream = 11, crng.rule_stream(3, crng.SRC_OFF)
    before = ks_mod.COUNTER.launches
    got = ks_mod.keystream_cuda(seed, stream, t, j0, n_words)
    assert ks_mod.COUNTER.launches == before + 1
    assert torch.equal(got, ks_mod.keystream_plain(seed, stream, t, j0, n_words))
    np.testing.assert_array_equal(ks_mod.as_uint32(got),
                                  crng.word_matrix(seed, stream, rows, j0, n_words))


@pytest.mark.parametrize("n_rows,n_words", [(0, 5), (3, 0), (0, 0)])
def test_keystream_empty_calls_launch_nothing(cuda, n_rows, n_words):
    before = ks_mod.COUNTER.launches
    got = ops.builder_keystream(1, 2, torch.arange(n_rows, device=cuda), 0, n_words)
    assert got.shape == (n_rows, n_words) and got.device.type == "cuda"
    assert ks_mod.COUNTER.launches == before


def test_keystream_kernel_refuses_bad_operands(cuda):
    with pytest.raises(ValueError, match="CUDA"):
        ks_mod.keystream_cuda(1, 2, torch.arange(4), 0, 4)
    with pytest.raises(TypeError):
        ks_mod.keystream_cuda(1, 2, torch.arange(4, device=cuda).int(), 0, 4)
    with pytest.raises(ValueError, match="contiguous"):
        ks_mod.keystream_cuda(1, 2, torch.arange(8, device=cuda)[::2], 0, 4)
    for rows in ([-1, 3], [2**32]):
        with pytest.raises(ValueError, match="rows"):
            ks_mod.keystream_cuda(1, 2, torch.tensor(rows, device=cuda), 0, 4)
    with pytest.raises(ValueError, match="seed"):
        ks_mod.keystream_cuda(2**32, 2, torch.arange(4, device=cuda), 0, 4)
    with pytest.raises(ValueError, match="2\\^32"):
        ks_mod.keystream_cuda(1, 2, torch.arange(4, device=cuda), 2**32 - 1, 4)


def test_rule_built_net_on_card_equals_numpy_build(cuda):
    from repro_torch.builder import balanced_ei_rules, build_network, microcircuit_rules

    for spec in (microcircuit_rules(scale=0.02, seed=1), balanced_ei_rules(n=1000, seed=2)):
        before = ks_mod.COUNTER.launches
        got = build_network(spec, 4, uniform=True, device=cuda)
        want = build_network(spec, 4, uniform=True, path="ref")
        rep = got.build_report
        assert rep.keystream_calls > 0 and rep.d2h_bytes == 4 * rep.keystream_words
        assert ks_mod.COUNTER.launches - before == rep.keystream_calls
        for a, b in zip(got.parts, want.parts):
            for key in ("row_ptr", "col_idx", "edge_model", "edge_state", "vtx_state", "coords",
                        "global_ids"):
                np.testing.assert_array_equal(getattr(a, key), getattr(b, key), err_msg=key)


# -- the per-step noise ---------------------------------------------------------

@pytest.mark.parametrize("seed,n", [(42, 1), (42, 77172), (7, 1_048_576), (2**32 + 3, 5000)])
def test_noise_kernel_bit_exact_vs_plain(cuda, seed, n):
    """The kernel draws the plain version's noise bit for bit (the same
    correctly rounded operations), over both of erfinv's branches."""
    from repro_torch.kernels import noise as noise_mod

    tail = 0
    for t in (0, 1, 999, 2**31 + 7):
        before = noise_mod.COUNTER.launches
        got = ops.step_noise(seed, t, n, 0.8, device=cuda)
        assert noise_mod.COUNTER.launches == before + 1
        want = ref.step_noise_ref(seed, t, n, 0.8, device=cuda)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        assert torch.equal(got.cpu().view(torch.int32),
                           ref.step_noise_ref(seed, t, n, 0.8).view(torch.int32))
        tail += int((got.abs() > 0.8 * 2.72).sum())
    if n >= 77172:
        assert tail > 0  # the w >= 5 branch of erfinv was taken


def _noise_add_case(rng, n, device):
    ids = rng.permutation(n).astype(np.int64)
    ids[::5] += 2**32 + 17  # ids past 2^32
    ids[1::11] = ids[0]  # repeats
    x = rng.normal(size=n).astype(np.float32)
    vtx = rng.normal(size=(n, 4)).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x, ids, vtx)]


@pytest.mark.parametrize("n", [1, 77172, 1_048_576])
def test_noise_add_kernel_bit_exact_vs_plain(cuda, rng, n):
    """One launch draws the noise at the given ids and adds it to x (and a
    strided bias): the plain version's bits, and the full vector's value at
    each id."""
    from repro_torch.kernels import noise as noise_mod

    x, ids, vtx = _noise_add_case(rng, n, cuda)
    for t in (0, 1, 999, 2**31 + 3):
        for bias in (None, vtx[:, 3]):
            before = noise_mod.COUNTER.launches
            got = ops.step_noise_add(x, ids, 42, t, 0.8, bias)
            assert noise_mod.COUNTER.launches == before + 1
            want = ref.step_noise_add_ref(x, ids, 42, t, 0.8, bias)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    small = ids % 2**20
    full = ops.step_noise(42, 5, 2**20, 0.8, device=cuda)
    got = ops.step_noise_add(x, small, 42, 5, 0.8, vtx[:, 3])
    want = (x + full.index_select(0, small)) + vtx[:, 3]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_noise_add_kernel_refuses_bad_operands(cuda):
    from repro_torch.kernels import noise as noise_mod

    x = torch.zeros(8, device=cuda)
    ids = torch.arange(8, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        noise_mod.noise_add_cuda(x.cpu(), ids.cpu(), 1, 0, 1.0)
    with pytest.raises(TypeError):
        noise_mod.noise_add_cuda(x, ids.int(), 1, 0, 1.0)
    with pytest.raises(ValueError, match="ids"):
        noise_mod.noise_add_cuda(x, ids[:7].contiguous(), 1, 0, 1.0)
    with pytest.raises(ValueError, match="bias"):
        noise_mod.noise_add_cuda(x, ids, 1, 0, 1.0, torch.zeros(7, device=cuda))
    with pytest.raises(ValueError, match=">= 0"):
        noise_mod.noise_add_cuda(x, ids, 1, -1, 1.0)
    before = noise_mod.COUNTER.launches
    empty = torch.zeros(0, device=cuda)
    assert noise_mod.noise_add_cuda(empty, ids[:0], 1, 0, 1.0).shape == (0,)
    assert noise_mod.COUNTER.launches == before


def test_noise_kernel_refuses_bad_operands(cuda):
    from repro_torch.kernels import noise as noise_mod

    with pytest.raises(ValueError, match="CUDA"):
        noise_mod.noise_cuda(1, 0, 10, 1.0, device="cpu")
    with pytest.raises(ValueError, match=">= 0"):
        noise_mod.noise_cuda(1, -1, 10, 1.0, device=cuda)
    assert noise_mod.noise_cuda(1, 0, 0, 1.0, device=cuda).shape == (0,)


# -- fused_step and post_exchange: active == the forced row_dot variant ---------

@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("n_p,R,ks", [
    (100, 104, (8, 40)),
    (500, 504, (129, 300)),
    (19293, 19296, (512, 1408)),  # microcircuit(0.25) panel widths
])
def test_fused_step_active_equals_forced_row_dot(cuda, rng, shared, n_p, R, ks):
    v, r, i = _lif_inputs(rng, n_p, cuda)
    cols, weights, valid = _ell_case(rng, n_p, R, ks, n_p, cuda)
    row_len = _row_lengths(valid, cuda)
    got = fused_mod.fused_step_cuda(v, r, i, cols, weights, row_len, params=LIF_PARAMS,
                                    reduce=panel_reduce(weights), shared_bitmask=shared)
    forced = fused_mod.fused_step_cuda(v, r, i, cols, weights, params=LIF_PARAMS,
                                       reduce="row_dot")
    assert 0 < int(got[2].sum()) < n_p
    for a, b in zip(got[:3], forced[:3]):
        assert torch.equal(a, b)
    for a, b, c, w, rl in zip(got[3], forced[3], cols, weights, row_len):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a, ops.spike_gather(got[2], c, w, rl, reduce=panel_reduce([w])))
    _, _, _, curs_p = ref.fused_step_ref(v, r, i, cols, weights, params=LIF_PARAMS)
    for a, b in zip(got[3], curs_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ACT_KINDS)
@pytest.mark.parametrize("what", ["full", "local", "remote"])
def test_post_exchange_passes_active_equal_forced_row_dot(cuda, rng, kind, what):
    """The three passes at the k=4 microcircuit's partition shapes: the full
    pass and the local pass (local ids, the own (n_p,) activity) with the
    clear, the remote pass without; with the bitmask in shared memory and
    with the activity tested in device memory."""
    n_p, n, R, D, t = 19293, 77172, 19296, 16, 21
    ks = (384, 1280) if what != "remote" else (512, 3840)
    delays = (8, 15)
    n_act = n_p if what == "local" else n
    cols, weights, valid = _ell_case(rng, n_act, R, ks, n_p, cuda)
    row_len = _row_lengths(valid, cuda)
    act = _activity(kind, rng, n_act, cuda)
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    clear, onehot, _ = _slots(D, t, delays, cuda)
    cl = None if what == "remote" else clear
    before = split_mod.POST_COUNTER.launches
    recorded = panel_reduce(weights)
    assert recorded == ("active", "active")
    got = split_mod.post_exchange_cuda(act, ring, cl, onehot, cols, weights, row_len,
                                       reduce=recorded)
    assert split_mod.POST_COUNTER.launches == before + 1
    forced = split_mod.post_exchange_cuda(act, ring, cl, onehot, cols, weights,
                                          reduce="row_dot")
    in_memory = split_mod.post_exchange_cuda(act, ring, cl, onehot, cols, weights, row_len,
                                             reduce=recorded, shared_bitmask=False)
    assert torch.equal(got.view(torch.int32), forced.view(torch.int32))
    assert torch.equal(in_memory.view(torch.int32), forced.view(torch.int32))
    inplace = ring.clone()
    split_mod.post_exchange_cuda(act, inplace, cl, onehot, cols, weights, row_len,
                                 reduce=recorded, out=inplace)
    assert torch.equal(inplace.view(torch.int32), got.view(torch.int32))
    want = (ref.fused_post_exchange_remote_ref(act, ring, onehot, cols, weights)
            if cl is None else ref.fused_post_exchange_ref(act, ring, cl, onehot, cols, weights))
    # f32 sums in another order; with every id active a row sums up to
    # 3,840 unit-normal terms: rtol=1e-5, atol=1e-4 (as the gathers above)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


# -- a NaN weight: every gather takes its row_dot variant ----------------------

def _nan_panels(rng, act, cols, weights, valid, rows):
    """One real slot of each row in ``rows`` whose source is silent in
    ``act`` set to NaN; returns the new weight panel."""
    w = weights.clone()
    a = act.cpu().numpy()
    c = cols.cpu().numpy()
    for r in rows:
        silent = [j for j in np.flatnonzero(valid[r]) if a[c[r, j]] == 0]
        w[r, silent[rng.integers(len(silent))]] = float("nan")
    return w


def test_nan_weight_switches_every_gather_to_row_dot(cuda, rng):
    """A NaN weight on a silent source: the choice recorded from the weights
    (``panel_reduce``) is ``row_dot`` for its panel, which runs the row_dot
    variant of spike_gather, the event kernel, fused_step and post_exchange;
    they give NaN in exactly the plain version's rows.  The active variant,
    forced, would skip the slot."""
    n_p, R, ks, D, t = 5000, 5000, (129, 384), 16, 21
    delays = (8, 15)
    v, r, i = _lif_inputs(rng, n_p, cuda)
    spikes = ref.lif_step_ref(v, r, i, **LIF_PARAMS)[2]
    cols, weights, valid = _ell_case(rng, n_p, R, ks, n_p, cuda)
    # rows 3 and 8 are 32 and K long (ROW_LENS), the third a long row later
    nan_rows = [3, 8, next(rr for rr in range(3000, n_p) if valid[1][rr].sum() > 100)]
    weights[1] = _nan_panels(rng, spikes, cols[1], weights[1], valid[1], nan_rows)
    row_len = _row_lengths(valid, cuda)
    recorded = panel_reduce(weights)
    assert recorded == ("active", "row_dot")

    def rows_of(x):
        return torch.isnan(x).reshape(-1, x.shape[-1]).any(0).nonzero().flatten().tolist()

    # spike_gather, from the spike vector
    got = ops.spike_gather(spikes, cols[1], weights[1], row_len[1], reduce=recorded[1:])
    assert rows_of(got) == rows_of(ref.spike_gather_ref(spikes, cols[1], weights[1])) == nan_rows
    active = ops.spike_gather(spikes, cols[1], weights[1], row_len[1], reduce=("active",))
    assert not torch.isnan(active).any()
    # fused_step
    got = ops.fused_step(v, r, i, cols, weights, row_len, params=LIF_PARAMS, reduce=recorded)
    want = ref.fused_step_ref(v, r, i, cols, weights, params=LIF_PARAMS)
    assert torch.equal(got[2], want[2]) and torch.equal(got[2], spikes)
    assert rows_of(got[3][1]) == rows_of(want[3][1]) == nan_rows
    assert not torch.isnan(got[3][0]).any()
    # post_exchange, with the clear and without
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    clear, onehot, write = _slots(D, t, delays, cuda)
    for cl in (clear, None):
        got = split_mod.post_exchange_cuda(spikes, ring, cl, onehot, cols, weights, row_len,
                                           reduce=recorded)
        want = (ref.fused_post_exchange_remote_ref(spikes, ring, onehot, cols, weights)
                if cl is None else
                ref.fused_post_exchange_ref(spikes, ring, cl, onehot, cols, weights))
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert rows_of(got) == nan_rows
    # the event kernel: every NaN row's block is flagged by some spike
    plan = event_mod.EventPlan.build([c.cpu().numpy() for c in cols], valid, n_p, 1000, cuda,
                                     block_r=128)
    got, want = ring.clone(), ring.clone()
    flags = ops.event_post_exchange(spikes, got, t % D, write, plan, cols, weights, row_len,
                                    reduce=recorded)
    event_mod.event_post_exchange_plain(spikes, want, t % D, write, plan, cols, weights)
    assert all(int(flags[1, rr // 128]) for rr in nan_rows)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert rows_of(got) == nan_rows


# -- the step front: noise, bias, LIF in place, history row in one launch ---------

def _front_case(rng, n, ld, device):
    """vtx_state (v, refrac, bias, and columns the front must leave alone),
    a ring slot with signed zeros and a NaN, ids past 2^32 and repeated,
    both traces with signed zeros, a history row."""
    vtx = rng.normal(size=(n, ld)).astype(np.float32)
    vtx[:, 0] = -66.0 + 20.0 * rng.random(n)
    vtx[:, 1] = rng.integers(0, 3, n)
    vtx[:, 2] = rng.normal(0.0, 5.0, n)
    slot = rng.normal(0.0, 10.0, n).astype(np.float32)
    slot[::7], slot[3::7] = -0.0, 0.0
    slot[min(5, n - 1)] = np.nan
    ids = rng.permutation(n).astype(np.int64)
    ids[::5] += 2**32 + 17
    ids[1::11] = ids[0]
    tp, tm = rng.random(n).astype(np.float32), rng.random(n).astype(np.float32)
    tp[::4], tm[1::4] = -0.0, -0.0
    hist = rng.integers(0, 2, n).astype(np.uint8)
    return [torch.from_numpy(a).to(device) for a in (vtx, slot, ids, tp, tm, hist)]


@pytest.mark.parametrize("traces", [False, True])
@pytest.mark.parametrize("draw,bias", [(True, True), (False, True), (True, False),
                                       (False, False)])
@pytest.mark.parametrize("n,ld", [(1, 3), (1000, 4), (19293, 4), (77172, 4)])
def test_step_front_kernel_bit_exact(cuda, rng, n, ld, draw, bias, traces):
    """The kernel against its plain version on the card: spikes, traces,
    vtx_state (every column) and the history row bit for bit, signed zeros
    and NaN too; one launch."""
    vtx, slot, ids, tp, tm, hist = _front_case(rng, n, ld, cuda)
    for t in (0, 999, 2**31 + 3):
        kw = dict(seed=42, t=t, sigma=0.8, draw=draw, bias=bias,
                  tr_plus=tp if traces else None, tr_minus=tm if traces else None,
                  params=LIF_PARAMS, taus=TAUS if traces else None)
        vtx_k, hist_k, vtx_p, hist_p = vtx.clone(), hist.clone(), vtx.clone(), hist.clone()
        before = front_mod.COUNTER.launches
        got = ops.step_front(vtx_k, slot, ids, hist_row=hist_k, **kw)
        assert front_mod.COUNTER.launches == before + 1
        want = ref.step_front_ref(vtx_p, slot, ids, hist_row=hist_p, **kw)
        assert len(got) == len(want) == (3 if traces else 1)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(vtx_k.view(torch.int32), vtx_p.view(torch.int32))
        assert torch.equal(hist_k, hist_p)
    assert 0 < int(got[0].sum()) < n or n == 1


def test_step_front_kernel_is_the_old_chain(cuda, rng):
    """The front's kernel against the kernels of the chain it replaced, on
    the card: noise_add, lif_step or pre_exchange, the column writes."""
    n = 19293
    vtx, slot, ids, tp, tm, hist = _front_case(rng, n, 4, cuda)
    for traces in (False, True):
        vtx_k, hist_k, vtx_o = vtx.clone(), hist.clone(), vtx.clone()
        got = ops.step_front(vtx_k, slot, ids, seed=42, t=5, sigma=0.8, draw=True, bias=True,
                             hist_row=hist_k, tr_plus=tp if traces else None,
                             tr_minus=tm if traces else None, params=LIF_PARAMS,
                             taus=TAUS if traces else None)
        i_in = ops.step_noise_add(slot, ids, 42, 5, 0.8, vtx_o[:, 2])
        v, r = vtx_o[:, 0].contiguous(), vtx_o[:, 1].contiguous()
        want = (split_mod.pre_exchange_cuda(v, r, i_in, tp, tm, params=LIF_PARAMS, taus=TAUS)
                if traces else lif_mod.lif_step_cuda(v, r, i_in, params=LIF_PARAMS))
        vtx_o[:, 0], vtx_o[:, 1] = want[0], want[1]
        for a, b in zip(got, want[2:]):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(vtx_k.view(torch.int32), vtx_o.view(torch.int32))
        assert torch.equal(hist_k, want[2].to(torch.uint8))


def test_step_front_kernel_refuses_bad_operands(cuda):
    vtx = torch.zeros((8, 4), device=cuda)
    slot, ids = torch.zeros(8, device=cuda), torch.arange(8, device=cuda)
    hist = torch.zeros(8, dtype=torch.uint8, device=cuda)
    kw = dict(seed=1, t=0, sigma=1.0, draw=True, bias=True, params=LIF_PARAMS)
    with pytest.raises(ValueError, match="CUDA"):
        front_mod.step_front_cuda(vtx.cpu(), slot.cpu(), ids.cpu(), hist_row=None, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        front_mod.step_front_cuda(vtx.t().contiguous().t(), slot, ids, hist_row=None, **kw)
    with pytest.raises(ValueError, match="bias column"):
        front_mod.step_front_cuda(vtx[:, :2].contiguous(), slot, ids, hist_row=None, **kw)
    with pytest.raises(TypeError):
        front_mod.step_front_cuda(vtx, slot, ids.int(), hist_row=None, **kw)
    with pytest.raises(TypeError):
        front_mod.step_front_cuda(vtx, slot, ids, hist_row=hist.float(), **kw)
    with pytest.raises(ValueError, match="rows"):
        front_mod.step_front_cuda(vtx, slot[:7].contiguous(), ids, hist_row=None, **kw)
    with pytest.raises(ValueError, match="ids"):
        front_mod.step_front_cuda(vtx, slot, None, hist_row=None, **kw)
    with pytest.raises(ValueError, match=">= 0"):
        front_mod.step_front_cuda(vtx, slot, ids, hist_row=None, **dict(kw, t=-1))
    with pytest.raises(ValueError, match="together"):
        front_mod.step_front_cuda(vtx, slot, ids, hist_row=hist, tr_plus=slot, **kw)
    before = front_mod.COUNTER.launches
    empty = front_mod.step_front_cuda(vtx[:0], slot[:0], ids[:0], hist_row=hist[:0], **kw)
    assert empty[0].shape == (0,) and front_mod.COUNTER.launches == before


@pytest.mark.parametrize("engine", ["fused_event", "fused_split", "fused_split_event",
                                    "fused_split_plastic"])
def test_front_engines_on_card_equal_the_old_chain(cuda, engine):
    """200 steps of each engine that takes the front, through the front and
    through the chain it replaced (``make_core_step(front=False)``): raster,
    vtx_state, ring, hist, traces and weights bit-identical; the front runs
    one launch a partition and step, and none of noise_add, lif_step and
    pre_exchange."""
    from repro_torch.core import block_partition
    from repro_torch.kernels import noise as noise_mod
    from repro_torch.snn import Session, SimConfig, Simulator, balanced_ei, microcircuit, to_dcsr

    plastic = engine.endswith("plastic")
    gather = "event" if engine.endswith("event") else "dense"
    net = balanced_ei(n=2000, stdp=True, seed=0) if plastic else microcircuit(scale=0.05, seed=0)
    k = 1 if engine == "fused_event" else 4
    d = to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)
    cfg = SimConfig(fused=True, gather=gather)
    if k == 1:
        sim = Simulator(d, cfg, device=cuda)
        old = sim._make_step(gather, front=False)
    else:
        sim = Session(d, cfg, engine="spmd", devices=[cuda] * k).simulator
        old = sim._make_steps(gather, front=False)
    assert sim.engine_choice.engine == engine
    state = sim.init_state()
    counters = (front_mod.COUNTER, noise_mod.COUNTER, lif_mod.COUNTER, split_mod.PRE_COUNTER)
    before = [c.launches for c in counters]
    st_new, out_new = sim.run(state, 200, record_raster=True)
    assert [c.launches - b for c, b in zip(counters, before)] == [200 * k, 0, 0, 0]
    front = sim._step
    sim._step = old
    st_old, out_old = sim.run(state, 200, record_raster=True)
    sim._step = front
    assert int(out_new["raster"].sum()) > 0
    assert torch.equal(out_new["raster"], out_old["raster"])
    for a, b in zip(*([s] if k == 1 else s for s in (st_new, st_old))):
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            assert torch.equal(a[key].view(torch.uint8), b[key].view(torch.uint8)), key
        for wa, wb in zip(a["weights"], b["weights"]):
            assert torch.equal(wa, wb)


def _exact_sum_net():
    """A small non-plastic net whose weights are multiples of 1/16, so every
    gather sum is exact in any order and the card and the CPU agree bit for
    bit; the noise is the port's own, a function of (seed, t, id)."""
    from repro_torch.snn import spatial_random, to_dcsr

    net = spatial_random(240, avg_degree=10, seed=4)
    net.vtx_state[:, 2] += 50.0  # drive real activity through the ring
    d = to_dcsr(net, k=1)
    d.meta["noise_sigma"] = 1.0
    w = d.parts[0].edge_state[:, 0]
    w[:] = np.round(w * 16.0) / 16.0
    return d


@pytest.mark.parametrize("first", ["cuda", "cpu"])
def test_snapshot_continues_bit_for_bit_on_the_other_device(cuda, tmp_path, first):
    """Saved on one device at step 40, restored on the other: the next 40
    steps equal the first device's own continuation in raster, and the
    snapshots after them hold equal arrays."""
    from repro_torch.io import load_binary
    from repro_torch.snn import RasterMonitor, Session, SimConfig

    devices = (cuda, "cpu") if first == "cuda" else ("cpu", cuda)
    cfg = SimConfig(fused=True)
    ses = Session(_exact_sum_net(), cfg, device=devices[0])
    ses.run(40)
    ses.save(str(tmp_path / "mid"))
    own = RasterMonitor()
    ses.run(40, monitors=[own])
    back = Session.restore(str(tmp_path / "mid"), cfg=cfg, device=devices[1])
    assert back.t == 40 and back.device.type == torch.device(devices[1]).type
    mon = RasterMonitor()
    back.run(40, monitors=[mon])
    assert own.raster.sum() > 0
    np.testing.assert_array_equal(mon.raster, own.raster)
    ses.save(str(tmp_path / "a"))
    back.save(str(tmp_path / "b"))
    (na, sa, ta), (nb, sb, tb) = load_binary(str(tmp_path / "a")), load_binary(str(tmp_path / "b"))
    assert ta == tb == 80
    np.testing.assert_array_equal(na.parts[0].vtx_state, nb.parts[0].vtx_state)
    np.testing.assert_array_equal(na.parts[0].edge_state, nb.parts[0].edge_state)
    for key in sa[0]:
        np.testing.assert_array_equal(sa[0][key], sb[0][key], err_msg=key)
