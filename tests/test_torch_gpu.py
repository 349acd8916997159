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
from repro_torch.kernels import segment_gather as seg_mod
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


STDP_BF = dict(a_plus=0.01, a_minus=0.012, w_min=-1.9, w_max=2.1)  # off the bf16 grid


def _same_bf16(a, b):
    """Bit for bit, NaNs included (the plain version on the card rounds a
    NaN with the same __float2bfloat16_rn as the kernel)."""
    return a.dtype == b.dtype == torch.bfloat16 and torch.equal(a.view(torch.int16),
                                                                b.view(torch.int16))


@pytest.mark.parametrize("mask_bf16", [True, False], ids=["bf16_mask", "f32_mask"])
@pytest.mark.parametrize("n,R,K", [(64, 8, 32), (1000, 1000, 37), (12500, 12504, 128)])
def test_stdp_update_kernel_bf16_equals_plain(cuda, rng, n, R, K, mask_bf16):
    """bf16 weights: the kernel equals its plain version (every op rounded
    to bf16) on the card, in place and out of place, with a bf16 or an f32
    mask; a NaN weight and weights past the clip included."""
    (c,), (w,) = _panels(rng, n, R, (K,), R, cuda)
    (m,) = _masks(rng, R, (K,), R, cuda, 0.65)
    w = w.bfloat16()
    w[: R // 8] = 2.5  # past w_max: clipped where plastic
    w[0, 0] = float("nan")
    if mask_bf16:
        m = m.bfloat16()
    pre_t, post_t = _vec(rng, n, cuda), _vec(rng, R, cuda)
    pre_s = (_vec(rng, n, cuda) < 0.3).float()
    post_s = (_vec(rng, R, cuda) < 0.3).float()
    args = (w, m, c, pre_t, pre_s, post_t, post_s)
    before = stdp_mod.COUNTER.launches
    got = ops.stdp_update(*args, params=STDP_BF)
    assert stdp_mod.COUNTER.launches == before + 1
    want = stdp_mod.stdp_update_plain(*args, params=STDP_BF)
    assert _same_bf16(got, want)
    nan = torch.isnan(got)
    assert torch.equal(got[~nan], want[~nan]) and not torch.equal(got, w)
    inplace = w.clone()
    assert ops.stdp_update(inplace, *args[1:], params=STDP_BF, out=inplace) is inplace
    assert _same_bf16(inplace, got)
    other = torch.full_like(w, float("nan"))
    ops.stdp_update(*args, params=STDP_BF, out=other)
    assert _same_bf16(other, got)


def test_stdp_update_kernel_refuses_mixed_and_wide_types(cuda, rng):
    (c,), (w,) = _panels(rng, 64, 16, (32,), 16, cuda)
    (m,) = _masks(rng, 16, (32,), 16, cuda)
    vec, row = _vec(rng, 64, cuda), _vec(rng, 16, cuda)
    w16 = w.bfloat16()
    cases = [
        (w, m.bfloat16(), {}),  # a bf16 mask on f32 weights
        (w.double(), m.double(), {}),  # f64
        (w.half(), m.half(), {}),  # f16
        (w16, m.double(), {}),  # a wider mask
        (w16, m, dict(out=torch.empty_like(w))),  # an f32 out for bf16 weights
        (w, m, dict(out=torch.empty_like(w16))),  # a bf16 out for f32 weights
    ]
    for weights, mask, kw in cases:
        with pytest.raises(TypeError):
            ops.stdp_update(weights, mask, c, vec, vec, row, row, params=STDP, **kw)
    with pytest.raises(TypeError):  # bf16 vectors: the kernel rounds f32 ones
        ops.stdp_update(w16, m, c, vec.bfloat16(), vec, row, row, params=STDP)


def test_plastic_fused_kernels_refuse_bf16_weights(cuda, rng):
    """The reference's fused plastic Pallas kernels raise on bf16 weights;
    the port's three plastic fused ops raise TypeError on the card."""
    n_p, R, D, ks = 64, 64, 8, (16, 24)
    v, r, i = _lif_inputs(rng, n_p, cuda)
    cols, weights = _panels(rng, n_p, R, ks, n_p, cuda)
    plastic = _masks(rng, R, ks, n_p, cuda)
    w16 = [w.bfloat16() for w in weights]
    tp, tm = _vec(rng, n_p, cuda), _vec(rng, n_p, cuda)
    ring = torch.zeros((D, n_p), device=cuda)
    clear, onehot, _ = _slots(D, 3, [1, 2], cuda)
    act = (_vec(rng, n_p, cuda) < 0.2).float()
    with pytest.raises(TypeError, match="f32 weights only"):
        ops.fused_step_plastic(v, r, i, tp, tm, cols, w16, plastic, params=LIF_PARAMS,
                               taus=TAUS, stdp=STDP)
    with pytest.raises(TypeError, match="f32 weights only"):
        ops.fused_post_exchange_plastic(act, tp, ring, clear, onehot, tm, act, cols, w16,
                                        plastic, stdp=STDP)
    with pytest.raises(TypeError, match="f32 weights only"):
        ops.fused_post_exchange_remote_plastic(act, act, tp, ring, onehot, tm, act, cols, w16,
                                               plastic, stdp=STDP)


# "every_slot": random panels, no row_len (every slot real); "ell": the ELL
# layout, row r's row_len[r] < K real slots first, then (col 0, weight +0,
# mask 0); "ell_full": every row K long, its row_len given
PLASTIC_LAYOUTS = ("every_slot", "ell", "ell_full")


def _plastic_panels(rng, n_act, n_p, R, ks, device, p_mask, layout):
    """``(cols, weights, plastic, row_len)`` of a plastic launch; in the
    ELL layouts a ``p_mask`` share of the real slots is plastic and a
    quarter of the rows hold weights past ``w_max``."""
    if layout == "every_slot":
        cols, weights = _panels(rng, n_act, R, ks, n_p, device)
        return cols, weights, _masks(rng, R, ks, n_p, device, p_mask), None
    cols, weights, plastic, row_len = [], [], [], []
    for K in ks:
        rl = np.full(R, K) if layout == "ell_full" else rng.integers(0, K, R)
        rl[n_p:] = 0
        real = np.arange(K)[None, :] < rl[:, None]
        w = (1.5 * rng.normal(size=(R, K))).astype(np.float32)
        w[: R // 4] += 2.5  # past w_max: clipped where plastic
        cols.append(torch.from_numpy(np.where(real, rng.integers(0, n_act, (R, K)), 0)
                                     .astype(np.int32)).to(device))
        weights.append(torch.from_numpy(np.where(real, w, 0.0).astype(np.float32)).to(device))
        plastic.append(torch.from_numpy((real & (rng.random((R, K)) < p_mask))
                                        .astype(np.float32)).to(device))
        row_len.append(torch.from_numpy(rl.astype(np.int32)).to(device))
    return cols, weights, plastic, row_len


def _plastic_case(rng, n_p, R, ks, device, p_mask=0.5, layout="every_slot"):
    v, r, i = _lif_inputs(rng, n_p, device)
    cols, weights, plastic, row_len = _plastic_panels(rng, n_p, n_p, R, ks, device, p_mask,
                                                      layout)
    return (v, r, i, _vec(rng, n_p, device), _vec(rng, n_p, device), cols, weights, plastic,
            row_len)


def _untouched(new_w, weights, plastic):
    """No padding or non-plastic slot was written (bit for bit)."""
    return all(torch.equal(a.view(torch.int32)[pm == 0], b.view(torch.int32)[pm == 0])
               for a, b, pm in zip(new_w, weights, plastic))


@pytest.mark.parametrize("layout", PLASTIC_LAYOUTS)
@pytest.mark.parametrize("n_p,R,ks,p_mask", [
    (64, 64, (16,), 0.5),
    (100, 104, (8, 24), 0.5),  # R > n_p
    (37, 40, (4, 12, 20), 0.5),  # K not a multiple of 32
    (500, 504, tuple(range(8, 8 * 16, 8)), 0.5),  # 15 buckets, as balanced_ei
    (1000, 1000, (37,), 0.0),  # one bucket, all-zero mask
    (300, 304, (40, 200, 300), 1.0),  # every slot plastic, rows past one 128-slot chunk
    (12500, 12504, (128,) * 15, 0.65),  # balanced_ei(12500) panel widths
])
def test_fused_plastic_kernel_vs_unfused_kernels_and_plain(cuda, rng, n_p, R, ks, p_mask,
                                                          layout):
    v, r, i, tp, tm, cols, weights, plastic, row_len = _plastic_case(
        rng, n_p, R, ks, cuda, p_mask, layout)
    kw = dict(params=LIF_PARAMS, taus=TAUS, stdp=STDP)
    before = fused_mod.PLASTIC_COUNTER.launches
    out = ops.fused_step_plastic(v, r, i, tp, tm, cols, weights, plastic, row_len, **kw)
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
    assert _untouched(new_w, weights, plastic)
    # every slot read (no row_len): the same bits
    every = ops.fused_step_plastic(v, r, i, tp, tm, cols, weights, plastic, **kw)
    for a, b in zip((*out[:5], *curs, *new_w), (*every[:5], *every[5], *every[6])):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    # the plain version: bit-exact but for the currents (f32 sums in another
    # order: rtol=atol=1e-5)
    want = fused_mod.fused_step_plastic_plain(v, r, i, tp, tm, cols, weights, plastic, row_len,
                                              **kw)
    for a, b in zip(out[:5], want[:5]):
        assert torch.equal(a, b)
    for a, b in zip(curs, want[5]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(new_w, want[6]):
        assert torch.equal(a, b)
    if p_mask > 0:
        assert any(not torch.equal(a, b) for a, b in zip(new_w, weights))

    # the engine's form: the currents added into the ring in the launch (the
    # step t on the card) and the weights in place; the ring equals
    # index_add_ of the currents bit for bit, signed zeros included
    D, t = len(ks) + 3, 9
    delays = list(range(1, len(ks) + 1))
    ring0 = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    ring0[:, : n_p // 4] = -0.0
    want_ring = ring0.clone()
    for cur, d in zip(curs, delays):
        want_ring.index_add_(0, torch.tensor([(t + d) % D], device=cuda), cur[:n_p][None])
    ring = ring0.clone()
    work = [w.clone() for w in weights]
    t_dev = torch.tensor(t, dtype=torch.int64, device=cuda)
    got = ops.fused_step_plastic(v, r, i, tp, tm, cols, work, plastic, row_len, ring=ring,
                                 t=t_dev, delays=delays, weights_out=work, **kw)
    assert fused_mod.PLASTIC_COUNTER.launches == before + 3
    assert got[5] is ring and all(a is b for a, b in zip(got[6], work))
    assert torch.equal(ring.view(torch.int32), want_ring.view(torch.int32))
    for a, b in zip((*got[:5], *work), (*out[:5], *new_w)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    plain_ring, plain_w = ring0.clone(), [w.clone() for w in weights]
    fused_mod.fused_step_plastic_plain(v, r, i, tp, tm, cols, plain_w, plastic, row_len,
                                       ring=plain_ring, t=t_dev, delays=delays,
                                       weights_out=plain_w, **kw)
    torch.testing.assert_close(ring, plain_ring, rtol=1e-5, atol=1e-5)
    assert all(torch.equal(a, b) for a, b in zip(work, plain_w))


def test_fused_plastic_ring_form_refuses_shared_write_slots(cuda, rng):
    v, r, i, tp, tm, cols, weights, plastic, row_len = _plastic_case(
        rng, 64, 64, (16, 16), cuda, 0.5, "ell")
    kw = dict(params=LIF_PARAMS, taus=TAUS, stdp=STDP)
    ring = torch.zeros((4, 64), device=cuda)
    with pytest.raises(ValueError, match="share a ring slot"):
        ops.fused_step_plastic(v, r, i, tp, tm, cols, weights, plastic, row_len, ring=ring,
                               t=0, delays=[1, 5], **kw)
    with pytest.raises(ValueError, match="ring"):
        ops.fused_step_plastic(v, r, i, tp, tm, cols, weights, plastic, row_len,
                               ring=torch.zeros((4, 63), device=cuda), t=0, delays=[1, 2], **kw)


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


@pytest.mark.parametrize("k", [1, 4])
def test_plastic_session_weights_never_alias_the_panels_on_card(cuda, k):
    """The plastic kernels update a run's carry's weights in place: no
    state a run hands back (graphed runs) shares memory with the uploaded
    panels, which a ``_share``d session borrows, and the panels stay as
    uploaded; the borrowing session's run equals the lender's."""
    from repro_torch.core import block_partition
    from repro_torch.snn import RasterMonitor, Session, SimConfig, balanced_ei, to_dcsr

    ei = balanced_ei(n=2000, stdp=True, seed=0)
    if k == 1:
        net, kw = to_dcsr(ei, k=1), dict(device=cuda)
    else:
        net = to_dcsr(ei, assignment=block_partition(2000, k), uniform=True)
        kw = dict(engine="spmd", devices=[cuda] * k)
    a = Session(net, SimConfig(), **kw)
    b = Session(net, SimConfig(), _share=a, **kw)
    devs = [a.simulator.dev] if k == 1 else a.simulator.devs
    w0 = [w.clone() for d in devs for w in d.weights0]
    panels = {w.untyped_storage().data_ptr() for d in devs for w in d.weights0}

    def weights(state):
        return [w for c in ([state] if k == 1 else state) for w in c["weights"]]

    rasters = []
    for ses in (a, b):
        mon = RasterMonitor()
        ses.run(200, monitors=[mon], chunk_size=100)
        rasters.append(mon.raster)
        assert not panels & {w.untyped_storage().data_ptr() for w in weights(ses.state)}
        assert any(not torch.equal(x, y) for x, y in zip(weights(ses.state), w0))
        assert all(torch.equal(x, y) for x, y in zip([w for d in devs for w in d.weights0], w0))
    np.testing.assert_array_equal(rasters[0], rasters[1])
    assert all(torch.equal(x, y) for x, y in zip(weights(a.state), weights(b.state)))


# -- stdp_update_step: every bucket of a step in one launch -----------------

def _step_bucket(rng, n, R, K, rows, row_map=None, p_plastic=0.6):
    """An ELL panel (real slots first, ``(col 0, weight 0, mask 0)`` past
    them) of ``R`` rows, the first ``rows`` holding slots; numpy arrays."""
    rl = rng.integers(0, K + 1, R).astype(np.int32)
    rl[rows:] = 0
    rl[rng.random(R) < 0.1] = 0
    rl[0] = 0  # a row of row_len 0
    real = np.arange(K)[None, :] < rl[:, None]
    cols = np.where(real, rng.integers(0, n, (R, K)), 0).astype(np.int32)
    w = np.where(real, rng.normal(size=(R, K)), 0.0).astype(np.float32)
    m = (real & (rng.random((R, K)) < p_plastic)).astype(np.float32)
    rm = None
    if row_map is not None:
        rm = np.zeros(R, np.int32)
        rm[:rows] = row_map
    return dict(w=w, m=m, cols=cols, row_len=rl, row_map=rm)


STEP_CASES = ("padded", "split", "many_buckets", "long_rows", "nan_pre_trace", "clip_dw0",
              "neg_zero", "brunel")


def _step_case(rng, name):
    n_p, n = 300, 1000
    if name == "brunel":  # the Brunel net's panel shape, 15 buckets
        n_p = n = 12500
        buckets = [_step_bucket(rng, n, 12504, 128, n_p, p_plastic=0.5) for _ in range(15)]
    elif name == "split":
        buckets = []
        for K in (16, 64):
            rows = np.repeat(np.arange(n_p), rng.integers(1, 4, n_p))
            buckets.append(_step_bucket(rng, n, len(rows) + 8, K, len(rows), row_map=rows))
        buckets.append(_step_bucket(rng, n, 304, 40, n_p))
    elif name == "many_buckets":
        buckets = [_step_bucket(rng, n, 304, 1 + b % 40, n_p)
                   for b in range(stdp_mod.STEP_MAX_BUCKETS + 5)]
    elif name == "long_rows":  # rows of up to 300 real slots: three chunks and more
        buckets = [_step_bucket(rng, n, 304, K, n_p) for K in (300, 129, 128)]
    else:
        buckets = [_step_bucket(rng, n, 304, K, n_p) for K in (128, 77, 8)]
    pre_t = rng.random(n).astype(np.float32)
    pre_s = (rng.random(n) < 0.3).astype(np.float32)
    post_t = rng.random(n_p).astype(np.float32)
    post_s = (rng.random(n_p) < 0.3).astype(np.float32)
    if name == "nan_pre_trace":
        for b in buckets:
            b["m"][b["cols"] == 7] = 0.0
        pre_t[7] = np.nan
    elif name in ("clip_dw0", "neg_zero"):
        pre_s[:], post_s[:] = 0.0, 0.0
        for b in buckets:
            if name == "clip_dw0":
                b["w"] *= 3.0
            else:
                b["w"][:, ::2] = -0.0
    return n_p, buckets, (pre_t, pre_s, post_t, post_s)


@pytest.mark.parametrize("name", STEP_CASES)
def test_stdp_update_step_kernel_equals_its_plain_version(cuda, rng, name):
    """One launch a call (two past STEP_MAX_BUCKETS buckets), the weights
    updated in place, bit-equal to the per-bucket plain version."""
    n_p, buckets, vecs = _step_case(rng, name)
    plan = stdp_mod.stdp_step_plan([b["m"] for b in buckets], [b["row_len"] for b in buckets],
                                   [b["row_map"] for b in buckets], n_p, cuda)
    on = dict(device=cuda)
    masks = [torch.from_numpy(b["m"]).to(**on) for b in buckets]
    cols = [torch.from_numpy(b["cols"]).to(**on) for b in buckets]
    vec = [torch.from_numpy(v).to(**on) for v in vecs]
    w0 = [torch.from_numpy(b["w"]).to(**on) for b in buckets]
    work = [w.clone() for w in w0]
    ptrs = [w.data_ptr() for w in work]
    before = stdp_mod.COUNTER.launches
    got = ops.stdp_update_step(work, masks, cols, *vec, plan=plan, params=STDP)
    torch.cuda.synchronize()
    assert stdp_mod.COUNTER.launches == before + len(plan.groups)
    assert len(plan.groups) == (2 if name == "many_buckets" else 1)
    assert [w.data_ptr() for w in got] == ptrs and all(g is w for g, w in zip(got, work))
    want = stdp_mod.stdp_update_step_plain([w.clone() for w in w0], masks, cols, *vec,
                                           plan=plan, params=STDP)
    changed = 0
    for g, x, m, w in zip(work, want, masks, w0):
        assert torch.equal(g.view(torch.int32), x.view(torch.int32))
        assert torch.equal(g.view(torch.int32)[m == 0], w.view(torch.int32)[m == 0])
        changed += int((g.view(torch.int32) != w.view(torch.int32)).sum())
    assert changed > 0
    # the per-panel kernel on each bucket, as the old loop launched it
    for b, (x, m, c, w) in enumerate(zip(want, masks, cols, w0)):
        rm = plan.row_map[b]
        if rm is None:
            R = w.shape[0]
            pt, ps = (torch.nn.functional.pad(v, (0, R - n_p)) for v in vec[2:])
        else:
            pt, ps = (v.index_select(0, rm) for v in vec[2:])
        assert torch.equal(ops.stdp_update(w, m, c, vec[0], vec[1], pt, ps, params=STDP), x)


def test_stdp_update_step_refuses_bad_operands(cuda, rng):
    n_p, buckets, vecs = _step_case(rng, "padded")
    plan = stdp_mod.stdp_step_plan([b["m"] for b in buckets], [b["row_len"] for b in buckets],
                                   None, n_p, cuda)
    w = [torch.from_numpy(b["w"]).to(cuda) for b in buckets]
    m = [torch.from_numpy(b["m"]).to(cuda) for b in buckets]
    c = [torch.from_numpy(b["cols"]).to(cuda) for b in buckets]
    v = [torch.from_numpy(x).to(cuda) for x in vecs]
    with pytest.raises(TypeError, match="f32"):
        ops.stdp_update_step([x.bfloat16() for x in w], m, c, *v, plan=plan, params=STDP)
    with pytest.raises(ValueError, match="entries"):
        ops.stdp_update_step(w, m, c, v[0], v[1], v[2][:5], v[3], plan=plan, params=STDP)
    with pytest.raises(ValueError, match="buckets"):
        ops.stdp_update_step(w[:2], m[:2], c[:2], *v, plan=plan, params=STDP)
    with pytest.raises(ValueError, match="CUDA"):
        ops.stdp_update_step(w, m, c, *v, plan=stdp_mod.stdp_step_plan(
            [b["m"] for b in buckets], [b["row_len"] for b in buckets], None, n_p, "cpu"),
            params=STDP)


@pytest.mark.parametrize("max_k", [None, 64])
def test_unfused_plastic_session_one_stdp_launch_a_step_panels_untouched(cuda, max_k):
    """The unfused plastic engine (and its max_k form) makes one
    ``stdp_update`` launch a step, graphed, updating the carry's weights in
    place; the uploaded panels, which a ``_share``d session borrows, stay
    as uploaded, and the borrower's run equals the lender's and the fused
    engine's."""
    from repro_torch.snn import RasterMonitor, Session, SimConfig, balanced_ei, to_dcsr

    net = to_dcsr(balanced_ei(n=2000, stdp=True, seed=0), k=1)
    cfg = SimConfig(fused=False, **(dict(max_k=max_k, align_k=32) if max_k else {}))
    a = Session(net, cfg, device=cuda)
    b = Session(net, cfg, device=cuda, _share=a)
    assert a.simulator.engine_choice.engine == "unfused"
    w0 = [w.clone() for w in a.simulator.dev.weights0]
    panels = {w.untyped_storage().data_ptr() for w in a.simulator.dev.weights0}
    rasters = []
    for ses in (a, b):
        mon = RasterMonitor()
        before = stdp_mod.COUNTER.launches
        ses.run(200, monitors=[mon], chunk_size=100)
        assert stdp_mod.COUNTER.launches == before + 200
        assert ses.simulator.graph_mode == "cuda_graph"
        rasters.append(mon.raster)
        assert not panels & {w.untyped_storage().data_ptr() for w in ses.state["weights"]}
        assert any(not torch.equal(x, y) for x, y in zip(ses.state["weights"], w0))
        assert all(torch.equal(x, y) for x, y in zip(a.simulator.dev.weights0, w0))
    np.testing.assert_array_equal(rasters[0], rasters[1])
    assert all(torch.equal(x, y) for x, y in zip(a.state["weights"], b.state["weights"]))
    if max_k is None:
        f = Session(net, SimConfig(), device=cuda)
        mon = RasterMonitor()
        f.run(200, monitors=[mon], chunk_size=100)
        np.testing.assert_array_equal(mon.raster, rasters[0])
        assert all(torch.equal(x, y) for x, y in zip(f.state["weights"], a.state["weights"]))


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


@pytest.mark.parametrize("layout", PLASTIC_LAYOUTS)
@pytest.mark.parametrize("n_p,n,R,ks,remote,p_mask", [
    (64, 256, 64, (16,), False, 0.5),
    (100, 400, 104, (8, 24), True, 0.5),
    (100, 400, 104, (8, 200), True, 1.0),  # rows past one 128-slot chunk, every slot plastic
    (100, 400, 104, (8, 24), False, 0.0),
    (3125, 12500, 3128, (128,) * 15, False, 0.5),  # balanced_ei(12500) at k=4
    (3125, 12500, 3128, (128,) * 15, True, 0.5),
])
def test_post_exchange_plastic_kernel_vs_unfused_kernels(cuda, rng, n_p, n, R, ks, remote,
                                                         p_mask, layout):
    D, t = 16, 9
    delays = list(range(1, len(ks) + 1))
    cols, weights, plastic, row_len = _plastic_panels(rng, n, n_p, R, ks, cuda, p_mask, layout)
    act = (_vec(rng, n, cuda) < 0.1).float()
    pre = _vec(rng, n, cuda)
    post_t, post_s = _vec(rng, n_p, cuda), (_vec(rng, n_p, cuda) < 0.2).float()
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    ring[:, : n_p // 4] = -0.0
    clear, onehot, _ = _slots(D, t, delays, cuda)
    lo = n_p  # partition 1's own slice
    act_g = act.clone()
    if remote:
        act_g[lo:lo + n_p] = 0.0
    before = split_mod.PLASTIC_COUNTER.launches
    if remote:
        new_ring, new_w = ops.fused_post_exchange_remote_plastic(
            act_g, act, pre, ring, onehot, post_t, post_s, cols, weights, plastic, row_len,
            stdp=STDP)
        want = ref.fused_post_exchange_remote_plastic_ref(
            act_g, act, pre, ring, onehot, post_t, post_s, cols, weights, plastic, stdp=STDP)
    else:
        new_ring, new_w = ops.fused_post_exchange_plastic(
            act, pre, ring, clear, onehot, post_t, post_s, cols, weights, plastic, row_len,
            stdp=STDP)
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
    assert _untouched(new_w, weights, plastic)
    if p_mask > 0:
        assert any(not torch.equal(a, b) for a, b in zip(new_w, weights))
    # the engines' form: the ring in place (out=ring), the weights in place,
    # the remote pass's own slice zeroed in the kernel (own=): the same bits
    ring_e, work = ring.clone(), [w.clone() for w in weights]
    if remote:
        got = ops.fused_post_exchange_remote_plastic(
            None, act, pre, ring_e, onehot, post_t, post_s, cols, work, plastic, row_len,
            stdp=STDP, out=ring_e, own=(lo, lo + n_p), weights_out=work)
    else:
        got = ops.fused_post_exchange_plastic(
            act, pre, ring_e, clear, onehot, post_t, post_s, cols, work, plastic, row_len,
            stdp=STDP, out=ring_e, weights_out=work)
    assert got[0] is ring_e and all(a is b for a, b in zip(got[1], work))
    assert torch.equal(ring_e.view(torch.int32), new_ring.view(torch.int32))
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(work, new_w))


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


# -- the compiled chunk: t on the card, one CUDA graph per key ------------------
#
# On the card Simulator.run and DistSimulator.run replay one CUDA graph per
# step engine, chunk length and recordings (snn/simulator.py:ChunkGraphs);
# _graphs=False keeps the uncaptured loop on the card as their oracle.

def _graph_net(kind, k):
    from repro_torch.core import block_partition
    from repro_torch.snn import balanced_ei, microcircuit, to_dcsr

    net = (microcircuit(scale=0.05, seed=0) if kind == "mc"
           else balanced_ei(n=2000, stdp=True, seed=0))
    if k == 1:
        return to_dcsr(net, k=1)
    return to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)


def _graph_sims(cuda, kind, k, **fields):
    """A graphed simulator and an uncaptured one of the same net and
    config on the card (the k>1 one lends the other its panels)."""
    from repro_torch.snn import SimConfig, Simulator
    from repro_torch.snn.dist_sim import DistSimulator

    d = _graph_net(kind, k)
    cfg = SimConfig(**fields)
    if k == 1:
        return Simulator(d, cfg, device=cuda), Simulator(d, cfg, device=cuda, _graphs=False)
    on = DistSimulator(d, cfg, devices=[cuda] * k)
    return on, DistSimulator(d, cfg, devices=[cuda] * k, _share=on, _graphs=False)


def _carry_list(state):
    return [state] if isinstance(state, dict) else list(state)


def _assert_bit_equal_states(a, b):
    for ca, cb in zip(_carry_list(a), _carry_list(b)):
        assert torch.equal(ca["t"], cb["t"]) and ca["t"].dim() == 0
        for key in ("vtx_state", "ring", "hist", "tr_plus", "tr_minus"):
            assert torch.equal(ca[key].view(torch.uint8), cb[key].view(torch.uint8)), key
        for wa, wb in zip(ca["weights"], cb["weights"]):
            assert torch.equal(wa.view(torch.uint8), wb.view(torch.uint8))


def _counts():
    return _build.launch_counts()


def _graph_ab(on, off, schedule, t0=0, **rec):
    """The schedule's chunks from ``init_state(t0)`` on both simulators:
    rasters, states and the launches each counted."""
    out = []
    for sim in (on, off):
        before = _counts()
        st, rasters = sim.init_state(t0), []
        for c in schedule:
            st, o = sim.run(st, c, record_raster=True, **rec)
            rasters.append(o["raster"])
        torch.cuda.synchronize()
        out.append((st, torch.cat(rasters), [a - b for a, b in zip(_counts(), before)]))
    return out


K1_GRAPH_ENGINES = {
    "fused_event": ("mc", dict(fused=True, gather="event")),
    "fused": ("mc", dict(fused=True, gather="dense")),
    "unfused": ("mc", dict(fused=False)),
    "fused_plastic": ("ei", dict()),
    "unfused_plastic": ("ei", dict(fused=False)),
}


@pytest.mark.parametrize("engine", list(K1_GRAPH_ENGINES))
def test_k1_graphs_equal_the_uncaptured_loop(cuda, engine):
    """Graphed against _graphs=False on the card: raster, vtx_state, ring,
    hist, traces and weights bit-equal over chunks of 128, 128 and 44; each
    key captured once, replayed after; the launch counters equal."""
    kind, fields = K1_GRAPH_ENGINES[engine]
    on, off = _graph_sims(cuda, kind, 1, **fields)
    assert on.engine_choice.engine == engine.replace("unfused_plastic", "unfused")
    assert (on.graph_mode, off.graph_mode) == ("cuda_graph", "uncaptured: _graphs=False")
    (st_on, r_on, n_on), (st_off, r_off, n_off) = _graph_ab(on, off, [128, 128, 44],
                                                            record_v=True)
    assert int(r_on.sum()) > 0 and torch.equal(r_on, r_off)
    _assert_bit_equal_states(st_on, st_off)
    assert n_on == n_off and sum(n_on) > 0
    summary = sorted((g["steps"], g["replays"]) for g in on._graphs.summary())
    assert summary == [(44, 1), (128, 2)]


@pytest.mark.parametrize("overlap", ["off", "local", "double_buffer"])
@pytest.mark.parametrize("exchange", ["dense", "index"])
@pytest.mark.parametrize("gather", ["dense", "event"])
def test_k4_graphs_equal_the_uncaptured_loop(cuda, gather, exchange, overlap):
    """Four partitions on one card, every exchange and overlap mode: the
    graphed chunks bit-equal to the uncaptured ones."""
    on, off = _graph_sims(cuda, "mc", 4, gather=gather, exchange=exchange, overlap=overlap)
    assert on.graph_mode == "cuda_graph"
    (st_on, r_on, n_on), (st_off, r_off, n_off) = _graph_ab(on, off, [64, 64, 19])
    assert int(r_on.sum()) > 0 and torch.equal(r_on, r_off)
    _assert_bit_equal_states(st_on, st_off)
    assert n_on == n_off


@pytest.mark.parametrize("fields", [dict(overlap="off"), dict(overlap="local"),
                                    dict(overlap="double_buffer"), dict(exchange="index"),
                                    dict(fused=False)])
def test_k4_plastic_graphs_equal_the_uncaptured_loop(cuda, fields):
    on, off = _graph_sims(cuda, "ei", 4, **fields)
    (st_on, r_on, n_on), (st_off, r_off, n_off) = _graph_ab(on, off, [64, 64, 19])
    assert int(r_on.sum()) > 0 and torch.equal(r_on, r_off)
    _assert_bit_equal_states(st_on, st_off)
    assert n_on == n_off


def test_the_cyclic_collector_is_off_while_a_chunk_is_captured(cuda, monkeypatch):
    """A dead cycle that holds a captured graph, collected while another
    chunk is captured, would invalidate that capture (a capturing thread
    may not free a graph): the collector is off during a capture and on
    again after it."""
    import gc

    on, _ = _graph_sims(cuda, "ei", 4)
    seen = []
    own = on._gather

    def gather(*fields):
        seen.append((torch.cuda.is_current_stream_capturing(), gc.isenabled()))
        return own(*fields)

    monkeypatch.setattr(on, "_gather", gather)
    on.run(on.init_state(), 8)
    captured = [enabled for capturing, enabled in seen if capturing]
    assert captured and not any(captured)
    assert any(enabled for capturing, enabled in seen if not capturing)  # the warm-up
    assert gc.isenabled()


@pytest.mark.parametrize("engine", ["fused_event", "fused"])
def test_one_graph_replays_at_every_phase_and_any_t(cuda, engine):
    """One key, replayed from every phase t0 % D of the ring and from t0
    past 2^31: each equal to the uncaptured run from the same t0."""
    kind, fields = K1_GRAPH_ENGINES[engine]
    on, off = _graph_sims(cuda, kind, 1, **fields)
    t0s = list(range(on.d_ring)) + [1000, 2**31 + 3]
    for t0 in t0s:
        (st_on, r_on, _), (st_off, r_off, _) = _graph_ab(on, off, [24], t0=t0)
        assert torch.equal(r_on, r_off), t0
        _assert_bit_equal_states(st_on, st_off)
        assert int(st_on["t"]) == t0 + 24
    (g,) = on._graphs.summary()
    assert (g["steps"], g["replays"]) == (24, len(t0s))


def test_a_returned_state_is_not_overwritten_by_a_later_replay(cuda):
    on, _ = _graph_sims(cuda, "ei", 1)
    st1, out1 = on.run(on.init_state(), 32, record_raster=True, record_v=True)
    keep = {k: (tuple(w.clone() for w in v) if k == "weights" else v.clone())
            for k, v in st1.items()}
    keep_out = {k: v.clone() for k, v in out1.items()}
    on.run(st1, 32, record_raster=True, record_v=True)
    on.run(on.init_state(7), 32, record_raster=True, record_v=True)
    torch.cuda.synchronize()
    _assert_bit_equal_states(st1, keep)
    for k, v in keep_out.items():
        assert torch.equal(out1[k], v), k


@pytest.mark.parametrize("engine", ["fused_event", "fused", "unfused", "fused_plastic",
                                    "k4_split_event", "k4_split", "k4_split_plastic"])
def test_an_uncaptured_chunk_never_syncs_the_host(cuda, engine):
    """One uncaptured chunk of each engine under
    ``torch.cuda.set_sync_debug_mode("error")``: no op of a step reads back
    to the host (the graphs could not capture it otherwise)."""
    k = 4 if engine.startswith("k4") else 1
    kind = "ei" if engine.endswith("plastic") else "mc"
    fields = dict(gather="event" if engine.endswith("event") else "dense")
    if engine == "unfused":
        fields["fused"] = False
    _, off = _graph_sims(cuda, kind, k, **fields)
    st = off.init_state(5)
    st, _ = off.run(st, 3, record_raster=True, record_v=True)  # loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st, out = off.run(st, 16, record_raster=True, record_v=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(out["spike_count"].sum()) >= 0 and all(int(c["t"]) == 24
                                                       for c in _carry_list(st))


def test_a_failed_capture_raises_and_does_not_fall_back(cuda, monkeypatch):
    """An op that syncs the host breaks the capture: the run raises, naming
    the line of the port that was running, and runs nothing uncaptured."""
    on, _ = _graph_sims(cuda, "mc", 1, fused=True, gather="dense")
    own = ops.step_noise_add

    def syncing(*args, **kwargs):
        torch.cuda.synchronize()
        return own(*args, **kwargs)

    before = _counts()
    monkeypatch.setattr(ops, "step_noise_add", syncing)
    with pytest.raises(RuntimeError, match=r"CUDA graph capture of fused x 16 failed at "
                                           r"simulator\.py:\d+"):
        on.run(on.init_state(), 16)
    assert _counts() == before and not on._graphs.graphs
    monkeypatch.setattr(ops, "step_noise_add", own)
    st, _ = on.run(on.init_state(), 16)  # the card is usable after it
    assert int(st["t"]) == 16


def test_the_step_kernels_read_t_from_device_memory(cuda, rng):
    """noise_add, the step front (ring and hist rows picked on the card)
    and the event kernel (slots from t and the delays) with t as a device
    tensor, bit-equal to their int forms and to their plain versions."""
    n, D = 4099, 7
    x = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(rng.permutation(n).astype(np.int64) + 2**32).to(cuda)
    vtx, _, _, tp, tm, _ = _front_case(rng, n, 4, cuda)
    ring = torch.from_numpy(rng.normal(0.0, 10.0, (D, n)).astype(np.float32)).to(cuda)
    hist = torch.from_numpy(rng.integers(0, 2, (D, n)).astype(np.uint8)).to(cuda)
    for t in (0, 5, 999, 2**31 + 3):
        t_dev = torch.tensor(t, device=cuda)
        a = noise_mod_add(x, ids, t_dev)
        assert torch.equal(a.view(torch.int32), noise_mod_add(x, ids, t).view(torch.int32))
        assert torch.equal(a.view(torch.int32),
                           ref.step_noise_add_ref(x, ids, 42, t_dev, 0.8).view(torch.int32))
        kw = dict(seed=42, sigma=0.8, draw=True, bias=True, params=LIF_PARAMS,
                  tr_plus=tp, tr_minus=tm, taus=TAUS)
        v1, v2, v3 = (vtx.clone() for _ in range(3))
        h1, h2, h3 = (hist.clone() for _ in range(3))
        got = ops.step_front(v1, ring, ids, t=t_dev, hist_row=h1, **kw)
        want = ops.step_front(v2, ring[t % D].clone(), ids, t=t, hist_row=h2[t % D], **kw)
        plain = ref.step_front_ref(v3, ring, ids, t=t_dev, hist_row=h3, **kw)
        for g, w, p in zip(got, want, plain):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
            assert torch.equal(g.view(torch.int32), p.view(torch.int32))
        assert torch.equal(v1.view(torch.int32), v2.view(torch.int32))
        assert torch.equal(v1.view(torch.int32), v3.view(torch.int32))
        assert torch.equal(h1, h2) and torch.equal(h1, h3)


def noise_mod_add(x, ids, t):
    from repro_torch.kernels import noise as noise_mod

    return noise_mod.noise_add_cuda(x, ids, 42, t, 0.8)


@pytest.mark.parametrize("clear", [True, False])
def test_event_kernel_takes_t_and_the_delays(cuda, rng, clear):
    n, n_p, D, delays = 3000, 2048, 9, (2, 5, 8)
    R = n_p
    cols_np = [rng.integers(0, n, (R, 64)).astype(np.int32) for _ in delays]
    valid = [rng.random((R, 64)) < 0.6 for _ in delays]
    weights = [torch.from_numpy(np.where(v, rng.normal(size=v.shape), 0.0).astype(np.float32))
               .to(cuda) for v in valid]
    plan = event_mod.EventPlan.build(cols_np, valid, n, 64, cuda)
    cols = [torch.from_numpy(c).to(cuda) for c in cols_np]
    act = torch.from_numpy((rng.random(n) < 0.01).astype(np.float32)).to(cuda)
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    for t in (0, 4, 17, 2**31 + 3):
        got, want, plain = ring.clone(), ring.clone(), ring.clone()
        f1 = ops.event_post_exchange(act, got, torch.tensor(t, device=cuda), delays, plan,
                                     cols, weights, clear=clear)
        f2 = ops.event_post_exchange(act, want, t % D if clear else None,
                                     [(t + d) % D for d in delays], plan, cols, weights)
        f3 = event_mod.event_post_exchange_plain(act, plain, torch.tensor(t, device=cuda),
                                                 delays, plan, cols, weights, clear=clear)
        assert torch.equal(f1, f2) and torch.equal(f1, f3)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


def test_checkpointed_and_restored_sessions_run_under_graphs(cuda, tmp_path):
    """``run(checkpoint_every=...)`` and a session restored from its newest
    checkpoint both replay graphs, and equal the uncaptured sessions."""
    from repro_torch.snn import RasterMonitor, Session, SimConfig

    runs = {}
    for graphs in (True, False):
        d = _graph_net("ei", 4)  # save writes the state back into the net: one each
        root = str(tmp_path / f"ck{graphs}")
        ses = Session(d, SimConfig(), engine="spmd", devices=[cuda] * 4, _graphs=graphs)
        mon = RasterMonitor()
        ses.run(96, monitors=[mon], checkpoint_every=32, checkpoint_dir=root, max_to_keep=2)
        ses.wait()
        back = Session(root, SimConfig(), engine="spmd", devices=[cuda] * 4, _graphs=graphs)
        assert back.t == 96
        mon2 = RasterMonitor()
        back.run(40, monitors=[mon2], chunk_size=16)
        runs[graphs] = (mon.raster, mon2.raster, ses.describe()["graphs"],
                        back.describe()["graphs"])
        ses.close()
    (a1, a2, g_ses, g_back), (b1, b2, u_ses, _) = runs[True], runs[False]
    assert a1.sum() > 0 and np.array_equal(a1, b1) and np.array_equal(a2, b2)
    assert g_ses["mode"] == g_back["mode"] == "cuda_graph"
    assert u_ses == dict(mode="uncaptured: _graphs=False", captured=[])
    assert sorted(g["steps"] for g in g_ses["captured"]) == [32]
    assert sorted(g["steps"] for g in g_back["captured"]) == [8, 16]


def _poison_once(at, part=None, row=5):
    """A state hook putting a NaN into one membrane at its ``at``-th call."""
    import math

    calls = []

    def hook(site, state):
        calls.append(site)
        if len(calls) == at:
            carry = state if part is None else state[part]
            carry["vtx_state"][row, 0] = math.nan
        return state

    return hook


@pytest.mark.parametrize("kind,k,fields", [
    ("mc", 1, dict(gather="dense")),
    ("mc", 1, dict(fused=True, gather="event")),
    ("ei", 1, dict()),
    ("ei", 4, dict()),
])
def test_supervised_rollback_keeps_the_graphs_and_stays_bit_equal(cuda, tmp_path, kind, k,
                                                                  fields):
    """On the card, a NaN after the third chunk rolls a supervised run back
    one checkpoint: raster, spike counts and the whole carry bit-equal to an
    undisturbed run from the same state, the same simulator, and no graph
    key added or captured again by the rollback and the re-run."""
    import warnings

    from repro_torch.io import state_fault_hook
    from repro_torch.snn import RasterMonitor, Session, SimConfig

    place = dict(engine="spmd", devices=[cuda] * k) if k > 1 else dict(device=cuda)
    ses = Session(_graph_net(kind, k), SimConfig(**fields), **place)
    sim = ses.simulator
    st0 = ses.state
    plain = RasterMonitor()
    res_plain = ses.run(128, monitors=[plain], chunk_size=32)
    want = ses.state
    keys = {key: (g.what, g.capture_s) for key, g in sim._graphs.graphs.items()}
    ses._state = st0
    mon = RasterMonitor()
    hook = _poison_once(3, part=None if k == 1 else k - 1)
    with state_fault_hook(hook), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = ses.run_supervised(128, monitors=[mon], chunk_size=32, checkpoint_every=64,
                                 checkpoint_dir=str(tmp_path), max_to_keep=2)
    assert (res.rollbacks, res.steps_lost, res.t_final) == (1, 32, 128)
    assert int(plain.raster.sum()) > 0 and np.array_equal(mon.raster, plain.raster)
    assert np.array_equal(res.spike_count, res_plain.spike_count)
    _assert_bit_equal_states(ses.state, want)
    assert ses.simulator is sim and ses.last_rollbacks[0]["in_place"]
    assert {key: (g.what, g.capture_s) for key, g in sim._graphs.graphs.items()} == keys
    assert ses.describe()["graphs"]["mode"] == "cuda_graph"
    ses.close()


@pytest.mark.parametrize("k,restore_k", [(1, None), (4, None), (4, 1)])
def test_streamed_restore_equals_the_eager_one_on_the_card(cuda, tmp_path, k, restore_k):
    """``Session.restore(path, streaming=True)`` onto the card (at the
    snapshot's k, and merged to k=1) gives the eager restore's carry bit for
    bit, and the same next 64 steps."""
    from repro_torch.snn import RasterMonitor, Session, SimConfig

    place = dict(engine="spmd", devices=[cuda] * k) if k > 1 else dict(device=cuda)
    ses = Session(_graph_net("ei", k), SimConfig(), **place)
    ses.run(40)
    ses.save(str(tmp_path / "snap"))
    back = dict(k=restore_k, device=cuda) if restore_k == 1 else place
    out = []
    for streaming in (False, True):
        r = Session.restore(str(tmp_path / "snap"), streaming=streaming, chunk_rows=300, **back)
        assert r.t == 40 and r.k == (restore_k or k)
        mon = RasterMonitor()
        r.run(64, monitors=[mon])
        out.append((r.state, mon.raster))
    (a, ra), (b, rb) = out
    assert int(ra.sum()) > 0 and np.array_equal(ra, rb)
    _assert_bit_equal_states(a, b)
    ses.close()


# -- the heavy-row split and bf16 weights in the gathers ----------------------
#
# The split step's one launch (segment_gather_ring, SimConfig(max_k=...))
# must give the ring of the old composition bit for bit: per bucket the
# unsegmented kernel's virtual rows, added in ascending order
# (ref.segment_add_ref; an unsplit bucket's first n_p rows as they are),
# then the ring add (index_add_ of one row), in both reductions (mixed per
# bucket) and with the activity or its bitmask in shared memory or in
# device memory; a bf16 panel must equal its exact f32 widening bit for
# bit, in spike_gather and fused_step.


def _split_case(rng, n, n_rows, K, depth, device):
    """A heavy-row split's panels: row r owns 1..depth contiguous virtual
    rows (row_ptr), each laid out as the ELL builder lays a row out; eight
    padding rows after them, empty (at n_rows = 1 in row 0's range, as
    ``simulator.split_row_ptr`` leaves them)."""
    counts = rng.integers(1, depth + 1, n_rows)
    counts[0] = depth  # the deepest row is row 0
    row_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    cols, weights, valid = _ell_case(rng, n, int(row_ptr[-1]) + 8, (K,), int(row_ptr[-1]),
                                     device)
    if n_rows == 1:
        row_ptr[-1] += 8
    return (cols[0], weights[0], _row_lengths(valid, device)[0],
            torch.from_numpy(row_ptr).to(device), int(depth))


def _split_step_case(rng, n, n_p, buckets, device):
    """Per bucket ``("split", K, depth)`` or ``("rows", K)``: cols, weights,
    row lengths, row_ptr (None for real rows) and the upload's plan."""
    case = []
    for spec in buckets:
        if spec[0] == "split":
            c, w, rl, rp, _ = _split_case(rng, n, n_p, spec[1], spec[2], device)
        else:
            cols, weights, valid = _ell_case(rng, n, n_p + 8, (spec[1],), n_p, device)
            c, w, rl, rp = cols[0], weights[0], _row_lengths(valid, device)[0], None
        case.append((c, w, rl, rp))
    cols, weights, row_len, row_ptr = map(list, zip(*case))
    plan = seg_mod.segment_plan([None if p is None else p.cpu().numpy() for p in row_ptr],
                        [c.shape[1] for c in cols], n_p, device)
    return cols, weights, row_len, row_ptr, plan


def _old_split_step(act, ring, t, delays, plan, cols, weights, row_len, row_ptr, reduce):
    """The composition the launch replaced: per bucket the unsegmented
    kernel, the ascending segment sum and one index_add_ into its ring row."""
    D, n_p = ring.shape
    for b, (c, w, rl, rp, d) in enumerate(zip(cols, weights, row_len, row_ptr, delays)):
        vrows = gather_mod.spike_gather_cuda(act, c, w, rl, reduce=reduce[b:b + 1])
        cur = vrows[:n_p] if rp is None else ref.segment_add_ref(vrows, rp, plan.depth[b])
        ring.index_add_(0, torch.remainder(t + d, D).view(1), cur[None])
    return ring


@pytest.mark.parametrize("kind", ACT_KINDS)
@pytest.mark.parametrize("n,n_p,buckets,delays", [
    (64, 1, (("split", 32, 5),), (2,)),
    (400, 100, (("split", 32, 3), ("rows", 40), ("split", 24, 1)), (3, 5, 3 + 15)),
    (5000, 2000, (("split", 129, 10), ("split", 1100, 2), ("rows", 64)), (1, 2, 15)),
    (77172, 20000, (("split", 512, 4), ("rows", 512)), (8, 15)),
    (2_000_000, 3000, (("split", 64, 3), ("rows", 96)), (4, 9)),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segmented_gather_bit_exact_vs_ascending_sum(cuda, rng, kind, n, n_p, buckets, delays,
                                                     dtype):
    """The launch's ring equals the unsegmented kernel's virtual rows, the
    ascending segment sum and the ring add, bit for bit, with the activity
    in shared memory (small nets), its bitmask there (the microcircuit's
    77,172 ids) and both in device memory (2M ids)."""
    cols, weights, row_len, row_ptr, plan = _split_step_case(rng, n, n_p, buckets, cuda)
    weights = [w.to(getattr(torch, dtype)) for w in weights]
    act = _activity(kind, rng, n, cuda)
    D = 16
    ring0 = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(cuda)
    t = torch.tensor(21, dtype=torch.int64, device=cuda)
    # bucket 0 on the row_dot variant, the others as recorded (active)
    red = ("row_dot",) + tuple(panel_reduce([w])[0] for w in weights[1:])
    want = _old_split_step(act, ring0.clone(), t, delays, plan, cols, weights, row_len,
                           row_ptr, red)
    # where the activity fits shared memory, else its bitmask where a bucket
    # takes the active reduction and it fits, else device memory
    mode = seg_mod.MODES[0 if 4 * n <= 100_000 else 1 if "active" in red and n < 10**6 else 2]
    before = seg_mod.COUNTER.launches
    for reduce in (red, "row_dot"):
        config = {}
        got = seg_mod.segment_gather_ring_cuda(act, ring0.clone(), t, delays, plan, cols,
                                               weights, row_len, row_ptr, reduce=reduce,
                                               config=config)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), reduce
        if reduce is red:
            assert config["mode"] == mode, config
    assert seg_mod.COUNTER.launches == before + 2
    assert torch.equal(ops.segment_gather_ring(act, ring0.clone(), t, delays, plan, cols, weights,
                                               row_len, row_ptr, reduce=red), want)
    # the plain version: the gathers summed in another order
    plain = ref.segment_gather_ring_ref(act, ring0.clone(), t, delays, cols, weights, row_ptr,
                                        plan.depth)
    torch.testing.assert_close(want, plain, rtol=1e-5, atol=1e-4)


def test_segmented_gather_refuses_shared_write_slots(cuda):
    """Two buckets whose delays meet in one ring row (3 and 19 with D=16):
    the step never makes them, and the kernel adds every bucket in parallel."""
    act = torch.zeros(32, device=cuda)
    c = torch.zeros((2, 4), dtype=torch.int32, device=cuda)
    w = torch.zeros((2, 4), device=cuda)
    plan = seg_mod.segment_plan([None, None], [4, 4], 2, cuda)
    ring = torch.zeros((16, 2), device=cuda)
    before = seg_mod.COUNTER.launches
    with pytest.raises(ValueError, match="share a ring slot"):
        seg_mod.segment_gather_ring_cuda(act, ring, 0, [3, 19], plan, [c, c], [w, w])
    assert seg_mod.COUNTER.launches == before
    seg_mod.segment_gather_ring_cuda(act, ring, 0, [3, 18], plan, [c, c], [w, w])
    assert seg_mod.COUNTER.launches == before + 1


@pytest.mark.parametrize("kind", ACT_KINDS)
@pytest.mark.parametrize("n_act,R,K", [(64, 8, 32), (1000, 1000, 200), (20000, 20000, 1408)])
def test_bf16_spike_gather_equals_its_f32_widening(cuda, rng, kind, n_act, R, K):
    """The reference's bf16 sweep shapes and larger: a bf16 panel gives the
    currents of its f32 widening bit for bit (the widening is exact, the
    sums the same); bf16 activity is cast to f32 as the reference casts it."""
    cols, weights, valid = _ell_case(rng, n_act, R, (K,), R, cuda)
    c, rl = cols[0], _row_lengths(valid, cuda)[0]
    w16 = weights[0].to(torch.bfloat16)
    w32 = w16.float()
    act = _activity(kind, rng, n_act, cuda)
    for red in (panel_reduce([w16]), "row_dot"):
        got = ops.spike_gather(act, c, w16, rl, reduce=red)
        assert got.dtype == torch.float32
        assert torch.equal(got.view(torch.int32),
                           ops.spike_gather(act, c, w32, rl, reduce=red).view(torch.int32))
    assert torch.equal(ops.spike_gather(act.to(torch.bfloat16), c, w16, rl, reduce="row_dot"),
                       ops.spike_gather(act, c, w32, rl, reduce="row_dot"))
    torch.testing.assert_close(got, ref.spike_gather_ref(act, c, w16), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("n_p,R,ks", [
    (64, 64, (16,)), (100, 104, (8, 24)), (37, 40, (4, 12, 20)), (19288, 19288, (512, 1408)),
])
def test_bf16_fused_step_equals_its_f32_widening(cuda, rng, n_p, R, ks):
    v, r, i = _lif_inputs(rng, n_p, cuda)
    cols, weights = _panels(rng, n_p, R, ks, n_p, cuda)
    w16 = [w.to(torch.bfloat16) for w in weights]
    w32 = [w.float() for w in w16]
    for red in (panel_reduce(w16), "row_dot"):
        got = ops.fused_step(v, r, i, cols, w16, params=LIF_PARAMS, reduce=red)
        want = ops.fused_step(v, r, i, cols, w32, params=LIF_PARAMS, reduce=red)
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b)
        for a, b in zip(got[3], want[3]):
            assert a.dtype == torch.float32 and torch.equal(a.view(torch.int32), b.view(torch.int32))
    _, _, s_p, curs_p = ref.fused_step_ref(v, r, i, cols, w16, params=LIF_PARAMS)
    assert torch.equal(got[2], s_p)
    for a, b in zip(got[3], curs_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


def test_gathers_refuse_mixed_or_wide_weights(cuda):
    act = torch.zeros(32, device=cuda)
    c = torch.zeros((8, 4), dtype=torch.int32, device=cuda)
    w = torch.zeros((8, 4), device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        gather_mod.spike_gather_cuda(act, c, w.double())
    with pytest.raises(TypeError):
        fused_mod.fused_step_cuda(act, act, act, [c, c], [w, w.to(torch.bfloat16)],
                                  params=LIF_PARAMS)
    plan = seg_mod.segment_plan([np.array([0, 1, 2], np.int32)], [4], 2, cuda)
    ring = torch.zeros((4, 2), device=cuda)
    with pytest.raises(TypeError):
        seg_mod.segment_gather_ring_cuda(act, ring, 0, [1], plan, [c], [w],
                                         row_ptr=[torch.zeros(3, dtype=torch.int64, device=cuda)])
    with pytest.raises(TypeError):
        seg_mod.segment_gather_ring_cuda(act, ring, 0, [1, 2], seg_mod.segment_plan(
            [None, None], [4, 4], 2, cuda), [c, c], [w, w.to(torch.bfloat16)])


@pytest.mark.parametrize("kind,max_k", [("mc", 64), ("ei", 16)])
def test_max_k_graphs_equal_the_uncaptured_loop(cuda, kind, max_k):
    """SimConfig(max_k=...) on the card: the unfused engine with split
    buckets, graphed against _graphs=False bit-equal (raster, state, traces,
    weights), one segment_gather launch a step for all buckets and no
    spike_gather; an uncaptured chunk makes no host sync."""
    on, off = _graph_sims(cuda, kind, 1, max_k=max_k, align_k=32)
    assert on.engine_choice.engine == "unfused"
    split = sum(not x for x in on.dev.identity_rows)
    assert split >= 1
    (st_a, r_a, n_a), (st_b, r_b, n_b) = _graph_ab(on, off, (64, 64, 20))
    assert int(r_a.sum()) > 0 and torch.equal(r_a, r_b)
    _assert_bit_equal_states(st_a, st_b)
    assert n_a == n_b
    assert n_a[_build.COUNTERS.index(seg_mod.COUNTER)] == 148
    assert n_a[_build.COUNTERS.index(gather_mod.COUNTER)] == 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        off.run(st_b, 16)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_contract_matrix_on_the_card(cuda):
    """The card view of every row of the engine-contract matrix: the ops of
    uncaptured steps, the captured graphs' nodes (no memcpy to the host)
    and an uncaptured chunk under set_sync_debug_mode("error")."""
    from repro_torch.analysis.contracts import run_matrix

    violations, results = run_matrix(device=cuda, verbose=False)
    assert violations == []
    for name, res in results.items():
        assert res.kernels_per_step and all(k > 0 for k in res.kernels_per_step.values()), name


# -- bf16 weights in the post-exchange gathers ----------------------------------

def _post_args(rng, n_p, n, R, ks, device, p_active=0.1):
    """ELL-layout panels (real slots first, (col 0, weight 0) after), their
    row lengths, an activity, a ring and the slot tables of one step."""
    cols, weights, valid = _ell_case(rng, n, R, ks, n_p, device)
    act = torch.from_numpy((rng.random(n) < p_active).astype(np.float32)).to(device)
    D = 16
    ring = torch.from_numpy(rng.normal(size=(D, n_p)).astype(np.float32)).to(device)
    slot, write = 5, [(5 + 2 + 3 * i) % D for i in range(len(ks))]
    clear = torch.ones(D, device=device)
    clear[slot] = 0.0
    onehot = torch.zeros((len(ks), D), device=device)
    for i, w in enumerate(write):
        onehot[i, w] = 1.0
    return cols, weights, _row_lengths(valid, device), act, ring, slot, write, clear, onehot


@pytest.mark.parametrize("variant", ["full", "local", "remote"])
@pytest.mark.parametrize("n_p,R,ks", [(100, 104, (8, 24)), (19288, 19288, (512, 1408))])
def test_bf16_post_exchange_equals_its_f32_widening(cuda, rng, variant, n_p, R, ks):
    """The three post_exchange passes on bf16 panels give the ring of the
    panels' f32 widening bit for bit (both reductions), and the plain
    version's within the f32 tolerance."""
    n = n_p if variant == "local" else 4 * n_p
    cols, weights, row_len, act, ring, _, _, clear, onehot = _post_args(rng, n_p, n, R, ks, cuda)
    w16 = [w.to(torch.bfloat16) for w in weights]
    w32 = [w.float() for w in w16]
    before = split_mod.POST_COUNTER.launches
    for red in (panel_reduce(w16), "row_dot"):
        if variant == "remote":
            got = ops.fused_post_exchange_remote(act, ring, onehot, cols, w16, row_len, reduce=red)
            want = ops.fused_post_exchange_remote(act, ring, onehot, cols, w32, row_len,
                                                  reduce=red)
        else:
            op = ops.fused_post_exchange_local if variant == "local" else ops.fused_post_exchange
            got = op(act, ring, clear, onehot, cols, w16, row_len, reduce=red)
            want = op(act, ring, clear, onehot, cols, w32, row_len, reduce=red)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert split_mod.POST_COUNTER.launches == before + 4
    if variant == "remote":
        plain = ref.fused_post_exchange_remote_ref(act, ring, onehot, cols, w16)
    else:
        plain = ref.fused_post_exchange_ref(act, ring, clear, onehot, cols, w16)
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("clear", [True, False])
@pytest.mark.parametrize("n_p,R,ks,p_active", [(100, 104, (8, 24), 0.05),
                                               (19288, 19288, (512, 1408), 0.002)])
def test_bf16_event_post_exchange_equals_its_f32_widening(cuda, rng, clear, n_p, R, ks, p_active):
    cols, weights, row_len, act, ring, slot, write, _, _ = _post_args(rng, n_p, n_p, R, ks, cuda,
                                                                     p_active)
    valid = [rl[:, None] > torch.arange(c.shape[1], device=cuda)[None, :]
             for rl, c in zip(row_len, cols)]
    plan = event_mod.EventPlan.build([c.cpu().numpy() for c in cols],
                                     [v.cpu().numpy() for v in valid], n_p, 256, cuda)
    w16 = [w.to(torch.bfloat16) for w in weights]
    w32 = [w.float() for w in w16]
    for red in (panel_reduce(w16), "row_dot"):
        a, b = ring.clone(), ring.clone()
        fa = ops.event_post_exchange(act, a, slot if clear else None, write, plan, cols, w16,
                                     row_len, reduce=red)
        fb = ops.event_post_exchange(act, b, slot if clear else None, write, plan, cols, w32,
                                     row_len, reduce=red)
        assert torch.equal(fa, fb) and torch.equal(a.view(torch.int32), b.view(torch.int32))
    want = ring.clone()
    event_mod.event_post_exchange_plain(act, want, slot if clear else None, write, plan, cols,
                                        w16)
    torch.testing.assert_close(a, want, rtol=1e-5, atol=1e-4)


def test_post_exchange_gathers_refuse_mixed_or_wide_weights(cuda, rng):
    cols, weights, row_len, act, ring, slot, write, clear, onehot = _post_args(
        rng, 64, 64, 64, (8, 16), cuda)
    mixed = [weights[0], weights[1].to(torch.bfloat16)]
    with pytest.raises(TypeError):
        split_mod.post_exchange_cuda(act, ring, clear, onehot, cols, mixed)
    with pytest.raises(TypeError, match="bfloat16"):
        split_mod.post_exchange_cuda(act, ring, clear, onehot, cols, [w.double() for w in weights])
    valid = [np.ones(tuple(c.shape), bool) for c in cols]
    plan = event_mod.EventPlan.build([c.cpu().numpy() for c in cols], valid, 64, 64, cuda)
    with pytest.raises(TypeError):
        event_mod.event_post_exchange_cuda(act, ring, slot, write, plan, cols, mixed)


# -- the LM substrate's serving path ----------------------------------------------

LM_FAMILIES = ["smollm-135m", "granite-moe-3b-a800m", "recurrentgemma-2b", "xlstm-350m",
               "paligemma-3b", "whisper-small"]


def _lm_case(name, device, seed=0):
    from repro_torch.configs import get_config

    cfg = get_config(name).reduced()
    gen = torch.Generator(device=device).manual_seed(seed)
    prompt = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen, device=device)
    kw = {}
    if cfg.encdec:
        kw["frames"] = torch.randn((2, 10, cfg.d_model), generator=gen, device=device)
    elif cfg.n_img_tokens:
        kw["img_embed"] = torch.randn((2, cfg.n_img_tokens, cfg.d_model), generator=gen,
                                      device=device)
    return cfg, prompt, kw


def _lm_steps(model, cfg, prompt, kw, device):
    """A prefill of 10 tokens and two decode steps on the prompt's last two;
    the logits of all three, on the CPU."""
    n_img = cfg.n_img_tokens or 0
    cache = model.init_cache(2, 12, 10) if cfg.encdec else model.init_cache(2, 12 + n_img)
    p = prompt.to(device)
    kw = {k: v.to(device) for k, v in kw.items()}
    with torch.no_grad():
        lg, cache, _ = model(p[:, :10], cache=cache, **kw)
        outs = [lg]
        for i in range(2):
            lg, cache, _ = model(p[:, 10 + i:11 + i], cache=cache,
                                 cache_pos=torch.tensor(10 + n_img + i, device=device))
            outs.append(lg)
    return [o.cpu() for o in outs]


@pytest.mark.parametrize("name", LM_FAMILIES)
def test_lm_card_matches_the_cpu(cuda, name):
    """One reduced arch per family (fp32): prefill and two decode steps on
    the card against the same parameters on the CPU; greedy tokens equal."""
    from repro_torch.models import build_model
    from repro_torch.train import greedy_generate

    cfg, prompt, kw = _lm_case(name, cuda)
    model = build_model(cfg, generator=torch.Generator(cuda).manual_seed(3))
    assert model.emb.embed.device.type == "cuda"
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        card = _lm_steps(model, cfg, prompt, kw, cuda)
        toks = greedy_generate(model, cfg, prompt[:, :8], 5, extras=kw or None,
                               cache_len=13 + (cfg.n_img_tokens or 0)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    model.cpu()
    cpu = _lm_steps(model, cfg, prompt, kw, torch.device("cpu"))
    for a, b in zip(card, cpu):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    want = greedy_generate(model, cfg, prompt[:, :8].cpu(), 5,
                           extras={k: v.cpu() for k, v in kw.items()} or None,
                           cache_len=13 + (cfg.n_img_tokens or 0))
    assert torch.equal(toks, want)


@pytest.mark.parametrize("name", LM_FAMILIES)
def test_lm_decode_step_never_syncs_the_host(cuda, name):
    """A decode step reads its position from the card and writes the cache
    in place: nothing in it waits on the host."""
    from repro_torch.models import build_model
    from repro_torch.train import make_prefill_fn, make_serve_step

    cfg, prompt, kw = _lm_case(name, cuda)
    model = build_model(cfg)
    cache, logits = make_prefill_fn(model, cfg, cache_len=16 + (cfg.n_img_tokens or 0))(
        prompt, kw or None)
    step = make_serve_step(model, cfg)
    pos = torch.full((), 12, dtype=torch.int32, device=cuda)
    nxt = logits.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            logits, cache = step(cache, nxt, pos)
            nxt = logits.argmax(-1, keepdim=True)
            pos = pos + 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(logits).all())


# -- the LM substrate's training slice ---------------------------------------------

def _train_batch(cfg, prompt, kw):
    return dict(tokens=prompt.to(torch.int32), **kw)


@pytest.mark.parametrize("name", LM_FAMILIES)
def test_lm_train_step_card_matches_the_cpu(cuda, name):
    """One reduced arch per family (fp32): the loss and every gradient on
    the card against the same parameters and batch on the CPU (a leaf
    within 1e-4 of its largest |g|, floored at 1e-3 of the model's
    largest); then one AdamW update (fp32 moments, clipping, decay) on both
    given the CPU's gradients: the parameters within 2^-21 of max(1,
    |p|), the moments within 1e-6 of their largest.  (Each device's own
    gradients would not do for the update: a gradient that is zero but for
    rounding, as the keys' bias gradient, moves its parameter by a full
    ``lr`` in the rounding's direction under Adam.)"""
    from repro_torch.models import build_model, lm_param_leaves
    from repro_torch.train import AdamW, make_loss_fn
    from repro_torch.train.optimizer import flat_params

    cfg, prompt, kw = _lm_case(name, cuda)
    batch = _train_batch(cfg, prompt, kw)
    model = build_model(cfg, generator=torch.Generator(cuda).manual_seed(3))
    twin = build_model(cfg, device="cpu")
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    opt = AdamW(lr=1e-2)
    runs = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for m, dev in ((model, cuda), (twin, torch.device("cpu"))):
            state = opt.init(lm_param_leaves(cfg, m))
            loss, _ = make_loss_fn(m, cfg)({k: v.to(dev) for k, v in batch.items()})
            grads = torch.autograd.grad(loss, flat_params(state), materialize_grads=True,
                                        allow_unused=True)
            runs.append((state, float(loss.detach()), [g.cpu() for g in grads]))
        (s_card, l_card, g_card), (s_cpu, l_cpu, g_cpu) = runs
        assert abs(l_card - l_cpu) <= 1e-4 * abs(l_cpu)
        floor = 1e-3 * max(float(g.abs().max()) for g in g_cpu)
        for a, b in zip(g_card, g_cpu):
            assert float((a - b).abs().max()) <= 1e-4 * max(float(b.abs().max()), floor)
        opt.update([g.to(cuda) for g in g_cpu], s_card)
        opt.update(g_cpu, s_cpu)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(flat_params(s_card), flat_params(s_cpu)):
        bound = 2.0**-21 * max(1.0, float(b.abs().max()))
        assert float((a.detach().cpu() - b.detach()).abs().max()) <= bound
    for key in ("m", "v"):
        for a, b in zip(s_card[key], s_cpu[key]):
            assert float((a.cpu() - b).abs().max()) <= 1e-6 * float(b.abs().max())


@pytest.mark.parametrize("name", LM_FAMILIES)
def test_lm_train_step_never_syncs_the_host(cuda, name):
    """A train step with its batch on the card (forward, backward, clipping,
    AdamW with 8-bit moments, the cosine schedule) reads nothing back to the
    host."""
    from repro_torch.models import build_model, lm_param_leaves
    from repro_torch.train import AdamW, cosine_schedule, make_train_step

    cfg, prompt, kw = _lm_case(name, cuda)
    batch = _train_batch(cfg, prompt, kw)
    model = build_model(cfg)
    opt = AdamW(lr=cosine_schedule(1e-3, 2, 10), quantize_moments=True)
    state = opt.init(lm_param_leaves(cfg, model))
    step = make_train_step(model, cfg, opt, grad_accum=2)
    state, metrics = step(state, batch)  # warm: the first step allocates
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(metrics["loss"])) and int(state["count"]) == 2


def test_adamw_8bit_card_matches_the_cpu(cuda):
    """The 8-bit moments on the card against the CPU on the same gradients
    (recurrentgemma-2b reduced at 8 layers: stacked 2-D norms whose blocks
    straddle layers, per-slice blocks, and rest layers): ``scale`` within
    1e-6 relative, ``q`` apart by at most one step in at most 1 in 10^4
    entries (a division rounded to a tie one way on the card)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model, lm_param_leaves
    from repro_torch.train import AdamW

    cfg = dataclasses.replace(get_config("recurrentgemma-2b").reduced(), n_layers=8)
    model = build_model(cfg, generator=torch.Generator(cuda).manual_seed(3))
    twin = build_model(cfg, device="cpu")
    twin.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    opt = AdamW(lr=1e-2, quantize_moments=True)
    gen = torch.Generator().manual_seed(0)
    grads = [[0.01 * torch.randn(p.shape, generator=gen)
              for leaf in lm_param_leaves(cfg, twin) for p in leaf.params]
             for _ in range(3)]
    states = []
    for m, dev in ((model, cuda), (twin, torch.device("cpu"))):
        state = opt.init(lm_param_leaves(cfg, m))
        for gs in grads:
            state, _ = opt.update([g.to(dev) for g in gs], state)
        states.append(state)
    card, cpu = states
    n_diff = n_all = 0
    for key in ("m", "v"):
        for a, b in zip(card[key], cpu[key]):
            torch.testing.assert_close(a["scale"].cpu(), b["scale"], rtol=1e-6, atol=0)
            d = (a["q"].cpu().int() - b["q"].int()).abs()
            assert int(d.max()) <= 1
            n_diff += int((d > 0).sum())
            n_all += d.numel()
    assert n_diff <= max(n_all // 10**4, 1), (n_diff, n_all)


# -- the sharding policy on a one-card mesh ------------------------------------------

def test_mesh_policy_on_a_one_card_nccl_mesh(cuda):
    """``chip_smoke.py``'s ``[mesh]`` checks at ``reduced()`` widths, in a
    fresh process (``--mesh-child --reduced``: a world-size-1 NCCL group and
    a 1x1 ``("data", "model")`` mesh): smollm-135m's 2 train steps with the
    policy against 2 without (losses within 1e-5 relative, parameters
    within 2 x lr and at most 1 in 10^4 elements over 1e-6 apart), and
    granite-moe-3b-a800m's EP path under the policy giving the gspmd path's
    greedy tokens without one.  No process group outlives the child."""
    import os
    import sys

    import torch.distributed as dist

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    res = chip_smoke.run_mesh_child(0, True, 600)
    chip_smoke.check_mesh(res)
    assert res["device"] == torch.cuda.get_device_name(0)
    assert len(res["serve"]["gspmd"]["tokens"][0]) == chip_smoke.MESH_GRANITE[3] + 1
    assert not dist.is_initialized()
