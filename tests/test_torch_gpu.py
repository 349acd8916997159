"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here carries the ``gpu`` marker and skips inside the ``cuda``
fixture when there is no card.  On a machine with one:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The file imports no JAX: the kernels are held against the port's own plain
versions, which ``tests/test_torch_kernels.py`` holds against the JAX
oracles on the CPU.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import event_step as event_mod
from repro_torch.kernels import fused_step as fused_mod
from repro_torch.kernels import lif_step as lif_mod
from repro_torch.kernels import spike_gather as gather_mod

pytestmark = pytest.mark.gpu

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)


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
    got = ops.spike_gather(act, c, w)
    want = ref.spike_gather_ref(act, c, w)
    # f32 sums in another order: rtol=atol=1e-5
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # deterministic: the same launch gives the same bits
    assert torch.equal(got, ops.spike_gather(act, c, w))


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
    v2, r2, s2, curs = ops.fused_step(v, r, i, cols, weights, params=LIF_PARAMS)
    assert fused_mod.COUNTER.launches == before + 1
    v1, r1, s1 = ops.lif_step(v, r, i, params=LIF_PARAMS)
    for a, b in zip((v2, r2, s2), (v1, r1, s1)):
        assert torch.equal(a, b)
    for cur, c, w in zip(curs, cols, weights):
        assert torch.equal(cur, ops.spike_gather(s1, c, w))
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
    flags = ops.event_post_exchange(act, got, slot, write, plan, cols, weights)
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
        dense[ws] += ops.spike_gather(act, c, w)[:n_p]
    assert torch.equal(got, dense)
    # deterministic although the ids are compacted with atomics
    again = ring.clone()
    assert torch.equal(ops.event_post_exchange(act, again, slot, write, plan, cols,
                                               weights), flags)
    assert torch.equal(again, got)


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
