"""bf16 weights through the port's two gather ops on the CPU, against the
reference's bf16 sweeps (``tests/test_kernels.py:22-48``,
``tests/test_fused_step.py:36-55``).

The same numpy inputs, cast to bf16, go through the reference's Pallas
kernels in interpret mode (``spike_gather_pallas``,
``fused_lif_step_pallas``), its oracles (``repro.kernels.ref``) and the
port's ``ops.spike_gather`` and ``ops.fused_step`` on CPU tensors (the plain
versions, which widen with ``.float()``).  The widening is exact and every
sum runs in f32, so only the order of the f32 sums differs: the f32
tolerances hold (1e-6 for the gather, 1e-5 for the fused step, as the
reference's f32 cases).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.fused_step import fused_lif_step_pallas
from repro.kernels.spike_gather import spike_gather_pallas
from repro_torch.kernels import dispatch, ops, ref

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)


def _bf16(a):
    """``a`` rounded to bf16: the port's tensor and the reference's array."""
    t = torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("R,K,n", [(8, 8, 50), (16, 32, 300), (64, 16, 1000), (128, 128, 4096)])
def test_spike_gather_bf16_matches_the_reference(R, K, n):
    rng = np.random.default_rng(R * K)
    act = (rng.random(n) < 0.2).astype(np.float32)
    cols = rng.integers(0, n, (R, K)).astype(np.int32)
    w = (rng.normal(size=(R, K)) * (rng.random((R, K)) < 0.5)).astype(np.float32)
    (act_t, act_j), (w_t, w_j) = _bf16(act), _bf16(w)
    cols_t = torch.from_numpy(cols)
    got = ops.spike_gather(act_t, cols_t, w_t)
    assert got.dtype == torch.float32 and got.shape == (R,)
    for want in (spike_gather_pallas(act_j, jnp.asarray(cols), w_j, block_r=8, block_k=8,
                                     interpret=True),
                 jref.spike_gather_ref(act_j, jnp.asarray(cols), w_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), rtol=1e-6,
                                   atol=1e-6)
    # the exact widening: the f32 panel of the same values gives the same bits
    assert torch.equal(got, ops.spike_gather(act_t.float(), cols_t, w_t.float()))


@pytest.mark.parametrize("n_p,R,ks", [(64, 64, (16,)), (100, 104, (8, 24)), (37, 40, (4, 12, 20))])
def test_fused_step_bf16_matches_the_reference(rng, n_p, R, ks):
    v = (-65.0 + 20.0 * rng.random(n_p)).astype(np.float32)
    refrac = rng.integers(0, 3, n_p).astype(np.float32)
    i_tot = (8.0 * rng.random(n_p)).astype(np.float32)
    cols, w_t, w_j = [], [], []
    for K in ks:
        cols.append(rng.integers(0, n_p, (R, K)).astype(np.int32))
        w = rng.normal(size=(R, K)).astype(np.float32)
        w[n_p:] = 0
        t, j = _bf16(w)
        w_t.append(t)
        w_j.append(j)
    state = [torch.from_numpy(a) for a in (v, refrac, i_tot)]
    got = ops.fused_step(*state, [torch.from_numpy(c) for c in cols], w_t, params=LIF_PARAMS)
    jargs = (jnp.asarray(v), jnp.asarray(refrac), jnp.asarray(i_tot),
             tuple(jnp.asarray(c) for c in cols), tuple(w_j))
    for want in (fused_lif_step_pallas(*jargs, params=LIF_PARAMS, interpret=True),
                 jref.fused_step_ref(*jargs, params=LIF_PARAMS)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        for a, b in zip(got[3], want[3]):
            assert a.dtype == torch.float32
            np.testing.assert_allclose(a.numpy(), np.asarray(b, np.float32), rtol=1e-5, atol=1e-5)


def test_segmented_gather_takes_bf16_weights(rng):
    """The heavy-row split's plain version widens the same way: a bf16
    panel gives its f32 widening's segment sums bit for bit."""
    n, R, K = 300, 40, 16
    row_ptr = torch.tensor([0, 3, 4, 9, 9 + 31], dtype=torch.int32)
    act = torch.from_numpy((rng.random(n) < 0.3).astype(np.float32))
    cols = torch.from_numpy(rng.integers(0, n, (R, K)).astype(np.int32))
    w16, _ = _bf16(rng.normal(size=(R, K)))
    got = ops.spike_gather(act, cols, w16, row_ptr=row_ptr)
    assert got.dtype == torch.float32 and got.shape == (4,)
    assert torch.equal(got, ops.spike_gather(act, cols, w16.float(), row_ptr=row_ptr))
    assert torch.equal(got, ref.segment_add_ref(ref.spike_gather_ref(act, cols, w16), row_ptr))


def test_panel_reduce_reads_bf16_panels():
    ok = torch.ones((4, 8), dtype=torch.bfloat16)
    bad = ok.clone()
    bad[1, 2] = float("nan")
    assert dispatch.panel_reduce([ok, bad]) == ("active", "row_dot")
    assert dispatch.panel_reduce([ok], plastic=True) == ("row_dot",)
