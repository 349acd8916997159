"""The port's plain kernel versions against the JAX oracles, on the CPU.

The same numpy inputs go through ``repro.kernels.ref`` (the JAX oracles),
``repro.kernels.ops`` with ``backend="pallas_interpret"`` (the TPU kernel
bodies in interpret mode) and the port's ``repro_torch.kernels.ops`` on CPU
tensors, which take the plain torch versions.  Tolerances are stated per
test.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import dispatch, ops, ref

LIF_PARAMS = dict(
    dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
    t_ref=2.0, r_m=1.0,
)


def _lif_inputs(rng, n, params=LIF_PARAMS):
    """v, refrac, i_syn with no membrane within 1e-4 of the threshold after
    the update, so one ulp of difference cannot flip a spike."""
    v = (-66.0 + 20.0 * rng.random(n)).astype(np.float32)
    refrac = rng.integers(0, 3, n).astype(np.float32)
    i = (30.0 * rng.random(n)).astype(np.float32)
    decay = np.exp(-params["dt"] / params["tau_m"])
    v_int = params["v_rest"] + (v - params["v_rest"]) * decay \
        + params["r_m"] * i * (1 - decay)
    near = np.abs(v_int - params["v_thresh"]) < 1e-4
    i[near] += 0.5
    return v, refrac, i


@pytest.mark.parametrize("n", [1, 37, 128, 1000, 4099])
def test_lif_step_plain_matches_jax_oracle_and_interpret(rng, n):
    v, refrac, i = _lif_inputs(rng, n)
    got = [
        x.numpy() for x in ops.lif_step(
            torch.from_numpy(v), torch.from_numpy(refrac), torch.from_numpy(i),
            params=LIF_PARAMS,
        )
    ]
    oracle = jref.lif_step_ref(
        jnp.asarray(v), jnp.asarray(refrac), jnp.asarray(i), **LIF_PARAMS
    )
    interp = jops.lif_step(
        jnp.asarray(v), jnp.asarray(refrac), jnp.asarray(i),
        params=LIF_PARAMS, backend="pallas_interpret",
    )
    for want in (oracle, interp):
        v_w, r_w, s_w = (np.asarray(x) for x in want)
        # spikes and refractory counters exact; v within one-ulp scale
        np.testing.assert_array_equal(got[2], s_w)
        np.testing.assert_array_equal(got[1], r_w)
        np.testing.assert_allclose(got[0], v_w, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dt,tau_m", [(0.1, 10.0), (0.1, 20.0), (1.0, 10.0)])
def test_lif_constants_match_the_oracle_decay(dt, tau_m):
    decay, ref_steps = ref.lif_constants(dt, tau_m, 2.0)
    want = np.asarray(jnp.exp(-dt / tau_m).astype(jnp.float32))
    assert np.float32(decay) == want
    assert ref_steps == round(2.0 / dt)


def test_alif_and_izhikevich_plain_match_jax(rng):
    n = 300
    v = (-66.0 + 20.0 * rng.random(n)).astype(np.float32)
    refrac = rng.integers(0, 3, n).astype(np.float32)
    adapt = rng.random(n).astype(np.float32)
    i = (30.0 * rng.random(n)).astype(np.float32)
    p = dict(LIF_PARAMS, tau_adapt=100.0, beta=0.2)
    got = ref.alif_step_ref(*map(torch.from_numpy, (v, refrac, adapt, i)), **p)
    want = jref.alif_step_ref(*map(jnp.asarray, (v, refrac, adapt, i)), **p)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    vz = (-80.0 + 120.0 * rng.random(n)).astype(np.float32)
    u = (-20.0 + 10.0 * rng.random(n)).astype(np.float32)
    pz = dict(dt=0.1, a=0.02, b=0.2, c=-65.0, d=8.0)
    got = ref.izhikevich_step_ref(*map(torch.from_numpy, (vz, u, i)), **pz)
    want = jref.izhikevich_step_ref(*map(jnp.asarray, (vz, u, i)), **pz)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("R,K,n", [
    (8, 128, 64), (64, 256, 100), (100, 24, 37), (256, 512, 1000),
    (40, 1024, 500),
])
def test_spike_gather_plain_matches_jax_oracle_and_interpret(rng, R, K, n):
    act = (rng.random(n) < 0.3).astype(np.float32)
    cols = rng.integers(0, n, (R, K)).astype(np.int32)
    w = rng.normal(size=(R, K)).astype(np.float32)
    got = ops.spike_gather(
        torch.from_numpy(act), torch.from_numpy(cols), torch.from_numpy(w)
    ).numpy()
    for backend in ("ref", "pallas_interpret"):
        want = np.asarray(jops.spike_gather(
            jnp.asarray(act), jnp.asarray(cols), jnp.asarray(w), backend=backend,
        ))
        # f32 sums in another order: rtol=atol=1e-5
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _fused_case(rng, n_p, R, ks):
    v, refrac, i = _lif_inputs(rng, n_p)
    cols, weights = [], []
    for K in ks:
        c = rng.integers(0, n_p, (R, K)).astype(np.int32)
        w = rng.normal(size=(R, K)).astype(np.float32)
        w[n_p:] = 0  # padded rows carry no synapses
        cols.append(c)
        weights.append(w)
    return v, refrac, i, cols, weights


@pytest.mark.parametrize("n_p,R,ks", [
    (64, 64, (16,)),  # aligned, single bucket
    (100, 104, (8, 24)),  # non-aligned rows, two buckets
    (37, 40, (4, 12, 20)),  # odd sizes, three buckets
    (96, 96, (16, 32)),
])
def test_fused_step_plain_matches_jax_oracle_and_interpret(rng, n_p, R, ks):
    v, refrac, i, cols, weights = _fused_case(rng, n_p, R, ks)
    v2, r2, s2, curs = ops.fused_step(
        torch.from_numpy(v), torch.from_numpy(refrac), torch.from_numpy(i),
        [torch.from_numpy(c) for c in cols],
        [torch.from_numpy(w) for w in weights],
        params=LIF_PARAMS,
    )
    for backend in ("ref", "pallas_interpret"):
        v_w, r_w, s_w, cur_w = jops.fused_step(
            jnp.asarray(v), jnp.asarray(refrac), jnp.asarray(i),
            [jnp.asarray(c) for c in cols], [jnp.asarray(w) for w in weights],
            params=LIF_PARAMS, backend=backend,
        )
        np.testing.assert_array_equal(s2.numpy(), np.asarray(s_w))
        np.testing.assert_array_equal(r2.numpy(), np.asarray(r_w))
        np.testing.assert_allclose(v2.numpy(), np.asarray(v_w), rtol=1e-6, atol=1e-6)
        for a, b in zip(curs, cur_w):
            # f32 sums in another order: rtol=atol=1e-5
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_fused_plain_is_lif_then_gather_bit_for_bit(rng):
    v, refrac, i, cols, weights = _fused_case(rng, 200, 208, (16, 48, 8))
    tv = [torch.from_numpy(a) for a in (v, refrac, i)]
    tc = [torch.from_numpy(c) for c in cols]
    tw = [torch.from_numpy(w) for w in weights]
    v2, r2, s2, curs = ops.fused_step(*tv, tc, tw, params=LIF_PARAMS)
    v1, r1, s1 = ops.lif_step(*tv, params=LIF_PARAMS)
    assert torch.equal(v1, v2) and torch.equal(r1, r2) and torch.equal(s1, s2)
    for cur, c, w in zip(curs, tc, tw):
        assert torch.equal(cur, ops.spike_gather(s1, c, w))


def test_backend_follows_the_device():
    assert dispatch.backend_for(torch.device("cpu")) == "ref"
    assert dispatch.backend_for(torch.device("cuda", 0)) == "cuda"
    with pytest.raises(ValueError, match="no kernels"):
        dispatch.backend_for(torch.device("meta"))
    x = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        dispatch.lookup("spike_gather", "cuda")(x, torch.zeros((4, 2), dtype=torch.int32), torch.zeros((4, 2)))


def test_step_engine_selection():
    sel = dict(models_present=("lif",), identity_rows=True, n_delay_buckets=2)
    assert dispatch.select_step_engine(backend="cuda", **sel).engine == "fused"
    assert dispatch.select_step_engine(backend="ref", **sel).engine == "unfused"
    assert dispatch.select_step_engine(backend="ref", fused=True, **sel).engine == "fused"
    assert dispatch.select_step_engine(backend="cuda", fused=False, **sel).engine == "unfused"
    ev = dispatch.select_step_engine(backend="cuda", gather="event", **sel)
    assert ev.engine == "fused_event" and ev.event and ev.fused
    assert dispatch.select_step_engine(
        backend="ref", fused=True, gather="event", **sel).engine == "fused_event"
    assert dispatch.select_step_engine(
        backend="ref", gather="event", **sel).engine == "unfused"
    with pytest.raises(ValueError, match="resolved by Session"):
        dispatch.select_step_engine(backend="cuda", gather="auto", **sel)
    many = dict(sel, n_delay_buckets=dispatch.FUSED_MAX_BUCKETS + 1)
    assert dispatch.select_step_engine(backend="cuda", **many).engine == "unfused"
    with pytest.raises(ValueError, match="argument table"):
        dispatch.select_step_engine(backend="cuda", fused=True, **many)
    mixed = dict(sel, models_present=("lif", "izhikevich"))
    assert dispatch.select_step_engine(backend="cuda", **mixed).engine == "unfused"
    assert dispatch.select_step_engine(
        backend="cuda", gather="event", **mixed).engine == "unfused"
