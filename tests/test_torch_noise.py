"""The port's k=1 ``Simulator`` with the reference's own noise injected, and
teacher-forced from a mid-run reference carry, on the CPU; the port's own
noise and engines held against each other; and the port's own noise held
against ``jax.random``.

The port's noise has the reference's key ``fold_in(PRNGKey(seed), t)`` and
equals its bits and uniforms bit for bit, but its normals differ from
``jax.random.normal``'s in the last bits (the normal transform's log1p), so
the raster tests compute the reference's per-step noise
``sigma * normal(fold_in(PRNGKey(seed), t), (n,))`` with JAX and hand it to
the port through ``Simulator``'s ``_noise_fn`` seam.
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
from repro_torch.kernels import ref
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


# -- the port's own noise against jax.random ------------------------------

KEYS = [(42, 0), (42, 1), (7, 12345), (0, 2**31 + 5)]


def _jax_key(seed, t):
    return jax.random.fold_in(jax.random.PRNGKey(seed), t)


@pytest.mark.parametrize("seed,t", KEYS)
def test_port_noise_bits_and_uniforms_equal_jax(seed, t):
    n = 70_000
    key = _jax_key(seed, t)
    bits = ref.noise_bits_ref(seed, t, n)
    want = np.asarray(jax.random.bits(key, (n,), jnp.uint32)).astype(np.int64)
    np.testing.assert_array_equal(bits.numpy(), want)
    u = ref.noise_uniform_ref(bits)
    ju = np.asarray(jax.random.uniform(key, (n,), jnp.float32, minval=ref._U_LO, maxval=1.0))
    np.testing.assert_array_equal(u.numpy().view(np.int32), ju.view(np.int32))


# The normals: the port's log1p (Cephes' logf with Kahan's correction) and
# XLA's own log1p and contracted multiply-adds round differently.  Measured
# over these 4 x 262,144 = 1,048,576 draws with jax 0.9.0 on the CPU: at most
# 4.8e-7 apart (one ulp at |z| in [2, 4)), 4.9% of the values not bit-equal.
NORMAL_ATOL = 1e-6


def test_port_noise_normals_within_tolerance_of_jax():
    n = 262_144
    worst, branches = 0.0, np.zeros(2, np.int64)
    for seed, t in KEYS:
        bits = ref.noise_bits_ref(seed, t, n)
        z = ref.noise_normal_ref(bits).numpy()
        want = np.asarray(jax.random.normal(_jax_key(seed, t), (n,), jnp.float32))
        worst = max(worst, float(np.abs(z - want).max()))
        # erfinv's two branches: w = -log1p(-u^2) below 5 and at or above it
        u = ref.noise_uniform_ref(bits).double().numpy()
        tail = -np.log1p(-u * u) >= 5.0
        branches += (int((~tail).sum()), int(tail.sum()))
    assert worst <= NORMAL_ATOL, worst
    assert branches.min() > 1000, branches


def test_port_noise_is_the_step_noise_op_and_scales_by_sigma():
    """``ops.step_noise`` is sigma times jax's normal of the step key, and
    the seam (``make_noise``) hands a given vector, numpy or torch, to the
    engines as an f32 tensor on their device."""
    from repro_torch.kernels import ops
    from repro_torch.snn.simulator import make_noise

    n, sigma = 1000, 0.8
    seam = make_noise(lambda t: ops.step_noise(SEED, t, n, sigma, device="cpu"), "cpu")
    for t in (0, 5, 2**32 + 5):  # the step enters mod 2^32
        got = ops.step_noise(SEED, t, n, sigma, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (n,)
        assert torch.equal(got, ref.step_noise_ref(SEED, t, n, sigma))
        assert torch.equal(seam(t), got)
        want = sigma * np.asarray(jax.random.normal(_jax_key(SEED, t % 2**32), (n,),
                                                     jnp.float32))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=sigma * NORMAL_ATOL)
        from_numpy = make_noise(lambda t: want.astype(np.float64), "cpu")(t)
        assert from_numpy.dtype == torch.float32
        assert torch.equal(from_numpy, torch.from_numpy(want.astype(np.float32)))


def test_noise_free_net_draws_no_noise(nets, monkeypatch):
    """``noise_sigma <= 0``: no step reaches ``step_noise_add``."""
    import copy

    from repro_torch.kernels import ops

    _, td = nets
    quiet = copy.copy(td)
    quiet.meta = dict(td.meta, noise_sigma=0.0)
    calls = []
    monkeypatch.setattr(ops, "step_noise_add", lambda *a, **k: calls.append(a))
    for fused in (False, True):
        sim = Simulator(quiet, SimConfig(align_k=32, fused=fused), device="cpu")
        sim.run(sim.init_state(), 5)
    assert calls == []


# -- step_noise_add: a partition's ids drawn and added in one pass -----------

def _noise_add_inputs(seed, n=5000):
    rng = np.random.default_rng(seed)
    ids = rng.permutation(n).astype(np.int64)
    x = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    vtx = rng.normal(0.0, 1.0, (n, 4)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(ids), torch.from_numpy(vtx)


@pytest.mark.parametrize("with_bias", [False, True])
def test_step_noise_add_is_the_full_vector_at_the_ids(with_bias):
    """At a permuted id set the plain version is ``step_noise_ref(...)[ids] +
    x (+ bias)`` bit for bit, the bias a strided column."""
    from repro_torch.kernels import ops

    x, ids, vtx = _noise_add_inputs(1)
    bias = vtx[:, 2] if with_bias else None
    for seed, t in KEYS:
        got = ops.step_noise_add(x, ids, seed, t, 0.8, bias)
        want = x + ref.step_noise_ref(seed, t, len(ids), 0.8)[ids]
        if with_bias:
            want = want + bias
        assert got.dtype == torch.float32 and got.shape == x.shape
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("seed,t", KEYS)
def test_step_noise_add_within_tolerance_of_jax(seed, t):
    """Against the reference's own draw, taken at the ids and added: the
    normals' difference (NORMAL_ATOL, scaled by sigma) plus the roundings of
    the product and the sum, which stay under 1e-6 for |x + noise| < 8."""
    from repro_torch.kernels import ops

    x, ids, _ = _noise_add_inputs(2, n=50_000)
    sigma = 0.8
    got = ops.step_noise_add(x, ids, seed, t, sigma).numpy()
    z = np.asarray(jax.random.normal(_jax_key(seed, t), (len(ids),), jnp.float32))
    want = z[ids.numpy()] * np.float32(sigma) + x.numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _session_raster(d, steps, **kw):
    from repro_torch.snn import RasterMonitor, Session

    ses = Session(d, SimConfig(align_k=32, **kw.pop("cfg", {})), **kw)
    mon = RasterMonitor()
    ses.run(steps, monitors=[mon])
    return mon.raster


@pytest.mark.parametrize("fused", [False, True])
def test_own_noise_k1_and_k4_sessions_identical(fused):
    """With the port's own noise each partition draws its own ids: the k=4
    Session (four partitions on the CPU) equals the k=1 Session of the merged
    net, raster for raster."""
    from repro_torch.core import block_partition, merge_to_single

    net = tnet.microcircuit(scale=0.01)
    d4 = tnet.to_dcsr(net, assignment=block_partition(net.n, 4), uniform=True)
    r4 = _session_raster(d4, 60, cfg=dict(fused=fused), engine="spmd", devices=["cpu"] * 4)
    r1 = _session_raster(merge_to_single(d4), 60, cfg=dict(fused=fused), device="cpu")
    assert r1.sum() > 0
    np.testing.assert_array_equal(r4, r1)


@pytest.mark.parametrize("fused", [False, True])
def test_noise_seam_keeps_the_full_vector_path(nets, fused, monkeypatch):
    """The ``_noise_fn`` seam adds a full vector through ``index_select`` and
    never reaches ``step_noise_add``; fed the port's own full vector it gives
    the own-noise run's raster and state bit for bit, while the own-noise
    run draws once a step through ``step_noise_add``."""
    from repro_torch.kernels import ops

    _, td = nets
    sigma, n, steps = float(td.meta["noise_sigma"]), td.n, 40
    calls = []
    real = ops.step_noise_add

    def spy(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)

    monkeypatch.setattr(ops, "step_noise_add", spy)
    cfg = SimConfig(align_k=32, record_raster=True, fused=fused)
    seam = Simulator(td, cfg, device="cpu",
                     _noise_fn=lambda t: ops.step_noise(SEED, t, n, sigma, device="cpu"))
    st_s, out_s = seam.run(seam.init_state(), steps)
    assert calls == []
    own = Simulator(td, cfg, device="cpu")
    st_o, out_o = own.run(own.init_state(), steps)
    assert calls == list(range(steps))
    assert out_o["spike_count"].sum() > 0
    assert torch.equal(out_s["raster"], out_o["raster"])
    for key in ("vtx_state", "ring", "hist"):
        assert torch.equal(st_s[key], st_o[key]), key
