"""bf16 weights through the port's gather ops on the CPU, against the
reference's bf16 sweeps (``tests/test_kernels.py:22-48``,
``tests/test_fused_step.py:36-55``) and, for the post-exchange gathers,
against the reference's kernels, which widen a bf16 panel the same way
(``repro/kernels/event_step.py:154``, ``fused_step.py:528``).

The same numpy inputs, cast to bf16, go through the reference's Pallas
kernels in interpret mode (``spike_gather_pallas``,
``fused_lif_step_pallas``), its oracles (``repro.kernels.ref``) and the
port's ``ops.spike_gather`` and ``ops.fused_step`` on CPU tensors (the plain
versions, which widen with ``.float()``).  The widening is exact and every
sum runs in f32, so only the order of the f32 sums differs: the f32
tolerances hold (1e-6 for the gather, 1e-5 for the fused step, as the
reference's f32 cases).

STDP on bf16 weights: ``ops.stdp_update`` gives ``stdp_update_pallas``'s
bf16 result bit for bit (every operation rounded to bf16), which is not its
oracle's f32 one (F17, reference side).  The reference's three fused
plastic kernels raise on bf16 weights; the port's plain versions of them
give its oracles' f32 weights.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import event_step as jev
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fused_step import fused_lif_step_pallas
from repro.kernels.spike_gather import spike_gather_pallas
from repro.kernels.stdp_update import stdp_update_pallas
from repro_torch.kernels import dispatch, ops, ref
from repro_torch.kernels import event_step as tev
from repro_torch.kernels.segment_gather import segment_plan

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
    plan = segment_plan([row_ptr.numpy()], [K], 4, "cpu")

    def sums(w):
        ring = torch.zeros((1, 4))
        return ops.segment_gather_ring(act, ring, 0, [0], plan, [cols], [w], row_ptr=[row_ptr])[0]

    got = sums(w16)
    assert got.dtype == torch.float32 and got.shape == (4,)
    assert torch.equal(got, sums(w16.float()))
    assert torch.equal(got, ref.segment_add_ref(ref.spike_gather_ref(act, cols, w16), row_ptr))


def test_panel_reduce_reads_bf16_panels():
    ok = torch.ones((4, 8), dtype=torch.bfloat16)
    bad = ok.clone()
    bad[1, 2] = float("nan")
    assert dispatch.panel_reduce([ok, bad]) == ("active", "row_dot")
    assert dispatch.panel_reduce([ok], plastic=True) == ("row_dot",)


def _post_panels(rng, n_p, n, R, ks, fill=0.4):
    """ELL-layout panels (padding: col 0, weight 0) with bf16 weights."""
    cols, valid, w_t, w_j = [], [], [], []
    for K in ks:
        v = rng.random((R, K)) < fill
        v[n_p:] = False
        cols.append(np.where(v, rng.integers(0, n, (R, K)), 0).astype(np.int32))
        valid.append(v)
        t, j = _bf16(np.where(v, rng.normal(size=(R, K)), 0.0))
        w_t.append(t)
        w_j.append(j)
    return cols, valid, w_t, w_j


@pytest.mark.parametrize("n_p,R,ks,block_r,p_active", [
    (64, 64, (16,), 16, 0.05), (100, 104, (8, 24), 8, 0.1), (250, 256, (4, 12, 20), 32, 0.02),
])
def test_event_post_exchange_bf16_matches_the_reference(rng, n_p, R, ks, block_r, p_active):
    D, t, cap = 16, 21, 32
    cols, valid, w_t, w_j = _post_panels(rng, n_p, n_p, R, ks)
    delays = [2 + 3 * i for i in range(len(ks))]
    nb = R // block_r
    masks = jev.build_touch_masks(cols, valid, n_p, nb, block_r)
    act = (rng.random(n_p) < p_active).astype(np.float32)
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    write = [(t + d) % D for d in delays]
    plan = tev.EventPlan(block_r, nb, cap, torch.from_numpy(np.stack(masks)))
    tcols = [torch.from_numpy(c) for c in cols]
    got = torch.from_numpy(ring.copy())
    flags = ops.event_post_exchange(torch.from_numpy(act), got, t % D, write, plan, tcols, w_t)
    # the exact widening: the f32 panels of the same values give the same bits
    wide = torch.from_numpy(ring.copy())
    ops.event_post_exchange(torch.from_numpy(act), wide, t % D, write, plan, tcols,
                            [w.float() for w in w_t])
    assert got.dtype == torch.float32 and torch.equal(got, wide)
    sel, jflags = jax.jit(jev.event_select, static_argnums=2)(
        jnp.asarray(act), [jnp.asarray(m) for m in masks], cap)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(jflags))
    clear = (np.arange(D) != t % D).astype(np.float32)
    onehot = (np.asarray(write)[:, None] == np.arange(D)[None, :]).astype(np.float32)
    for backend in ("ref", "pallas_interpret"):
        want = jax.jit(jops.event_post_exchange, static_argnames="backend")(
            jnp.asarray(act), jnp.asarray(ring), jnp.asarray(clear), jnp.asarray(onehot), sel,
            jflags, [jnp.asarray(c) for c in cols], w_j, backend=backend)
        # f32 sums in another order: rtol=atol=1e-5, as the f32 case
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("variant", ["full", "local", "remote"])
def test_post_exchange_bf16_matches_the_reference(rng, variant):
    n_p, D, R = 16, 5, 16
    n = n_p if variant == "local" else 4 * n_p
    cols, _, w_t, w_j = _post_panels(rng, n_p, n, R, (8, 16, 24))
    act = (rng.random(n) < 0.3).astype(np.float32)
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    slot, delays = 2, np.asarray([1, 3, 5])
    clear = (np.arange(D) != slot).astype(np.float32)
    onehot = (((slot + delays) % D)[:, None] == np.arange(D)[None, :]).astype(np.float32)
    tc, jc = [torch.from_numpy(c) for c in cols], [jnp.asarray(c) for c in cols]
    ta, tr = torch.from_numpy(act), torch.from_numpy(ring)
    ja, jr, jcl, joh = (jnp.asarray(a) for a in (act, ring, clear, onehot))
    if variant == "remote":
        def run(w):
            return ops.fused_post_exchange_remote(ta, tr, torch.from_numpy(onehot), tc, w)
        jop = jax.jit(jops.fused_post_exchange_remote, static_argnames="backend")
        want = [jref.fused_post_exchange_remote_ref(ja, jr, joh, jc, w_j),
                jop(ja, jr, joh, jc, w_j, backend="pallas_interpret")]
    else:
        op = ops.fused_post_exchange_local if variant == "local" else ops.fused_post_exchange
        jop = jax.jit(jops.fused_post_exchange_local if variant == "local"
                      else jops.fused_post_exchange, static_argnames="backend")

        def run(w):
            return op(ta, tr, torch.from_numpy(clear), torch.from_numpy(onehot), tc, w)
        want = [jref.fused_post_exchange_ref(ja, jr, jcl, joh, jc, w_j),
                jop(ja, jr, jcl, joh, jc, w_j, backend="pallas_interpret")]
    got = run(w_t)
    assert got.dtype == torch.float32 and torch.equal(got, run([w.float() for w in w_t]))
    for w in want:
        # f32 sums in another order: rtol=atol=1e-5, as the f32 case
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


# -- STDP on bf16 weights -------------------------------------------------

# scalars off the bf16 grid, so their rounding shows
STDP_BF = dict(a_plus=0.01, a_minus=0.012, w_min=-1.9, w_max=2.1)
LIF_TAUS = (20.0, 15.0)


def _bits_equal(got, want):
    """bf16 ``got`` (torch) and ``want`` (the reference's array) bit for
    bit, NaNs (whose payloads the two libraries round apart) in the same
    slots."""
    want = np.asarray(want)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    g = got.view(torch.int16).numpy()
    w = want.view(np.int16)
    g_nan, w_nan = torch.isnan(got).numpy(), np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(g_nan, w_nan)
    np.testing.assert_array_equal(g[~g_nan], w[~w_nan])


def _stdp_bf16_case(rng, R, K, n, mask_bf16):
    """A panel with weights at both clip edges (and past them), one NaN in
    a plastic slot, and the spikes and traces that push the edges out."""
    w = rng.normal(size=(R, K)).astype(np.float32)
    valid = (rng.random((R, K)) < 0.6).astype(np.float32)
    lo, hi = (float(torch.tensor(STDP_BF[k], dtype=torch.bfloat16)) for k in ("w_min", "w_max"))
    edge = rng.random((R, K))
    w[edge < 0.05] = lo
    w[(edge >= 0.05) & (edge < 0.1)] = hi
    w[(edge >= 0.1) & (edge < 0.12)] = hi + 0.5
    valid[0, 0] = 1.0
    w[0, 0] = np.nan
    cols = rng.integers(0, n, (R, K)).astype(np.int32)
    pre_t = rng.random(n).astype(np.float32)
    pre_s = (rng.random(n) < 0.3).astype(np.float32)
    post_t = rng.random(R).astype(np.float32)
    post_s = (rng.random(R) < 0.3).astype(np.float32)
    w_t, w_j = _bf16(w)
    m_t = torch.from_numpy(valid)
    m_j = jnp.asarray(valid)
    if mask_bf16:
        m_t, m_j = m_t.to(torch.bfloat16), m_j.astype(jnp.bfloat16)
    vecs = (pre_t, pre_s, post_t, post_s)
    return ((w_t, m_t, torch.from_numpy(cols), *map(torch.from_numpy, vecs)),
            (w_j, m_j, jnp.asarray(cols), *map(jnp.asarray, vecs)))


@pytest.mark.parametrize("mask_bf16", [True, False], ids=["bf16_mask", "f32_mask"])
@pytest.mark.parametrize("R,K,n", [(8, 128, 64), (40, 256, 300), (104, 384, 1000)])
def test_stdp_update_bf16_is_the_reference_kernel_bit_for_bit(rng, R, K, n, mask_bf16):
    """bf16 weights through ``ops.stdp_update`` (the plain version on the
    CPU) give ``stdp_update_pallas``'s bf16 result bit for bit: every
    operand and every operation rounded to bf16.  In place too."""
    targs, jargs = _stdp_bf16_case(rng, R, K, n, mask_bf16)
    want = stdp_update_pallas(*jargs, **STDP_BF, interpret=True)
    got = ops.stdp_update(*targs, params=STDP_BF)
    _bits_equal(got, want)
    w, valid = targs[0], targs[1]
    frozen = (valid == 0).numpy()
    np.testing.assert_array_equal(got.view(torch.int16).numpy()[frozen],
                                  w.view(torch.int16).numpy()[frozen])
    assert bool(torch.isnan(got[0, 0]))
    lo, hi = (float(torch.tensor(STDP_BF[k], dtype=torch.bfloat16)) for k in ("w_min", "w_max"))
    live = got.float()[(~frozen) & ~torch.isnan(got).numpy()]
    assert float(live.min()) >= lo and float(live.max()) <= hi
    assert (live == hi).any() and (live == lo).any()
    inplace = w.clone()
    assert ops.stdp_update(inplace, *targs[1:], params=STDP_BF, out=inplace) is inplace
    _bits_equal(inplace, want)


def test_stdp_update_reference_oracle_is_f32_on_bf16(rng):
    """F17 (reference side): on bf16 weights the reference's oracle
    (``backend="ref"``) returns f32, computed in f32 from the bf16
    weights, where its kernel returns bf16 rounded at every operation;
    rounded to bf16 the two still differ in some slots."""
    targs, jargs = _stdp_bf16_case(rng, 104, 384, 1000, True)
    oracle = jops.stdp_update(*jargs, params=STDP_BF, backend="ref")
    kernel = stdp_update_pallas(*jargs, **STDP_BF, interpret=True)
    assert oracle.dtype == jnp.float32 and kernel.dtype == jnp.bfloat16
    o16 = np.asarray(oracle.astype(jnp.bfloat16), np.float32)
    k = np.asarray(kernel, np.float32)
    assert (o16[~np.isnan(k)] != k[~np.isnan(k)]).any()
    assert ops.stdp_update(*targs, params=STDP_BF).dtype == torch.bfloat16


def _plastic_bf16_case(rng, n_p, n, R, ks, D=8):
    """The plastic fused ops' operands with bf16 weights: the port's CPU
    tensors and the reference's arrays."""
    cols = [rng.integers(0, n, (R, K)).astype(np.int32) for K in ks]
    w = [rng.normal(size=(R, K)).astype(np.float32) for K in ks]
    pm = [(rng.random((R, K)) < 0.5).astype(np.float32) for K in ks]
    for a in w + pm:
        a[n_p:] = 0
    vec = dict(
        v=(-65.0 + 20.0 * rng.random(n_p)).astype(np.float32),
        refrac=rng.integers(0, 3, n_p).astype(np.float32),
        i_tot=(18.0 * rng.random(n_p)).astype(np.float32),
        tr_plus=rng.random(n_p).astype(np.float32), tr_minus=rng.random(n_p).astype(np.float32),
        act=(rng.random(n) < 0.3).astype(np.float32), pre=rng.random(n).astype(np.float32),
        post_t=rng.random(n_p).astype(np.float32),
        post_s=(rng.random(n_p) < 0.3).astype(np.float32),
        ring=rng.normal(size=(D, n_p)).astype(np.float32),
        clear=(np.arange(D) != 3).astype(np.float32),
        onehot=(((3 + 1 + np.arange(len(ks))) % D)[:, None] == np.arange(D)).astype(np.float32),
    )
    act_r = vec["act"].copy()
    act_r[:n_p] = 0.0
    vec["act_remote"] = act_r
    w16 = [_bf16(a) for a in w]
    t = dict({k: torch.from_numpy(a) for k, a in vec.items()},
             cols=[torch.from_numpy(c) for c in cols], w=[x[0] for x in w16],
             pm=[torch.from_numpy(a) for a in pm])
    j = dict({k: jnp.asarray(a) for k, a in vec.items()},
             cols=[jnp.asarray(c) for c in cols], w=[x[1] for x in w16],
             pm=[jnp.asarray(a) for a in pm])
    return t, j


def _plastic_call(which, mod, d, **kw):
    """One of the three plastic fused ops of ``mod`` (the port's ``ops`` or
    the reference's) on the operands ``d``."""
    if which == "fused_step_plastic":
        return mod.fused_step_plastic(d["v"], d["refrac"], d["i_tot"], d["tr_plus"],
                                      d["tr_minus"], d["cols"], d["w"], d["pm"],
                                      params=LIF_PARAMS, taus=LIF_TAUS, stdp=STDP_BF, **kw)
    if which == "fused_post_exchange_plastic":
        return mod.fused_post_exchange_plastic(d["act"], d["pre"], d["ring"], d["clear"],
                                               d["onehot"], d["post_t"], d["post_s"], d["cols"],
                                               d["w"], d["pm"], stdp=STDP_BF, **kw)
    return mod.fused_post_exchange_remote_plastic(d["act_remote"], d["act"], d["pre"], d["ring"],
                                                  d["onehot"], d["post_t"], d["post_s"],
                                                  d["cols"], d["w"], d["pm"], stdp=STDP_BF, **kw)


PLASTIC_FUSED = ["fused_step_plastic", "fused_post_exchange_plastic",
                 "fused_post_exchange_remote_plastic"]


@pytest.mark.parametrize("which", PLASTIC_FUSED)
def test_reference_plastic_kernels_refuse_bf16_weights(rng, which):
    """The reference's three fused plastic Pallas kernels raise on bf16
    weights (their f32 update does not store into a bf16 panel), which is
    why the port's kernels take f32 only."""
    n = 32 if which == "fused_step_plastic" else 64
    _, j = _plastic_bf16_case(rng, 32, n, 32, (8, 16))
    with pytest.raises(ValueError, match="Invalid dtype for `swap`. Ref dtype: bfloat16"):
        _plastic_call(which, jops, j, backend="pallas_interpret")


@pytest.mark.parametrize("which", PLASTIC_FUSED)
def test_plastic_fused_plain_versions_are_the_reference_oracles_on_bf16(rng, which):
    """On the CPU the port's plain versions of the three ops take bf16
    weights as the reference's oracles do: f32 new weights (equal to the
    oracle's), f32 state and ring."""
    n = 32 if which == "fused_step_plastic" else 64
    t, j = _plastic_bf16_case(rng, 32, n, 40, (8, 16))
    got = _plastic_call(which, ops, t)
    with jax.disable_jit():
        want = _plastic_call(which, jops, j, backend="ref")
    new_w, want_w = got[-1], want[-1]
    for a, b in zip(new_w, want_w):
        assert a.dtype == torch.float32 and b.dtype == jnp.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if which == "fused_step_plastic":
        for a, b in zip(got[:5], want[:5]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        pairs = list(zip(got[5], want[5]))
    else:
        pairs = [(got[0], want[0])]
    for a, b in pairs:
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
