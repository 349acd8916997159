"""Row lengths of the ELL panels, on the CPU.

The gathers on the card (``spike_gather``, ``event_post_exchange``) read
only the first ``row_len[r]`` slots of a row.  That is exact only while the
panels keep the layout the ELL builder gives them: a row's synapses at
``0..row_len-1`` and ``(col 0, weight 0)`` after them.  These tests hold
that invariant on the nets the port builds (k=1 and the k>1 stacked panels,
legacy and rule-built, plastic ones after learning too), check that every
gather call of the engines passes the lengths, and hold the ops with
``row_len`` against the JAX package's oracles on the same seeded numpy
inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import event_step as jev
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.snn import SimConfig as JSimConfig
from repro.snn import dist_sim as jdist
from repro.snn import network as jnet
from repro_torch.builder import balanced_ei_rules, microcircuit_rules
from repro_torch.core import block_partition
from repro_torch.kernels import event_step as tev
from repro_torch.kernels import ops
from repro_torch.kernels.dispatch import panel_reduce
from repro_torch.snn import Session, SimConfig, balanced_ei, microcircuit, to_dcsr


def _check_layout(row_len, cols, weights, valid):
    """``row_len == valid.sum(1)``; the slots below it valid; the slots at
    or past it ``(col 0, weight 0)``."""
    rl = np.asarray(row_len)
    assert rl.dtype == np.int32
    np.testing.assert_array_equal(rl, valid.sum(axis=1))
    below = np.arange(valid.shape[1])[None, :] < rl[:, None]
    np.testing.assert_array_equal(valid, below)
    assert not np.asarray(cols)[~below].any()
    assert not np.asarray(weights)[~below].any()


NETS = {
    "microcircuit": lambda: microcircuit(scale=0.01, seed=0),
    "balanced_ei": lambda: balanced_ei(n=400, stdp=True, seed=0),
    "microcircuit_rules": lambda: microcircuit_rules(scale=0.01, seed=0),
    "balanced_ei_rules": lambda: balanced_ei_rules(n=300, stdp=True, seed=0),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_k1_panels_keep_real_slots_first(name):
    spec = NETS[name]()
    ses = Session(spec if name.endswith("_rules") else to_dcsr(spec, k=1), SimConfig(),
                  device="cpu")
    sim = ses.simulator
    dev = sim.dev
    assert len(dev.row_len) == len(dev.cols) == len(sim.ell.buckets)
    for rl, c, w, b in zip(dev.row_len, dev.cols, dev.weights0, sim.ell.buckets):
        assert rl.device == c.device and rl.shape == (c.shape[0],)
        _check_layout(rl.numpy(), c.numpy(), w.numpy(), b.valid)


@pytest.mark.parametrize("name", sorted(NETS))
def test_k4_stacked_panels_keep_real_slots_first(name):
    spec = NETS[name]()
    if name.endswith("_rules"):
        ses = Session(spec, SimConfig(), k=4, engine="spmd", devices=["cpu"] * 4)
    else:
        d = to_dcsr(spec, assignment=block_partition(spec.n, 4), uniform=True)
        ses = Session(d, SimConfig(), engine="spmd", devices=["cpu"] * 4)
    dsim = ses.simulator
    s = dsim.stacked
    for p, dev in enumerate(dsim.devs):
        for i, (rl, c, w) in enumerate(zip(dev.row_len, dev.cols, dev.weights0)):
            _check_layout(rl.numpy(), c.numpy(), w.numpy(), s.valid[i][p])


@pytest.mark.parametrize("fused", [None, False])
def test_padding_stays_zero_after_learning(fused):
    ses = Session(to_dcsr(balanced_ei(n=400, stdp=True, seed=0), k=1),
                  SimConfig(fused=fused), device="cpu")
    dev = ses.simulator.dev
    ses.run(60)
    learned = ses.state["weights"]
    assert any(not torch.equal(a, b) for a, b in zip(learned, dev.weights0))
    for rl, c, w, b in zip(dev.row_len, dev.cols, learned, ses.simulator.ell.buckets):
        _check_layout(rl.numpy(), c.numpy(), w.numpy(), b.valid)


def _record_gathers(monkeypatch, names=("spike_gather", "event_post_exchange")):
    """Wrap the ops' registry lookup: every call of the ``names`` ops, as
    ``(name, row_len, reduce)`` in call order (``row_len`` is the last
    positional argument of each, ``reduce`` a keyword)."""
    seen = []
    real = ops.lookup

    def lookup(name, backend):
        fn = real(name, backend)
        if name not in names:
            return fn

        def record(*args, **kwargs):
            seen.append((name, args[-1], kwargs.get("reduce")))
            return fn(*args, **kwargs)

        return record

    monkeypatch.setattr(ops, "lookup", lookup)
    return seen


@pytest.mark.parametrize("k,cfg", [
    (1, dict(fused=False)),
    (1, dict(fused=True, gather="event")),
    (4, dict(fused=False)),
    (4, dict(fused=True, gather="event")),  # overlap local: the remote event pass
    (4, dict(fused=True, gather="event", overlap="off")),
    (4, dict(fused=True, gather="event", overlap="double_buffer")),
])
def test_every_gather_call_passes_the_row_lengths(monkeypatch, k, cfg):
    net = microcircuit(scale=0.01, seed=0)
    if k == 1:
        ses = Session(to_dcsr(net, k=1), SimConfig(**cfg), device="cpu")
        devs = [ses.simulator.dev]
    else:
        d = to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)
        ses = Session(d, SimConfig(**cfg), engine="spmd", devices=["cpu"] * k)
        devs = ses.simulator.devs
    seen = _record_gathers(monkeypatch)
    ses.run(12)
    kinds = {name for name, _, _ in seen}
    assert kinds == {"spike_gather" if cfg.get("fused") is False else "event_post_exchange"}
    lengths = [id(rl) for dev in devs for rl in dev.row_len]
    for name, row_len, reduce in seen:
        if name == "spike_gather":
            assert id(row_len) in lengths
            assert reduce == ("active",)  # the microcircuit's weights are finite
        else:
            assert any(len(row_len) == len(dev.row_len)
                       and all(a is b for a, b in zip(row_len, dev.row_len)) for dev in devs)
            assert any(reduce is dev.reduce for dev in devs)


DENSE_GATHERS = {  # op -> the PartitionDeviceData fields it must be given
    "fused_step": ("row_len", "reduce"),
    "fused_post_exchange": ("row_len", "reduce"),
    "fused_post_exchange_local": ("row_len_local", "reduce_local"),
    "fused_post_exchange_remote": ("row_len_remote", "reduce_remote"),
}


@pytest.mark.parametrize("k,cfg,called", [
    (1, dict(fused=True, gather="dense"), {"fused_step"}),
    (4, dict(fused=True, gather="dense", overlap="off"), {"fused_post_exchange"}),
    (4, dict(fused=True, gather="dense", overlap="local"),
     {"fused_post_exchange_local", "fused_post_exchange_remote"}),
])
def test_every_dense_gather_call_passes_row_lengths_and_reduce(monkeypatch, k, cfg, called):
    """The dense engines hand ``fused_step`` and each ``post_exchange``
    pass the row lengths and the recorded reduction of the panels they
    gather."""
    net = microcircuit(scale=0.01, seed=0)
    if k == 1:
        ses = Session(to_dcsr(net, k=1), SimConfig(**cfg), device="cpu")
        devs = [ses.simulator.dev]
    else:
        d = to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)
        ses = Session(d, SimConfig(**cfg), engine="spmd", devices=["cpu"] * k)
        devs = ses.simulator.devs
    seen = _record_gathers(monkeypatch, tuple(DENSE_GATHERS))
    ses.run(12)
    assert {name for name, _, _ in seen} == called
    for name, row_len, reduce in seen:
        lengths, chosen = DENSE_GATHERS[name]
        assert any(len(row_len) == len(getattr(dev, lengths))
                   and all(a is b for a, b in zip(row_len, getattr(dev, lengths)))
                   and reduce is getattr(dev, chosen) for dev in devs)


def _ell_panels(rng, n, R, ks):
    """ELL panels as the builder lays them out: row r holds row_len[r]
    synapses first (negative weights among them), ``(col 0, weight 0)``
    after; lengths 0, 1, 31, 32, 33 and K among the rows."""
    cols, weights, valid, lens = [], [], [], []
    for K in ks:
        rl = rng.integers(0, K + 1, R)
        rl[: 6] = [0, 1, min(31, K), min(32, K), min(33, K), K]
        below = np.arange(K)[None, :] < rl[:, None]
        cols.append(np.where(below, rng.integers(0, n, (R, K)), 0).astype(np.int32))
        weights.append(np.where(below, rng.normal(size=(R, K)), 0.0).astype(np.float32))
        valid.append(below)
        lens.append(rl.astype(np.int32))
    return cols, weights, valid, lens


def _activities(rng, n):
    binary = (rng.random(n) < 0.05).astype(np.float32)
    mixed = binary * 0.5
    mixed[::7] = -0.0
    return {"zero": np.zeros(n, np.float32), "one spike": np.eye(1, n, n // 3, np.float32)[0],
            "5%": binary, "all": np.ones(n, np.float32), "non-binary": mixed}


@pytest.mark.parametrize("n,R,K", [(64, 16, 8), (300, 40, 129), (1000, 128, 300)])
def test_spike_gather_with_row_len_matches_jax_oracle(rng, n, R, K):
    (c,), (w,), _, (rl,) = _ell_panels(rng, n, R, (K,))
    for what, act in _activities(rng, n).items():
        got = ops.spike_gather(torch.from_numpy(act), torch.from_numpy(c),
                               torch.from_numpy(w), torch.from_numpy(rl))
        assert torch.equal(got, ops.spike_gather(torch.from_numpy(act), torch.from_numpy(c),
                                                 torch.from_numpy(w)))
        want = jref.spike_gather_ref(jnp.asarray(act), jnp.asarray(c), jnp.asarray(w))
        # f32 sums in another order: rtol=atol=1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("n_p,R,ks,block_r", [
    (64, 64, (16,), 16), (100, 104, (8, 40), 8), (250, 256, (4, 33, 130), 32),
])
def test_event_post_exchange_with_row_len_matches_jax_ref_path(rng, n_p, R, ks, block_r):
    D, t, cap = 16, 21, 32
    cols, weights, valid, lens = _ell_panels(rng, n_p, R, ks)
    delays = [2 + 3 * i for i in range(len(ks))]
    nb = R // block_r
    masks = jev.build_touch_masks(cols, valid, n_p, nb, block_r)
    plan = tev.EventPlan(block_r, nb, cap, torch.from_numpy(np.stack(masks)))
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    slot = t % D
    write = [(t + d) % D for d in delays]
    clear = (np.arange(D) != slot).astype(np.float32)
    onehot = (np.asarray(write)[:, None] == np.arange(D)[None, :]).astype(np.float32)
    for what, act in _activities(rng, n_p).items():
        got = torch.from_numpy(ring.copy())
        flags = ops.event_post_exchange(
            torch.from_numpy(act), got, slot, write, plan,
            [torch.from_numpy(c) for c in cols], [torch.from_numpy(w) for w in weights],
            [torch.from_numpy(x) for x in lens],
        )
        sel, want_flags = jev.event_select(jnp.asarray(act), [jnp.asarray(m) for m in masks],
                                           cap)
        np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags), err_msg=what)
        want = jops.event_post_exchange(
            jnp.asarray(act), jnp.asarray(ring), jnp.asarray(clear), jnp.asarray(onehot),
            sel, want_flags, [jnp.asarray(c) for c in cols],
            [jnp.asarray(w) for w in weights], backend="ref",
        )
        # f32 sums in another order: rtol=atol=1e-5
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5,
                                   err_msg=what)


@pytest.mark.parametrize("k", [2, 4])
def test_overlap_sub_panel_row_lengths_match_reference_masks(k):
    """``row_len_local`` and ``row_len_remote`` are the per-row counts of
    the reference's ownership masks (``repro/snn/dist_sim.py:
    split_overlap_panels``), and the sub-panels keep their real slots
    first."""
    net_j = jnet.microcircuit(scale=0.01, seed=0)
    jd = jnet.to_dcsr(net_j, assignment=block_partition(net_j.n, k), uniform=True)
    want = jdist.stack_partitions(jd, JSimConfig(align_k=32))
    net_t = microcircuit(scale=0.01, seed=0)
    td = to_dcsr(net_t, assignment=block_partition(net_t.n, k), uniform=True)
    ses = Session(td, SimConfig(align_k=32, fused=True, overlap="local"), engine="spmd",
                  devices=["cpu"] * k)
    own_lo = (np.arange(k) * want.n_p)[:, None, None]
    for i in range(len(want.delays)):
        c = np.asarray(want.cols[i])
        v = np.asarray(want.valid[i]) > 0
        is_local = v & (c >= own_lo) & (c < own_lo + want.n_p)
        for p, dev in enumerate(ses.simulator.devs):
            for rl, cs, ws, mask in (
                (dev.row_len_local[i], dev.cols_local[i], dev.weights_local[i], is_local),
                (dev.row_len_remote[i], dev.cols_remote[i], dev.weights_remote[i],
                 v & ~is_local),
            ):
                counts = mask[p].sum(axis=1)
                np.testing.assert_array_equal(rl.numpy(), counts)
                below = np.arange(cs.shape[1])[None, :] < counts[:, None]
                _check_layout(rl.numpy(), cs.numpy(), ws.numpy(), below)
    desc = ses.describe()
    nd = len(want.delays)
    assert desc["reduce_local"] == desc["reduce_remote"] == [("active",) * nd] * k


def _nan_case(rng, act, cols, weights, lens, rows):
    """Set one real slot of each row in ``rows`` whose source is silent in
    ``act`` to NaN (a silent source: the gathers on the card never load its
    weight on their active path)."""
    for r in rows:
        silent = [j for j in range(lens[r]) if act[cols[r, j]] == 0]
        assert silent, r
        weights[r, silent[rng.integers(len(silent))]] = np.nan


def test_nan_weight_on_a_silent_source_gives_reference_nan_rows(rng):
    """F3 on the CPU: one NaN weight on a silent source puts NaN in the same
    rows in the port's plain versions as in ``repro.kernels.ref``: the
    gather, the fused step, the three post-exchange passes and the event
    gather (whose NaN row lies in a flagged block: an unflagged block keeps
    its rows in both packages' kernels)."""
    n_p, R, ks, D, t = 200, 200, (33, 70), 16, 21
    delays = (3, 9)
    cols, weights, _, lens = _ell_panels(rng, n_p, R, ks)
    act = (rng.random(n_p) < 0.05).astype(np.float32)
    nan_rows = (7, 120)
    _nan_case(rng, act, cols[1], weights[1], lens[1], nan_rows)
    assert panel_reduce([torch.from_numpy(w) for w in weights]) == ("active", "row_dot")
    t_ = torch.from_numpy(act)
    tc, tw, tl = ([torch.from_numpy(x) for x in xs] for xs in (cols, weights, lens))
    jc, jw = [jnp.asarray(x) for x in cols], [jnp.asarray(x) for x in weights]

    # the gather
    got = ops.spike_gather(t_, tc[1], tw[1], tl[1])
    want = jref.spike_gather_ref(jnp.asarray(act), jc[1], jw[1])
    assert list(np.flatnonzero(np.isnan(got.numpy()))) == list(nan_rows)
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))

    # the three post-exchange passes (the ring rows: columns of (D, n_p))
    ring = rng.normal(size=(D, n_p)).astype(np.float32)
    slot = t % D
    write = [(t + d) % D for d in delays]
    clear = (np.arange(D) != slot).astype(np.float32)
    onehot = (np.asarray(write)[:, None] == np.arange(D)[None, :]).astype(np.float32)
    tr, tclear, tonehot = (torch.from_numpy(x) for x in (ring, clear, onehot))
    jr, jclear, jonehot = (jnp.asarray(x) for x in (ring, clear, onehot))
    for got, want in (
        (ops.fused_post_exchange(t_, tr, tclear, tonehot, tc, tw, tl),
         jref.fused_post_exchange_ref(jnp.asarray(act), jr, jclear, jonehot, jc, jw)),
        (ops.fused_post_exchange_local(t_, tr, tclear, tonehot, tc, tw, tl),
         jref.fused_post_exchange_local_ref(jnp.asarray(act), jr, jclear, jonehot, jc, jw)),
        (ops.fused_post_exchange_remote(t_, tr, tonehot, tc, tw, tl),
         jref.fused_post_exchange_remote_ref(jnp.asarray(act), jr, jonehot, jc, jw)),
    ):
        rows = np.isnan(got.numpy()).any(axis=0)
        assert list(np.flatnonzero(rows)) == list(nan_rows)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))

    # the event gather, every NaN row in a flagged block
    block_r, cap = 8, 64
    nb = R // block_r
    valid = [np.arange(K)[None, :] < rl[:, None] for K, rl in zip(ks, lens)]
    masks = jev.build_touch_masks(cols, valid, n_p, nb, block_r)
    plan = tev.EventPlan(block_r, nb, cap, torch.from_numpy(np.stack(masks)))
    got = tr.clone()
    flags = ops.event_post_exchange(t_, got, slot, write, plan, tc, tw, tl)
    assert all(flags[1, r // block_r] for r in nan_rows)
    sel, jflags = jev.event_select(jnp.asarray(act), [jnp.asarray(m) for m in masks], cap)
    want = jops.event_post_exchange(jnp.asarray(act), jr, jclear, jonehot, sel, jflags, jc, jw,
                                    backend="ref")
    # the rows: the reference's one-hot ring formulation spreads a row's NaN
    # over every slot of the ring (0 * NaN), the event update adds it to the
    # write slot only
    assert list(np.flatnonzero(np.isnan(got.numpy()).any(axis=0))) == list(nan_rows)
    np.testing.assert_array_equal(np.isnan(got.numpy()).any(axis=0),
                                  np.isnan(np.asarray(want)).any(axis=0))


def test_nan_weight_in_the_fused_step_gives_reference_nan_rows(rng):
    """The fused step's gather reads the step's own spikes: the NaN sits on
    a source that does not spike."""
    params = dict(dt=0.1, tau_m=10.0, v_rest=-65.0, v_reset=-65.0, v_thresh=-50.0,
                  t_ref=2.0, r_m=1.0)
    n_p, R, ks = 150, 152, (16, 40)
    cols, weights, _, lens = _ell_panels(rng, n_p, R, ks)
    v = (-66.0 + 20.0 * rng.random(n_p)).astype(np.float32)
    refrac = rng.integers(0, 3, n_p).astype(np.float32)
    i_tot = (30.0 * rng.random(n_p)).astype(np.float32)
    spikes = np.asarray(jref.lif_step_ref(jnp.asarray(v), jnp.asarray(refrac),
                                              jnp.asarray(i_tot), **params)[2])
    assert 0 < spikes.sum() < n_p
    nan_rows = (3, 90)
    _nan_case(rng, spikes, cols[0], weights[0], lens[0], nan_rows)
    got = ops.fused_step(*(torch.from_numpy(x) for x in (v, refrac, i_tot)),
                         [torch.from_numpy(c) for c in cols],
                         [torch.from_numpy(w) for w in weights],
                         [torch.from_numpy(x) for x in lens], params=params)
    want = jref.fused_step_ref(jnp.asarray(v), jnp.asarray(refrac), jnp.asarray(i_tot),
                                   [jnp.asarray(c) for c in cols],
                                   [jnp.asarray(w) for w in weights], params=params)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(got[3], want[3]):
        np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(np.asarray(b)))
    assert list(np.flatnonzero(np.isnan(got[3][0].numpy()))) == list(nan_rows)
    assert not np.isnan(got[3][1].numpy()).any()


def test_a_nan_weight_is_recorded_as_the_row_dot_reduction():
    """The engines' choice from the data: the bucket holding a NaN weight
    takes ``row_dot`` (``describe()["reduce"]``), the others ``active``;
    plastic nets take ``row_dot`` everywhere."""
    d = to_dcsr(microcircuit(scale=0.01, seed=0), k=1)
    clean = Session(d, SimConfig(align_k=32), device="cpu").describe()["reduce"]
    assert clean == ("active",) * len(clean)
    d.parts[0].edge_state[5, 0] = np.nan
    ses = Session(d, SimConfig(align_k=32), device="cpu")
    has_nan = tuple("row_dot" if bool(torch.isnan(w).any()) else "active"
                    for w in ses.simulator.dev.weights0)
    assert "row_dot" in has_nan and ses.describe()["reduce"] == has_nan
    plastic = Session(to_dcsr(balanced_ei(n=200, stdp=True, seed=0), k=1), device="cpu")
    assert set(plastic.describe()["reduce"]) == {"row_dot"}


@pytest.mark.parametrize("k,cfg,names", [
    (1, dict(fused=True, gather="dense"), ("fused_step",)),
    (1, dict(fused=False), ("spike_gather",)),
    (4, dict(fused=True, gather="dense", overlap="off"), ("fused_post_exchange",)),
    (4, dict(fused=True, gather="event"), ("event_post_exchange",)),
])
def test_a_state_with_other_weights_takes_its_own_reduction(monkeypatch, k, cfg, names):
    """A non-plastic net's gathers over a state's weights take the upload's
    choice while the state holds the uploaded panels, and a choice made from
    the state's own weights when it holds others: a NaN weight there takes
    ``row_dot``, and the state the run returns holds no ``_reduce``."""
    net = microcircuit(scale=0.01, seed=0)
    if k == 1:
        ses = Session(to_dcsr(net, k=1), SimConfig(**cfg), device="cpu")
    else:
        d = to_dcsr(net, assignment=block_partition(net.n, k), uniform=True)
        ses = Session(d, SimConfig(**cfg), engine="spmd", devices=["cpu"] * k)
    sim = ses.simulator
    devs = [sim.dev] if k == 1 else sim.devs
    state = sim.init_state()
    seen = _record_gathers(monkeypatch, names)
    sim.run(state, 3)
    assert seen and all(r in (dev.reduce, dev.reduce[:1], dev.reduce[1:])
                        for _, _, r in seen for dev in devs[:1])
    states = [state] if k == 1 else state
    for st in states:
        w = [x.clone() for x in st["weights"]]
        w[1][2, 0] = float("nan")
        st["weights"] = tuple(w)
    seen.clear()
    out, _ = sim.run(state, 3)
    want = panel_reduce(states[0]["weights"])
    assert want == ("active", "row_dot")
    if names == ("spike_gather",):
        assert [r for _, _, r in seen] == [want[:1], want[1:]] * 3
    else:
        assert {r for _, _, r in seen} == {want}
    assert all("_reduce" not in st for st in ([out] if k == 1 else out))
