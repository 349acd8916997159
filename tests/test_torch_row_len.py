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
from repro_torch.builder import balanced_ei_rules, microcircuit_rules
from repro_torch.core import block_partition
from repro_torch.kernels import event_step as tev
from repro_torch.kernels import ops
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


def _record_gathers(monkeypatch):
    """Wrap the ops' registry lookup: every spike_gather and
    event_post_exchange call's ``row_len`` argument, in call order."""
    seen = []
    real = ops.lookup

    def lookup(name, backend):
        fn = real(name, backend)
        if name not in ("spike_gather", "event_post_exchange"):
            return fn

        def record(*args):
            seen.append((name, args[-1]))
            return fn(*args)

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
    kinds = {name for name, _ in seen}
    assert kinds == {"spike_gather" if cfg.get("fused") is False else "event_post_exchange"}
    lengths = [id(rl) for dev in devs for rl in dev.row_len]
    for name, row_len in seen:
        if name == "spike_gather":
            assert id(row_len) in lengths
        else:
            assert any(len(row_len) == len(dev.row_len)
                       and all(a is b for a, b in zip(row_len, dev.row_len)) for dev in devs)


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
