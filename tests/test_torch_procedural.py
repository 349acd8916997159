"""The port's procedural construction (``repro_torch.builder``) against the
JAX package's (``repro.builder``), bit for bit, on the CPU.

The keystream: the port's numpy ``crng`` and the plain torch version behind
``ops.builder_keystream`` against ``repro.builder.crng.word_matrix``, the
jnp oracle ``keystream_jnp`` and ``keystream_pallas`` in interpret mode.
The builds: ``build_network`` of the three preset specs over k, ``uniform``,
chunk sizes and both sampling paths (``path="ref"``, the numpy oracle, and
``path="device", device="cpu"``, the plain torch keystream) against the
reference's ``build_network(path="ref")``.  The sessions: ``Session(spec,
k=...)`` against the reference's, with the reference's noise injected.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.builder import crng as jcrng
from repro.builder import procedural as jproc
from repro.builder import rules as jrules
from repro.kernels.keystream import keystream_jnp, keystream_pallas
from repro.snn import Session as JSession
from repro.snn import SimConfig as JSimConfig
from repro.snn import to_dcsr as jto_dcsr
from repro.snn.monitors import RasterMonitor as JRasterMonitor
from repro_torch.builder import crng, procedural, rules
from repro_torch.core import block_partition, merge_to_single
from repro_torch.kernels import keystream as ks_mod
from repro_torch.kernels import ops
from repro_torch.snn import RasterMonitor, Session, SimConfig, to_dcsr

PART_ARRAYS = ("global_ids", "row_ptr", "col_idx", "vtx_model", "edge_model",
               "vtx_state", "edge_state", "coords")
SPECS = {  # (preset, arguments); n=150 at k=4 leaves unequal blocks: the relabel is live
    "balanced_ei": ("balanced_ei_rules", dict(n=150, seed=6)),
    "microcircuit": ("microcircuit_rules", dict(scale=0.01, seed=5)),
    "spatial_random": ("spatial_random_rules", dict(n=150, avg_degree=8, seed=7)),
}
SEED = 42  # SimConfig's default noise seed, in both packages


def _specs(name):
    fn, kw = SPECS[name]
    return getattr(rules, fn)(**kw), getattr(jrules, fn)(**kw)


@functools.lru_cache(maxsize=None)
def _reference_build(name, k, uniform):
    return jproc.build_network(_specs(name)[1], k=k, uniform=uniform, path="ref")


def _assert_same_net(got, want):
    assert (got.n, got.m, got.k) == (want.n, want.m, want.k)
    np.testing.assert_array_equal(got.dist, want.dist)
    for pg, pw in zip(got.parts, want.parts):
        assert (pg.part_id, pg.row_start) == (pw.part_id, pw.row_start)
        for key in PART_ARRAYS:
            a, b = getattr(pg, key), getattr(pw, key)
            assert a.dtype == b.dtype, key
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.meta == want.meta
    assert got.registry.to_entries() == want.registry.to_entries()


# -- the keystream ------------------------------------------------------------

def test_crng_matches_reference(rng):
    words = rng.integers(0, 2**32, (300, jcrng.NORMAL_WORDS), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(1, 2**32, 300, dtype=np.uint64).astype(np.uint32)
    for name, args in (
        ("threefry2x32", (7, 2**31 + 5, words[:, 0], words[:, 1])),
        ("word_matrix", (11, 19, rng.integers(0, 2**31, 50), 3, 17)),
        ("mulhi32", (words[:, 0], b)),
        ("uint_below", (words[:, 0], 77169)),
        ("u24", (words,)),
        ("uniform01", (words,)),
        ("normal_fixed", (words,)),
        ("standard_normal", (words,)),
        ("rule_stream", (54, crng.DELAY_OFF)),
    ):
        got, want = getattr(crng, name)(*args), getattr(jcrng, name)(*args)
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got, want))):
            assert np.asarray(g).dtype == np.asarray(w).dtype, name
            np.testing.assert_array_equal(g, w, err_msg=name)
    for const in ("STREAM_V", "STREAM_BIAS", "STREAM_COORD", "STREAM_RULE0", "RULE_STRIDE",
                  "DEGREE_OFF", "SRC_OFF", "ACCEPT_OFF", "WEIGHT_OFF", "DELAY_OFF",
                  "NORMAL_WORDS", "NORMAL_SCALE", "U24_SCALE"):
        assert getattr(crng, const) == getattr(jcrng, const), const


_ROWS = {
    "repeats and large ids": np.array([0, 1, 5, 2**20, 7, 7, 2**31 - 1, 5, 0], np.int64),
    "gathered": np.random.default_rng(3).integers(0, 2**31, 257),
    "one row": np.array([2**31 - 1], np.int64),
}


@pytest.mark.parametrize("j0,n_words", [(0, 8), (0, 9), (3, 9), (3, 8), (1, 1), (5, 2), (0, 131)])
@pytest.mark.parametrize("rows_name", list(_ROWS))
def test_plain_keystream_matches_reference(rows_name, j0, n_words):
    rows = _ROWS[rows_name]
    seed, stream = 123, crng.rule_stream(4, crng.WEIGHT_OFF)
    got = ks_mod.as_uint32(ops.builder_keystream(seed, stream, torch.from_numpy(rows), j0,
                                                 n_words))
    oracle = jcrng.word_matrix(seed, stream, rows, j0, n_words)
    assert got.dtype == np.uint32 and got.shape == (len(rows), n_words)
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(crng.word_matrix(seed, stream, rows, j0, n_words), oracle)
    jrows = rows.astype(np.int32)
    np.testing.assert_array_equal(
        got, np.asarray(keystream_jnp(np.uint32(seed), np.uint32(stream), jnp.asarray(jrows),
                                      np.uint32(j0), n_words)))
    np.testing.assert_array_equal(
        got, np.asarray(keystream_pallas(seed, stream, jrows, j0, n_words, interpret=True)))


@pytest.mark.parametrize("n_rows,n_words", [(0, 5), (3, 0), (0, 0)])
def test_empty_keystream_calls(n_rows, n_words):
    rows = np.arange(n_rows, dtype=np.int64)
    before = ks_mod.COUNTER.launches
    got = ops.builder_keystream(9, 2, torch.from_numpy(rows), 1, n_words)
    assert got.shape == (n_rows, n_words) and got.dtype == torch.int32
    assert ks_mod.as_uint32(got).shape == jcrng.word_matrix(9, 2, rows, 1, n_words).shape
    np.testing.assert_array_equal(
        ks_mod.as_uint32(got),
        np.asarray(keystream_jnp(np.uint32(9), np.uint32(2), jnp.asarray(rows.astype(np.int32)),
                                 np.uint32(1), n_words)))
    assert ks_mod.COUNTER.launches == before  # the plain version launches nothing
    words = procedural._Words(9, "device", torch.device("cpu"),
                              procedural.BuildReport("device", "cpu"))
    assert words(2, rows, 1, n_words).shape == (n_rows, n_words)
    assert words.report.keystream_calls == 0


@pytest.mark.parametrize("args,err,match", [
    ((1, 2, torch.tensor([-1, 3]), 0, 4), ValueError, "rows"),
    ((1, 2, torch.tensor([2**32]), 0, 4), ValueError, "rows"),
    ((2**32, 2, torch.tensor([1]), 0, 4), ValueError, "seed"),
    ((1, -1, torch.tensor([1]), 0, 4), ValueError, "stream"),
    ((1, 2, torch.tensor([1]), 2**32 - 2, 4), ValueError, "2\\^32"),
    ((1, 2, torch.tensor([1.0]), 0, 4), TypeError, "rows"),
    ((1, 2, torch.tensor([[1]]), 0, 4), TypeError, "rows"),
])
def test_keystream_operand_checks(args, err, match):
    with pytest.raises(err, match=match):
        ops.builder_keystream(*args)


def test_keystream_kernel_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA tensor"):
        ks_mod.keystream_cuda(1, 2, torch.arange(4), 0, 4)


# -- builds -------------------------------------------------------------------

@pytest.mark.parametrize("path", ["ref", "device"])
@pytest.mark.parametrize("uniform", [False, True])
@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("name", list(SPECS))
def test_build_network_matches_reference(name, k, uniform, path):
    spec, jspec = _specs(name)
    got = procedural.build_network(spec, k=k, uniform=uniform, path=path, device="cpu")
    want = _reference_build(name, k, uniform)
    _assert_same_net(got, want)
    assert got.rule_spec == want.rule_spec
    rep = got.build_report
    assert rep.path == path and rep.keystream_calls > 0 and rep.keystream_words > 0
    assert rep.d2h_bytes == 0 and 0.0 <= rep.keystream_seconds <= rep.seconds


@pytest.mark.parametrize("path", ["ref", "device"])
@pytest.mark.parametrize("chunk_rows", [1, 17, 64, 10_000])
def test_build_chunk_sizes_match_reference(chunk_rows, path):
    spec, _ = _specs("spatial_random")
    got = procedural.build_network(spec, k=4, uniform=True, chunk_rows=chunk_rows,
                                   path=path, device="cpu")
    _assert_same_net(got, _reference_build("spatial_random", 4, True))


@pytest.mark.parametrize("name", list(SPECS))
def test_merged_k4_build_equals_k1(name):
    spec, _ = _specs(name)
    one = procedural.build_network(spec, k=1, path="ref")
    _assert_same_net(merge_to_single(procedural.build_network(spec, k=4, path="ref")), one)


@pytest.mark.parametrize("name", list(SPECS))
def test_network_def_matches_reference(name):
    spec, jspec = _specs(name)
    got = procedural.network_def(spec, path="device", device="cpu")
    want = jproc.network_def(jspec, path="ref")
    assert got.n == want.n and got.meta == want.meta
    assert got.registry.to_entries() == want.registry.to_entries()
    for key in ("src", "dst", "edge_state", "vtx_model", "vtx_state", "coords", "edge_model"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key), err_msg=key)


@pytest.mark.parametrize("assigned", [False, True])
def test_to_dcsr_of_a_rule_spec(assigned):
    spec, jspec = _specs("spatial_random")
    if assigned:  # a custom assignment goes through network_def
        assignment = np.random.default_rng(1).integers(0, 3, spec.n)
        got = to_dcsr(spec, assignment=assignment, uniform=True, path="ref")
        want = jto_dcsr(jspec, assignment=assignment, uniform=True, path="ref")
    else:
        got = to_dcsr(spec, k=2, chunk_rows=33, device="cpu")
        want = jto_dcsr(jspec, k=2, path="ref")
        _assert_same_net(got, procedural.build_network(spec, k=2, path="ref"))
    _assert_same_net(got, want)


def test_spec_round_trips_and_matches_reference():
    for name in SPECS:
        spec, jspec = _specs(name)
        d = rules.spec_to_dict(spec)
        assert d == jrules.spec_to_dict(jspec)
        assert rules.spec_from_dict(d) == spec
        assert rules.rule_streams(spec) == jrules.rule_streams(jspec)
    pops = (rules.Population("a", 10), rules.Population("b", 10))
    for bad in ((rules.ConnectRule("a", "b"),), (rules.ConnectRule("a", "b", fan_in=3, p=0.5),),
                (rules.ConnectRule("a", "zzz", fan_in=2),),
                (rules.ConnectRule("a", "b", kernel=rules.DistanceKernel(0.5, 1.0)),)):
        with pytest.raises(ValueError):
            rules.RuleSpec(pops, bad)


def test_build_path_resolution(monkeypatch):
    assert procedural.resolve_build_path("ref") == ("ref", None)
    assert procedural.resolve_build_path("auto", "cpu") == ("device", torch.device("cpu"))
    assert procedural.resolve_build_path("device", "cpu") == ("device", torch.device("cpu"))
    with pytest.raises(ValueError, match="build path"):
        procedural.resolve_build_path("pallas")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        procedural.resolve_build_path("auto")


def test_entry_points_raise_without_a_card(monkeypatch):
    """No fallback: with no card and no device named, building and running a
    RuleSpec raise; the numpy oracle and device="cpu" still build."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, _ = _specs("balanced_ei")
    for call in (lambda: procedural.build_network(spec), lambda: to_dcsr(spec),
                 lambda: procedural.network_def(spec), lambda: Session(spec),
                 lambda: Session(spec, k=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    want = _reference_build("balanced_ei", 1, False)
    _assert_same_net(procedural.build_network(spec, path="ref"), want)
    _assert_same_net(Session(spec, device="cpu").net, want)


def test_session_rejects_k_for_other_input():
    net = to_dcsr(_specs("spatial_random")[0], k=1, device="cpu")
    with pytest.raises(ValueError, match="RuleSpec"):
        Session(net, SimConfig(align_k=8), k=2, device="cpu")


# -- sessions -------------------------------------------------------------------

STEPS = 100


def _session_spec(pkg):
    """``balanced_ei_rules(n=150, stdp=True)`` with its bias raised from 14.8
    to 16 mV, so that the small net spikes and learns within the run."""
    spec = pkg.balanced_ei_rules(n=150, stdp=True, seed=6)
    pops = tuple(dataclasses.replace(p, bias_mu=16.0) for p in spec.populations)
    return dataclasses.replace(spec, populations=pops)


def _reference_noise(sigma, n):
    key = jax.random.PRNGKey(SEED)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


@functools.lru_cache(maxsize=None)
def _reference_session(k):
    """The reference ``Session(spec, k=k)`` run op by op (the plain
    versions' rounding, exactly): raster, spike counts, weights."""
    ses = JSession(_session_spec(jrules), JSimConfig(align_k=8), k=k)
    ras = JRasterMonitor()
    with jax.disable_jit():
        res = ses.run(STEPS, monitors=[ras], chunk_size=16)
        weights = [np.asarray(w) for w in ses.state["weights"]]
    return ras.raster, np.asarray(res.spike_count), weights, ses.net.n


def _merged(ses, panels):
    """Per-bucket weight panels in the merged labelling: a spmd session's
    partitions' rows stacked, a single session's as they are."""
    if ses.engine_kind != "spmd":
        return [w.numpy() for w in panels(ses.simulator.dev, ses.state)]
    n_p = ses.simulator.stacked.n_p
    per = [panels(dev, c) for dev, c in zip(ses.simulator.devs, ses.state)]
    return [torch.cat([p[i][:n_p] for p in per]).numpy() for i in range(len(per[0]))]


@pytest.mark.parametrize("k,engine", [(1, "auto"), (4, "auto"), (4, "spmd")])
def test_session_of_a_rule_spec_matches_reference(k, engine):
    raster, counts, weights, n = _reference_session(k)
    spec = _session_spec(rules)
    place = dict(devices=["cpu"] * k) if engine == "spmd" else dict(device="cpu")
    ses = Session(spec, SimConfig(align_k=8), k=k, engine=engine,
                  _noise_fn=_reference_noise(float(spec.noise_sigma), n), **place)
    assert ses.engine_kind == ("spmd" if engine == "spmd" else "single")
    if ses.k == k:  # the built net itself (the merged fallback carries no spec)
        assert ses.net.rule_spec == {"spec": rules.spec_to_dict(spec), "uniform": k > 1, "k": k}
    mon = RasterMonitor()
    res = ses.run(STEPS, monitors=[mon], chunk_size=16)
    assert raster.sum() > 0, "no spikes to compare"
    np.testing.assert_array_equal(mon.raster, raster)
    np.testing.assert_array_equal(res.spike_count, counts)
    got = _merged(ses, lambda dev, carry: carry["weights"])
    initial = _merged(ses, lambda dev, carry: dev.weights0)
    for g, w in zip(got, weights):
        np.testing.assert_array_equal(g, w[: g.shape[0]])
    assert any((g != w0).any() for g, w0 in zip(got, initial)), "the net never learned"


def test_session_build_options_give_the_same_net():
    spec = rules.balanced_ei_rules(n=150, stdp=True, seed=6)
    place = dict(k=4, engine="spmd", devices=["cpu"] * 4)
    base = Session(spec, build_path="ref", **place)
    assert base.net.build_report.path == "ref"
    _assert_same_net(base.net, _reference_build("balanced_ei", 4, True))
    for kw in (dict(build_chunk_rows=23), dict(build_path="device")):
        ses = Session(spec, **place, **kw)
        assert ses.net.build_report.device == "cpu"
        _assert_same_net(ses.net, base.net)
    _assert_same_net(base.net, to_dcsr(spec, assignment=block_partition(150, 4), uniform=True,
                                       path="ref"))
