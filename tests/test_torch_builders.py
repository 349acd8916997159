"""The port's network builders, dCSR partitioning and ELL packing give
byte-identical arrays to the reference's for the same seed."""
import numpy as np
import pytest

from repro.core.ell import build_delay_ell as j_build_delay_ell
from repro.snn import network as jnet
from repro_torch import convert
from repro_torch.core.ell import build_delay_ell
from repro_torch.snn import network as tnet

_PART_ARRAYS = (
    "row_ptr", "col_idx", "vtx_model", "vtx_state", "edge_model",
    "edge_state", "coords", "global_ids",
)

BUILDERS = {
    "microcircuit": dict(scale=0.01),
    "balanced_ei": dict(n=500, stdp=False),
    "balanced_ei_stdp": dict(n=300, stdp=True),
    "spatial_random": dict(n=400),
    "mixed_population": dict(n=300),
}


def _build(mod, name, kw):
    fn = getattr(mod, name.replace("_stdp", ""))
    return fn(**kw)


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("name", sorted(BUILDERS))
@pytest.mark.parametrize("k", [1, 4])
def test_to_dcsr_byte_identical(name, k):
    jd = jnet.to_dcsr(_build(jnet, name, BUILDERS[name]), k=k)
    td = tnet.to_dcsr(_build(tnet, name, BUILDERS[name]), k=k)
    _assert_same_array(jd.dist, td.dist, "dist")
    assert jd.meta == td.meta
    assert jd.registry.to_entries() == td.registry.to_entries()
    for jp, tp in zip(jd.parts, td.parts, strict=True):
        assert jp.row_start == tp.row_start
        for key in _PART_ARRAYS:
            _assert_same_array(getattr(jp, key), getattr(tp, key), key)


@pytest.mark.parametrize("name,k,uniform", [
    ("microcircuit", 4, True),  # edges already in merged order: the sort is skipped
    ("balanced_ei_stdp", 3, False),
    ("spatial_random", 2, False),
])
def test_merge_and_repartition_byte_identical(name, k, uniform):
    from repro.core import block_partition as j_block, merge_to_single as j_merge
    from repro.core import repartition as j_repartition
    from repro_torch.core import block_partition, merge_to_single, repartition

    n = _build(jnet, name, BUILDERS[name]).n
    jd = jnet.to_dcsr(_build(jnet, name, BUILDERS[name]), assignment=j_block(n, k),
                      uniform=uniform)
    td = tnet.to_dcsr(_build(tnet, name, BUILDERS[name]), assignment=block_partition(n, k),
                      uniform=uniform)
    assign = (np.arange(jd.n) * 7) % 3  # a relabelling repartition: the sort runs
    for jm, tm in ((j_merge(jd), merge_to_single(td)),
                   (j_repartition(jd, assign), repartition(td, assign))):
        _assert_same_array(jm.dist, tm.dist, "dist")
        for jp, tp in zip(jm.parts, tm.parts, strict=True):
            for key in _PART_ARRAYS:
                _assert_same_array(getattr(jp, key), getattr(tp, key), key)


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("align_k", [32, 128])
def test_build_delay_ell_byte_identical(k, align_k):
    jd = jnet.to_dcsr(jnet.microcircuit(scale=0.01), k=k)
    td = tnet.to_dcsr(tnet.microcircuit(scale=0.01), k=k)
    for jp, tp in zip(jd.parts, td.parts):
        je = j_build_delay_ell(jp, jd.n, align_k=align_k)
        te = build_delay_ell(tp, td.n, align_k=align_k)
        assert (je.n_rows, je.n_global, je.nnz) == (te.n_rows, te.n_global, te.nnz)
        assert len(je.buckets) == len(te.buckets) == 2  # d = 8 and d = 15
        for jb, tb in zip(je.buckets, te.buckets):
            assert (jb.delay, jb.identity_rows) == (tb.delay, tb.identity_rows)
            for key in ("cols", "weights", "valid", "edge_index", "row_map"):
                _assert_same_array(getattr(jb, key), getattr(tb, key), key)
        # the padding invariant the kernels rely on: col 0, weight 0
        for tb in te.buckets:
            assert not tb.cols[~tb.valid].any()
            assert not tb.weights[~tb.valid].any()


def test_network_from_arrays_round_trips_the_reference_net():
    jd = jnet.to_dcsr(jnet.microcircuit(scale=0.01), k=4)
    reg = jd.registry
    td = convert.network_from_arrays(
        parts=[
            dict(row_start=p.row_start, **{k: getattr(p, k) for k in _PART_ARRAYS})
            for p in jd.parts
        ],
        registry_entries=reg.to_entries(),
        var_names={s.name: s.state_vars for s in (*reg.vertex_models(), *reg.edge_models())},
        meta=jd.meta,
    )
    assert (td.n, td.m, td.k) == (jd.n, jd.m, jd.k)
    assert td.registry.to_entries() == reg.to_entries()
    assert td.registry.spec("lif").state_vars == reg.spec("lif").state_vars
    for jp, tp in zip(jd.parts, td.parts):
        for key in _PART_ARRAYS:
            _assert_same_array(getattr(jp, key), getattr(tp, key), key)
        assert not np.shares_memory(jp.vtx_state, tp.vtx_state)


def test_to_dcsr_rejects_other_inputs():
    from repro.builder.rules import microcircuit_rules as jmicrocircuit_rules
    from repro_torch.builder import microcircuit_rules

    # a RuleSpec of the port builds procedurally since its slice; one of the
    # JAX package is another type, which the port does not take
    d = tnet.to_dcsr(microcircuit_rules(scale=0.01), k=2, device="cpu")
    assert d.k == 2 and d.n == microcircuit_rules(scale=0.01).n and d.m > 0
    with pytest.raises(TypeError, match="NetworkDef or RuleSpec"):
        tnet.to_dcsr(jmicrocircuit_rules(scale=0.01))
    with pytest.raises(TypeError, match="NetworkDef"):
        tnet.to_dcsr(object())


@pytest.mark.parametrize("n,k", [(97, 1), (97, 3), (2**32, 1)])
def test_packed_edge_sort_equals_lexsort_and_the_reference(n, k):
    """``from_edges`` sorts edges by (target, source) with one stable sort of
    the packed key ``dst * n + src`` (the lexsort where ``n * n`` would pass
    int64): on shuffled edges with multapses the permutation is the
    lexsort's, and the built network is the reference's byte for byte."""
    from repro.core import from_edges as j_from_edges
    from repro_torch.core import dcsr as tdcsr

    rng = np.random.default_rng(n % 1000 + k)
    m = 4000
    lo = n - 97  # the ids of the last 97 vertices: a key past int64 for n = 2^32
    src = rng.integers(0, 97, m) + lo
    dst = rng.integers(0, 97, m) + lo
    src[:500], dst[:500] = src[500:1000], dst[500:1000]  # multapses
    perm = rng.permutation(m)
    src, dst = src[perm], dst[perm]
    np.testing.assert_array_equal(tdcsr.edge_order(src, dst, n), np.lexsort((src, dst)))
    if n > 10**6:
        return  # the network itself would hold n vertices
    state = rng.normal(size=(m, 2)).astype(np.float32)
    state[:, 1] = rng.integers(1, 16, m)
    jd = j_from_edges(n, src, dst, state, k=k)
    td = tdcsr.from_edges(n, src, dst, state, k=k)
    _assert_same_array(jd.dist, td.dist, "dist")
    for jp, tp in zip(jd.parts, td.parts, strict=True):
        for key in _PART_ARRAYS:
            _assert_same_array(getattr(jp, key), getattr(tp, key), key)
