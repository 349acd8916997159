"""The port's paper text format (``repro_torch.io.dcsr_text``), in-flight
events (``repro_torch.core.events``) and interop adapters
(``repro_torch.io.interop``) against the reference's, on the CPU: every
file ``save_text`` writes is byte-identical between the packages, each
package reads the other's files into equal arrays, and the adapters give
equal dicts, nets and ParMETIS triples."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import events as jevents
from repro.core import rcb_partition as j_rcb_partition
from repro.io import dcsr_text as jtext
from repro.io import interop as jinterop
from repro.snn import Session as JSession
from repro.snn import SimConfig as JSimConfig
from repro.snn import network as jnet
from repro_torch.core import events as tevents
from repro_torch.core import rcb_partition
from repro_torch.io import from_adjacency_dict, load_text, save_text, to_adjacency_dict, to_parmetis
from repro_torch.snn import Session, SimConfig
from repro_torch.snn import network as tnet

FIELDS = ("global_ids", "row_ptr", "col_idx", "vtx_model", "edge_model", "vtx_state",
          "edge_state", "coords")


def _pair(kind):
    """The same dCSR net built by each package: ``spatial`` (STDP edges,
    three RCB partitions) or ``ei`` (Brunel, two block partitions)."""
    out = []
    for mod, rcb in ((jnet, j_rcb_partition), (tnet, rcb_partition)):
        if kind == "spatial":
            net = mod.spatial_random(90, avg_degree=7, seed=2, stdp=True)
            out.append(mod.to_dcsr(net, assignment=rcb(net.coords, 3)))
        else:
            out.append(mod.to_dcsr(mod.balanced_ei(n=100, seed=4), k=2))
    return out


def _nets_equal(a, b):
    assert (a.n, a.m, a.k) == (b.n, b.m, b.k)
    np.testing.assert_array_equal(a.dist, b.dist)
    assert a.meta == b.meta
    assert a.registry.to_entries() == b.registry.to_entries()
    for pa, pb in zip(a.parts, b.parts):
        for f in FIELDS:
            x, y = getattr(pa, f), getattr(pb, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _events_equal(a, b):
    assert a.dtype == b.dtype and len(a) == len(b)
    for name in a.dtype.names:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def _events(mod, net, t_now=25, seed=0):
    D = max(net.max_delay(), 1)
    hist = (np.random.default_rng(seed).random((D, net.n)) < 0.15).astype(np.uint8)
    return [mod.inflight_events(p, hist, t_now, D) for p in net.parts]


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("kind", ["spatial", "ei"])
def test_save_text_is_byte_identical_both_ways(tmp_path, kind):
    """The reference and the port write the same bytes for the same net,
    events and step; each package reads the other's files and writes them
    back byte for byte."""
    jd, td = _pair(kind)
    jev, tev = _events(jevents, jd), _events(tevents, td)
    for a, b in zip(jev, tev):
        _events_equal(a, b)
    j_sizes = jtext.save_text(jd, str(tmp_path / "j"), "net", events_by_part=jev, t_now=25)
    t_sizes = save_text(td, str(tmp_path / "t"), "net", events_by_part=tev, t_now=25)
    assert j_sizes == t_sizes
    ref_files = _files(tmp_path / "j")
    assert len(ref_files) == 2 + 5 * jd.k
    assert _files(tmp_path / "t") == ref_files

    # the port reads the reference's files and the reference the port's
    t_net, t_evs, t_t = load_text(str(tmp_path / "j"), "net")
    j_net, j_evs, j_t = jtext.load_text(str(tmp_path / "t"), "net")
    assert t_t == j_t == 25
    _nets_equal(t_net, j_net)
    for a, b in zip(t_evs, j_evs):
        _events_equal(a, b)
    save_text(t_net, str(tmp_path / "tt"), "net", events_by_part=t_evs, t_now=t_t)
    jtext.save_text(j_net, str(tmp_path / "jj"), "net", events_by_part=j_evs, t_now=j_t)
    assert _files(tmp_path / "tt") == ref_files
    assert _files(tmp_path / "jj") == ref_files


def test_text_roundtrip_in_the_port(tmp_path):
    """The port alone: save_text then load_text gives the net (to the
    text format's 9 significant digits), the events, the step, and each
    partition's files parse standalone."""
    _, td = _pair("spatial")
    evs = _events(tevents, td, t_now=17)
    save_text(td, str(tmp_path), "net", events_by_part=evs, t_now=17)
    got, gevs, t = load_text(str(tmp_path), "net")
    assert t == 17 and got.k == 3
    for pa, pb in zip(got.parts, td.parts):
        for f in ("global_ids", "row_ptr", "col_idx", "vtx_model", "edge_model"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
        np.testing.assert_array_equal(pa.edge_state, pb.edge_state)
    D = max(td.max_delay(), 1)
    for a, b, p in zip(evs, gevs, got.parts):
        _events_equal(a, b)
        np.testing.assert_array_equal(
            tevents.ring_from_events(a, p.row_start, p.n, D + 1, 17),
            tevents.ring_from_events(b, p.row_start, p.n, D + 1, 17),
        )


def _reference_noise(net):
    sigma, n = float(net.meta["noise_sigma"]), net.n
    key = jax.random.PRNGKey(SimConfig().seed)
    draw = jax.jit(
        lambda t: sigma * jax.random.normal(jax.random.fold_in(key, t), (n,), jnp.float32)
    )
    return lambda t: np.asarray(draw(t))


def test_inflight_events_of_the_port_carry_equal_the_reference(tmp_path):
    """Both packages run the same Brunel net 40 steps (the reference's
    noise in both); the in-flight events each derives from its own carry's
    spike history, with its own ``inflight_events``, are equal, and so are
    the ``.event`` files."""
    jd, td = (mod.to_dcsr(mod.balanced_ei(n=200, seed=3), k=1) for mod in (jnet, tnet))
    jses = JSession(jd, JSimConfig(align_k=8))
    jses.run(40, chunk_size=20)
    ses = Session(td, SimConfig(align_k=8), device="cpu", _noise_fn=_reference_noise(td))
    ses.run(40, chunk_size=20)
    j_hist = np.asarray(jses.state["hist"])
    t_hist = ses.state["hist"].numpy()
    assert t_hist.sum() > 0
    np.testing.assert_array_equal(t_hist, j_hist)
    D = max(td.max_delay(), 1)
    t_now = ses.t - 1  # the carry's history holds steps up to t - 1
    tev = [tevents.inflight_events(p, t_hist, t_now, D) for p in td.parts]
    jev = [jevents.inflight_events(p, j_hist, t_now, D) for p in jd.parts]
    assert len(tev[0]) > 0
    _events_equal(tev[0], jev[0])
    save_text(td, str(tmp_path / "t"), "net", events_by_part=tev, t_now=t_now)
    jtext.save_text(jd, str(tmp_path / "j"), "net", events_by_part=jev, t_now=t_now)
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    jses.close()
    ses.close()


# -- interop -------------------------------------------------------------------

def test_adjacency_dict_and_back_equal_the_reference():
    jd, td = _pair("spatial")
    adj = to_adjacency_dict(td)
    assert adj == jinterop.to_adjacency_dict(jd)
    _nets_equal(from_adjacency_dict(adj, k=2, registry=td.registry),
                jinterop.from_adjacency_dict(adj, k=2, registry=jd.registry))


def test_adjacency_zero_multiplicity_means_no_edge():
    """An explicit multiplicity=0 means no edge; an absent one means one
    edge, as in the reference."""
    adj = {
        0: {1: dict(weight=2.0, delay=1.0, multiplicity=0), 2: dict(weight=1.5, delay=2.0)},
        1: {2: dict(weight=0.5, delay=1.0, multiplicity=2)},
        2: {},
    }
    d = from_adjacency_dict(adj)
    assert d.n == 3 and d.m == 3
    back = to_adjacency_dict(d)
    assert back == jinterop.to_adjacency_dict(jinterop.from_adjacency_dict(adj))
    assert 1 not in back[0]
    assert back[0][2]["multiplicity"] == 1 and back[1][2]["multiplicity"] == 2


@pytest.mark.parametrize("kind", ["spatial", "ei"])
def test_parmetis_triple_equals_the_reference(kind):
    jd, td = _pair(kind)
    vtxdist, xadjs, adjncys = to_parmetis(td)
    j_vtxdist, j_xadjs, j_adjncys = jinterop.to_parmetis(jd)
    np.testing.assert_array_equal(vtxdist, j_vtxdist)
    assert len(xadjs) == len(j_xadjs) == td.k
    for a, b, c, d in zip(xadjs, j_xadjs, adjncys, j_adjncys):
        assert a.dtype == b.dtype and c.dtype == d.dtype
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, d)
