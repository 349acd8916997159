"""The port's streaming dCSR ingest (``repro_torch.builder.ingest``) and
lazy per-partition ``load_binary`` on the CPU: the reference's
``tests/test_ingest.py`` over the port, and a snapshot the reference wrote,
streamed by both packages, array for array."""
import os

import numpy as np
import pytest

from repro.builder import load_binary_streamed as j_load_binary_streamed
from repro.builder import load_merged_streamed as j_load_merged_streamed
from repro.builder import build_network as j_build_network
from repro.builder import spatial_random_rules as j_spatial_random_rules
from repro.io import save_binary as j_save_binary
from repro_torch.builder import (
    balanced_ei_rules,
    build_network,
    load_binary_streamed,
    load_merged_streamed,
    open_snapshot,
    spatial_random_rules,
)
from repro_torch.builder.ingest import make_streaming_loader
from repro_torch.core.dcsr import merge_to_single
from repro_torch.io import load_binary, load_latest_valid, save_binary
from repro_torch.snn import RasterMonitor, Session, SimConfig

FIELDS = ("global_ids", "row_ptr", "col_idx", "vtx_model", "edge_model", "vtx_state",
          "edge_state", "coords")


def _nets_equal(a, b):
    assert a.n == b.n and a.m == b.m and a.k == b.k
    np.testing.assert_array_equal(a.dist, b.dist)
    assert a.meta == b.meta
    assert a.registry.to_entries() == b.registry.to_entries()
    for pa, pb in zip(a.parts, b.parts):
        assert pa.row_start == pb.row_start
        for f in FIELDS:
            x, y = getattr(pa, f), getattr(pb, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _sim_equal(a, b):
    assert set(a) == set(b)
    for p in a:
        assert set(a[p]) == set(b[p])
        for key in a[p]:
            assert a[p][key].dtype == b[p][key].dtype, key
            np.testing.assert_array_equal(a[p][key], b[p][key], err_msg=key)


def _runtime(net, seed=0):
    rng = np.random.default_rng(seed)
    sim = {}
    for p in range(net.k):
        n_p = int(net.dist[p + 1] - net.dist[p])
        sim[p] = {
            "ring": rng.random((4, n_p)).astype(np.float32),
            "hist": (rng.random((6, n_p)) < 0.2).astype(np.uint8),
        }
    return sim


def _snapshot_k3(tmp_path, with_sim=True):
    net = build_network(spatial_random_rules(n=140, avg_degree=8, seed=3), k=3, device="cpu")
    sim = _runtime(net) if with_sim else None
    d = str(tmp_path / "snap")
    save_binary(net, d, sim_state=sim, t_now=42)
    return net, sim, d


# -- streamed vs eager bit-identity ----------------------------------------

@pytest.mark.parametrize("chunk_rows", [1, 7, 10_000])
def test_streamed_equals_eager(tmp_path, chunk_rows):
    net, sim, d = _snapshot_k3(tmp_path)
    eager, esim, et = load_binary(d)
    got, gsim, gt = load_binary_streamed(d, chunk_rows=chunk_rows)
    assert gt == et == 42
    _nets_equal(got, eager)
    _sim_equal(gsim, esim)


def test_merged_streamed_equals_merge_to_single(tmp_path):
    net, sim, d = _snapshot_k3(tmp_path)
    eager, esim, _ = load_binary(d)
    oracle = merge_to_single(eager)
    got, gsim, gt = load_merged_streamed(d, chunk_rows=11)
    assert gt == 42 and got.k == 1
    _nets_equal(got, oracle)
    # runtime arrays merge by concatenation along the row axis
    want = {0: {key: np.concatenate([esim[p][key] for p in range(3)], axis=-1)
                for key in esim[0]}}
    _sim_equal(gsim, want)


def test_reader_iter_rows_accounting(tmp_path):
    net, _, d = _snapshot_k3(tmp_path)
    with open_snapshot(d) as r:
        assert (r.k, r.n, r.m) == (net.k, net.n, net.m)
        for p in range(r.k):
            n_p = int(r.dist[p + 1] - r.dist[p])
            rows = edges = 0
            for ch in r.iter_rows(p, chunk_rows=13):
                assert ch.part_id == p and ch.row0 == rows
                assert ch.rows <= 13
                rows += ch.rows
                edges += len(ch.col_idx)
                # chunk-local row_ptr is self-consistent
                assert ch.row_ptr[0] == 0
                assert ch.row_ptr[-1] == len(ch.col_idx)
            assert rows == n_p
            assert edges == len(net.parts[p].col_idx)
            part, _ = r.assemble_part(p, chunk_rows=13)
            np.testing.assert_array_equal(part.col_idx, net.parts[p].col_idx)


def test_streamed_crc_rejects_corruption(tmp_path):
    _, _, d = _snapshot_k3(tmp_path)
    fn = os.path.join(d, "part1.npz")
    with open(fn, "rb") as f:
        raw = bytearray(f.read())
    raw[len(raw) // 2] ^= 0xFF
    with open(fn, "wb") as f:
        f.write(bytes(raw))
    with pytest.raises(IOError, match="corrupt"):
        load_binary_streamed(d)


def test_streaming_loader_walks_past_corrupt_step(tmp_path):
    """load_latest_valid(loader=streaming) shares the .old/corrupt walk:
    a corrupted newest step falls back to the previous one."""
    net = build_network(spatial_random_rules(n=80, avg_degree=5, seed=1), k=2, device="cpu")
    for step in (10, 20):
        save_binary(net, str(tmp_path / f"step_{step:08d}"), t_now=step)
    fn = str(tmp_path / "step_00000020" / "part0.npz")
    with open(fn, "r+b") as f:
        f.truncate(os.path.getsize(fn) // 2)
    got, _, t = load_latest_valid(str(tmp_path), loader=make_streaming_loader(chunk_rows=9))
    assert t == 10
    _nets_equal(got, net)


# -- lazy per-partition load_binary ----------------------------------------

def test_lazy_parts_never_touch_other_shards(tmp_path):
    """load_binary(parts=[1]) must not open or CRC the other shards:
    overwrite them with garbage and the load still succeeds bit-exactly."""
    net, sim, d = _snapshot_k3(tmp_path)
    for p in (0, 2):
        with open(os.path.join(d, f"part{p}.npz"), "wb") as f:
            f.write(b"garbage!")
    got, gsim, t = load_binary(d, parts=[1])
    assert t == 42
    assert got.loaded_parts == frozenset({1})
    np.testing.assert_array_equal(got.parts[1].col_idx, net.parts[1].col_idx)
    np.testing.assert_array_equal(got.parts[1].edge_state, net.parts[1].edge_state)
    _sim_equal({1: gsim[1]}, {1: sim[1]})
    # unrequested slots are zero-edge stubs with the right row count
    for p in (0, 2):
        stub = got.parts[p]
        assert len(stub.col_idx) == 0 and len(stub.global_ids) == 0
        assert len(stub.row_ptr) == int(net.dist[p + 1] - net.dist[p]) + 1
    with pytest.raises(ValueError, match="out of range"):
        load_binary(d, parts=[5])


# -- Session.restore(streaming=True) ---------------------------------------

def test_session_restore_streaming_bit_identical(tmp_path):
    """Streamed restore continues bit-identically to eager restore,
    including STDP weights after further simulation."""
    spec = balanced_ei_rules(n=120, seed=9)
    cfg = SimConfig(align_k=8)
    ses = Session(spec, cfg, device="cpu")
    ses.run(40, chunk_size=20)
    snap = str(tmp_path / "mid")
    ses.save(snap)

    outs = {}
    for name, kw in {
        "eager": dict(),
        "stream": dict(streaming=True, chunk_rows=11),
        "stream_k1": dict(k=1, streaming=True),
    }.items():
        s2 = Session.restore(snap, cfg=cfg, device="cpu", **kw)
        assert s2.t == 40
        assert set(s2.restore_seconds) == {"load", "reshard", "build"}
        ras = RasterMonitor()
        res = s2.run(30, monitors=[ras], chunk_size=15)
        s2.save(str(tmp_path / name))
        net, _, _ = load_binary(str(tmp_path / name))
        outs[name] = (
            ras.raster, res.spike_count,
            np.concatenate([p.edge_state[:, 0] for p in net.parts]),
        )
    for name in ("stream", "stream_k1"):
        for a, b in zip(outs[name], outs["eager"]):
            np.testing.assert_array_equal(a, b, err_msg=name)


# -- across packages -------------------------------------------------------

@pytest.mark.parametrize("merged", [False, True], ids=["native_k", "merged_k1"])
def test_streams_a_reference_snapshot_as_the_reference_does(tmp_path, merged):
    """A snapshot ``repro.io`` wrote, streamed by the port and by the
    reference's own streaming loaders: equal arrays, dtypes, dist, meta,
    registry and runtime."""
    net = j_build_network(j_spatial_random_rules(n=150, avg_degree=7, seed=5), k=3)
    d = str(tmp_path / "ref_snap")
    j_save_binary(net, d, sim_state=_runtime(net, seed=4), t_now=17)
    port_load = load_merged_streamed if merged else load_binary_streamed
    ref_load = j_load_merged_streamed if merged else j_load_binary_streamed
    got, gsim, gt = port_load(d, chunk_rows=9)
    want, wsim, wt = ref_load(d, chunk_rows=9)
    assert gt == wt == 17
    _nets_equal(got, want)
    _sim_equal(gsim, wsim)
